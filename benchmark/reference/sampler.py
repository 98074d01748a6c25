"""The plain reference of the decoding rules (chenxy99/Scanpaths,
``models/sampling.py``): how a step's distribution and its noise give an
action, and how the actions and durations of T steps give a scanpath.

* Action 0 is STOP; actions 1..H*W raster-scan the map row-major, each
  fixating the centre of its cell of the frame.
* STOP cannot be chosen in the first ``min_length`` steps.
* A sampled step takes the action with the largest log-probability plus
  its standard Gumbel noise, and the duration ``exp(normal * sigma2 +
  mu)`` (the reference's quirk: sigma2 scales the normal draw); a greedy
  step takes the most probable action and the median ``exp(mu)``.
* A scanpath is its fixations before the first STOP.

The noise is drawn as the program's sampler draws it from the
benchmark's generator (:func:`noise`), so both sides see the same.
"""

from __future__ import annotations

import torch


def masked_logp(logits, min_length: int):
    """log-softmax of the logits [..., T, A] with STOP (action 0) at -inf
    for the first ``min_length`` steps."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    logp[..., :min_length, 0] = -torch.inf
    return logp


def noise(generator, rollouts: int, probs_shape, mu_shape, device):
    """(Gumbel noise [R, *probs_shape], normal noise [R, *mu_shape]):
    one uniform draw, then one normal draw, from ``generator``."""
    u = torch.rand((rollouts,) + tuple(probs_shape), generator=generator,
                   device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    normal = torch.randn((rollouts,) + tuple(mu_shape), generator=generator,
                         device=device, dtype=torch.float32)
    return gumbel, normal


def scanpaths(actions, durations, cfg):
    """(fixations [..., T, 3] as x, y in pixels and duration, zero past
    the scanpath's end; lengths [...]) of the actions and durations
    [..., T]."""
    mh, mw = cfg["map_height"], cfg["map_width"]
    gx, gy = cfg["width"] / mw, cfg["height"] / mh
    steps = actions.shape[-1]
    is_stop = actions == 0
    idx = torch.arange(steps, device=actions.device)
    first = torch.where(is_stop, idx, steps).amin(dim=-1)
    keep = (idx < first[..., None]).float()
    cell = (actions - 1).clamp_min(0)
    x = (cell % mw).float() * gx + gx / 2
    y = torch.div(cell, mw, rounding_mode="floor").float() * gy + gy / 2
    fix = torch.stack([x, y, durations.float()], dim=-1) * keep[..., None]
    return fix, first


def sample(logits, mu, sigma2, gumbel, normal, cfg):
    """A sampled decode of the reference's own distributions: (actions,
    durations, fixations, lengths), each leading with the noise's [R]."""
    logp = masked_logp(logits, cfg["min_length"])
    actions = torch.argmax(logp + gumbel, dim=-1)
    durations = torch.exp(normal * sigma2 + mu)
    return (actions, durations) + scanpaths(actions, durations, cfg)


def greedy(logits, mu, cfg):
    """The greedy decode: (actions, durations, fixations, lengths), each
    leading with an [R] axis of one."""
    actions = torch.argmax(masked_logp(logits, cfg["min_length"]), dim=-1)
    durations = torch.exp(mu)
    out = (actions, durations) + scanpaths(actions, durations, cfg)
    return tuple(v[None] for v in out)
