"""Batched scanpath decoding (port of ``scanpaths_tpu/ops/sampling.py``).

The reference's quirks are kept (they change the numbers if "fixed"):

* durations are sampled as ``exp(randn * sigma2 + mu)`` — the SQUARED
  scale multiplies the normal draw;
* STOP is masked out of the action choice for the first ``min_length``
  steps by zeroing its probability, but the gathered per-action
  probabilities come from the ORIGINAL distribution;
* ``scanpath_length`` counts the first STOP at index >= 1 (an index-0
  STOP leaves the length at the full T);
* the action mask covers fixations up to AND including the first STOP,
  the duration mask only strict fixations.

The random draw is split from the transform:
:func:`random_sample_from_noise` is a pure function of the Gumbel and
normal noise, and :func:`random_sample` draws that noise from a
``torch.Generator``.  The categorical draw is ``argmax(logits + gumbel)``,
the form ``jax.random.categorical`` takes, so the JAX sampler's noise
fed in here gives its exact actions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.grid import FIX_DTYPE, GridSpec


class SampleOut(NamedTuple):
    actions: torch.Tensor          # [..., T] int32 sampled action ids
    action_probs: torch.Tensor     # [..., T] probability of the action
    durations: torch.Tensor        # [..., T] sampled durations (seconds)
    scanpath_length: torch.Tensor  # [...] reference length semantics
    fix: torch.Tensor              # [..., T, 3] (x, y, duration) fixations
    fix_len: torch.Tensor          # [...] fixations before the first STOP
    action_mask: torch.Tensor      # [..., T] float
    duration_mask: torch.Tensor    # [..., T] float


def _masked(probs, grid: GridSpec):
    masked = probs.clone()
    masked[..., :grid.min_length, 0] = 0.0
    return masked


def _decode(probs, actions, durations, grid: GridSpec) -> SampleOut:
    """Shared tail: lengths, masks and pixel fixations of chosen actions."""
    t = probs.shape[-2]
    action_probs = torch.gather(probs, -1, actions[..., None])[..., 0]
    is_stop = actions == 0
    idx = torch.arange(t, device=probs.device)
    stop_pos = torch.where(is_stop & (idx >= 1), idx, torch.full_like(idx, t))
    scanpath_length = stop_pos.min(dim=-1).values

    stopped_before = (torch.cumsum(is_stop.int(), dim=-1)
                      - is_stop.int()) > 0
    fixating = ~is_stop & ~stopped_before
    first_stop = is_stop & ~stopped_before
    action_mask = (fixating | first_stop).float()
    duration_mask = fixating.float()

    cell = torch.clamp(actions - 1, min=0)
    gx, gy = grid.x_granularity, grid.y_granularity
    px = (cell % grid.map_width) * gx + gx / 2
    py = torch.div(cell, grid.map_width, rounding_mode="floor") * gy + gy / 2
    fix = torch.stack([px.to(durations.dtype), py.to(durations.dtype),
                       durations], dim=-1) * duration_mask[..., None]
    fix_len = duration_mask.sum(dim=-1).int()
    return SampleOut(actions=actions.int(), action_probs=action_probs,
                     durations=durations, scanpath_length=scanpath_length,
                     fix=fix, fix_len=fix_len, action_mask=action_mask,
                     duration_mask=duration_mask)


def random_sample_from_noise(probs, mu, sigma2, grid: GridSpec, gumbel,
                             normal) -> SampleOut:
    """Stochastic decode from given noise.

    probs: [..., T, A] action distributions (softmaxed); mu, sigma2:
    [..., T] LogNormal duration parameters; gumbel: standard Gumbel
    noise shaped like probs; normal: standard normal noise shaped like
    mu."""
    logits = torch.log(_masked(probs, grid) + 1e-20)
    actions = torch.argmax(logits + gumbel, dim=-1)
    durations = torch.exp(normal * sigma2 + mu)
    return _decode(probs, actions, durations, grid)


def random_sample(probs, mu, sigma2, grid: GridSpec,
                  generator: torch.Generator) -> SampleOut:
    """Sample one scanpath per leading-batch element, drawing the noise
    from ``generator`` (on the device of ``probs``).  For several
    rollouts per image, expand ``probs``/``mu``/``sigma2`` with a
    leading [R] axis first."""
    u = torch.rand(probs.shape, generator=generator, device=probs.device,
                   dtype=probs.dtype)
    tiny = torch.finfo(probs.dtype).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    normal = torch.randn(mu.shape, generator=generator, device=mu.device,
                         dtype=mu.dtype)
    return random_sample_from_noise(probs, mu, sigma2, grid, gumbel, normal)


def greedy_sample(probs, mu, sigma2, grid: GridSpec) -> SampleOut:
    """Deterministic decode: argmax actions (STOP masked for the first
    ``min_length`` steps) and median LogNormal durations ``exp(mu)``."""
    actions = torch.argmax(_masked(probs, grid), dim=-1)
    return _decode(probs, actions, torch.exp(mu), grid)


def sample_checksum(sample: SampleOut):
    """Device scalar that depends on every sampled fixation: reading it
    on the host waits for the work.  Values are magnitude-clipped first,
    since a random-init model can emit huge finite durations."""
    fix = torch.clamp(torch.nan_to_num(sample.fix, nan=1.0, posinf=1e6,
                                       neginf=-1e6), -1e6, 1e6)
    return fix.float().sum() + sample.fix_len.float().sum()


def to_fix_vectors(sample: SampleOut) -> list[np.ndarray]:
    """One structured fixation vector per batch element (the
    interchange format of the host metric suite)."""
    fix = sample.fix.detach().cpu().numpy()
    lens = sample.fix_len.detach().cpu().numpy()
    flat_fix = fix.reshape(-1, *fix.shape[-2:])
    flat_len = lens.reshape(-1)
    out = []
    for i in range(flat_fix.shape[0]):
        n = int(flat_len[i])
        v = np.empty(n, dtype=FIX_DTYPE)
        v["start_x"] = flat_fix[i, :n, 0]
        v["start_y"] = flat_fix[i, :n, 1]
        v["duration"] = flat_fix[i, :n, 2]
        out.append(v)
    return out
