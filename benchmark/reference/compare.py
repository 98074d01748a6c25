"""The numbers that decide ``correct``: what the timed path produced
against the plain reference on the same weights, inputs and noise.

For each stream of each checked unit (the largest reading over all):

* ``gap``: the widest gap between the reference's best score at a step
  and the program's own score of the action it served there (a score is
  the log-probability, plus the step's Gumbel noise for a sampled step;
  STOP scores -inf where the rules bar it).  Where the program served
  the reference's choice this is the two sides' disagreement on that
  action's score; a near tie adds at most its margin; an action that is
  not the best reads the distance to the best.
* ``logit``: the largest spread, over a step's actions, of the errors of
  the served log-probabilities against the reference's (a shift common
  to all actions cancels), over the actions whose probability is a
  normal float32 on both sides (a very peaked step underflows the
  rest).

``gap`` and ``logit`` are taken as shares of the range that the
reference's logits span at a step, the widest over everything checked;
how peaked the action maps are differs from seed to seed, and the
errors with it.
* ``mu``: the largest gap between the served and the reference's
  LogNormal mu, as a share of the range that the reference's mu spans
  over every checked step, image and stream (how strongly the duration
  head varies differs from seed to seed, and its errors with it);
  ``sigma2``: the same in log(sigma2).  Where that range is under
  :data:`RANGE_FLOOR` (in some seeds the head's relu is dead on every
  checked input, and both sides return its bias), there is nothing to
  compare and the number is not read (None).
* ``decode``: the served fixations against the reference's decode of
  the served actions, mu, sigma2 and noise (``sampler.scanpaths``,
  durations ``exp(normal * sigma2 + mu)``, greedy ``exp(mu)``): the
  largest coordinate gap in pixels, length gap in fixations, or gap in
  log duration.  The decode is the same arithmetic on the same values,
  so its limit is 0.

A number that is not finite reads as :data:`NOT_FINITE`, which fails
any limit.
"""

from __future__ import annotations

import math

import torch

from . import sampler

NUMBERS = ("gap", "logit", "mu", "sigma2", "decode")
NOT_FINITE = 1e30
# the least range of mu and log(sigma2) that is read
RANGE_FLOOR = 1e-3
# the least probability a ``logit`` reading compares (a normal float32
# with room)
P_FLOOR = 1e-30


def _value(t) -> float | None:
    if t is None:
        return None
    v = float(t)
    return v if math.isfinite(v) else NOT_FINITE


@torch.no_grad()
def judge(ref: dict, served: dict, cfg: dict, ranges: tuple, gumbel=None,
          normal=None) -> dict:
    """The five numbers of one stream.  ``ranges``: the spans of the
    reference's logits, mu and log(sigma2) over everything checked
    (:func:`ranges`).  ``ref``: the reference's
    ``logits`` [N, T, A], ``mu``, ``sigma2`` [N, T]; ``served``: the
    program's ``probs`` [N, T, A], ``mu``, ``sigma2`` [N, T] and its
    decode, ``actions``, ``durations`` [R, N, T], ``fix`` [R, N, T, 3],
    ``fix_len`` [R, N]; ``gumbel`` [R, N, T, A] and ``normal`` [R, N, T]
    for a sampled decode, None for a greedy one."""
    actions = served["actions"].long()
    best = sampler.masked_logp(ref["logits"], cfg["min_length"])
    own = sampler.masked_logp(torch.log(served["probs"].float()),
                              cfg["min_length"])
    if gumbel is not None:
        best, own = best + gumbel, own + gumbel
    own = own.expand(actions.shape + own.shape[-1:])
    chosen = torch.gather(own, -1, actions[..., None])[..., 0]
    gap = (best.amax(dim=-1) - chosen).abs().max() / ranges[0]
    want = torch.log_softmax(ref["logits"].float(), dim=-1)
    got = served["probs"].float()
    ok = (got >= P_FLOOR) & (want >= math.log(P_FLOOR))
    err = torch.log(got.clamp_min(P_FLOOR)) - want
    spread = torch.where(ok, err, -torch.inf).amax(dim=-1) \
        - torch.where(ok, err, torch.inf).amin(dim=-1)
    logit = spread.max() / ranges[0]
    mu = None if ranges[1] is None else \
        (served["mu"].float() - ref["mu"]).abs().max() / ranges[1]
    sigma2 = None if ranges[2] is None else \
        (torch.log(served["sigma2"].float())
         - torch.log(ref["sigma2"])).abs().max() / ranges[2]
    mu_s, sigma2_s = served["mu"], served["sigma2"]
    durations = torch.exp(mu_s) if normal is None \
        else torch.exp(normal * sigma2_s + mu_s)
    fix, length = sampler.scanpaths(actions, durations.expand(actions.shape),
                                    cfg)
    got = served["fix"].float()
    coord = (got[..., :2] - fix[..., :2]).abs().max()
    dur = (torch.log(got[..., 2]) - torch.log(fix[..., 2])).nan_to_num(
        nan=0.0).abs().max()
    lens = (served["fix_len"].long() - length).abs().max().float()
    return {"gap": _value(gap), "logit": _value(logit), "mu": _value(mu),
            "sigma2": _value(sigma2),
            "decode": _value(torch.stack([coord, dur, lens]).max())}


def ranges(refs) -> tuple:
    """The ranges that the reference's outputs ``refs`` span: its logits
    at a step (the widest), its mu and its log(sigma2) (None under
    :data:`RANGE_FLOOR`)."""
    logits = max(float((r["logits"].amax(-1) - r["logits"].amin(-1)).max())
                 for r in refs)
    mu = torch.cat([r["mu"].flatten() for r in refs])
    ls2 = torch.log(torch.cat([r["sigma2"].flatten() for r in refs]))
    spans = [float(mu.max() - mu.min()), float(ls2.max() - ls2.min())]
    return (logits, *(v if v >= RANGE_FLOOR else None for v in spans))


def worst(readings) -> dict:
    """The largest reading of each number over ``readings`` (dicts of
    :func:`judge`), None where none was read."""
    out = {}
    for k in NUMBERS:
        read = [r[k] for r in readings if r[k] is not None]
        out[k] = max(read) if read else None
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Whether every number read is within its limit."""
    return all(v <= limits[k] for k, v in numbers.items() if v is not None)
