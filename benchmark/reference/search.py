"""The plain reference of the visual-search model (Chen et al., CVPR
2021; chenxy99/Scanpaths,
``COCO_Search18/models/baseline_attention_multihead.py``): the
free-viewing model of :mod:`.model` with one input more, a detector
map of the search target, and its conditioner picked per sample from a
bank of 18 5x5 C->C convs, one a target category
(``object_sal_layer.<category>``).  Its weights, the maker of them from a
seed, the calibration, the forward and the control, in stock PyTorch.
It imports nothing of the program.

* The layout (:func:`layout`) is the free-viewing one with the single
  conditioner (``performance_sal_layer``) replaced by the 18 bank
  entries, in :data:`CATEGORIES` order; the signal gates are the
  free-viewing model's (``lstm.{input,forget,output}``).
* The weights (:func:`make_state_dict`) are slices of one normal draw
  with the init of :mod:`.weights`; the calibration (:func:`calibrate`)
  sets ``sal_conv``'s scale as there, and the action scale from the
  widest logit range of one calibration image searched for each of the
  18 targets, as one batch of 18.
* The forward (:func:`forward`) applies each sample's own bank entry:
  the materialised 5x5 conditioner conv on that sample's hidden state,
  then the head's convs (:func:`.model._head`), one sample at a time, as
  the reference's per-sample dispatch does (``baseline_attention_multihead.py``
  lines 285-289 and 359-363).  Nothing is composed.

Departures, each of no effect on the values: those of :mod:`.model`
(the x-term of each gate computed once, the spatial scoring conv as a
dot product); the bank's entries are looked up by index into
:data:`CATEGORIES` rather than by the category's name in the sample's
record.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import control, model, sampler, weights
from .weights import LSTM_GATES, SIGNAL_GATES

# the search targets in the order of the reference's category ids
# (``COCO_Search18/dataset/dataset.py``'s name2int)
CATEGORIES = ("bottle", "bowl", "car", "chair", "clock", "cup", "fork",
              "keyboard", "knife", "laptop", "microwave", "mouse", "oven",
              "potted plant", "sink", "stop sign", "toilet", "tv")
BANK = "object_sal_layer"
SINGLE = "performance_sal_layer"


def layout(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(key, shape, kind, std) of every leaf (:func:`.weights.layout`):
    the free-viewing layout with its conditioner replaced by the bank,
    each entry's weight then bias, where the conditioner was."""
    if cfg["bank_heads"] != len(CATEGORIES):
        raise ValueError(f"bank_heads {cfg['bank_heads']}: the published "
                         f"bank has {len(CATEGORIES)} categories")
    out = []
    for key, shape, kind, std in weights.layout({**cfg, "task": "osie"}):
        if key == f"{SINGLE}.weight":
            cond_w = (shape, kind, std)
        elif key == f"{SINGLE}.bias":
            for name in CATEGORIES:
                out.append((f"{BANK}.{name}.weight", *cond_w))
                out.append((f"{BANK}.{name}.bias", shape, kind, std))
        else:
            out.append((key, shape, kind, std))
    return out


def boxes(generator, n: int, cfg: dict, mix: dict, device):
    """``n`` detector maps [n, mh, mw, 1] and target ids [n] (int64),
    from ``generator`` on ``device``: each map the union of
    ``mix["boxes"]`` (an inclusive range) axis-aligned boxes at value 1,
    each side ``mix["box_cells"]`` map cells (cut to the map), on a zero
    map; a map is all zero (no detection above the threshold) with
    probability ``mix["empty_share"]``; each id uniform over the
    configuration's ``bank_heads`` categories."""
    mh, mw = cfg["map_height"], cfg["map_width"]
    lo, hi = mix["box_cells"]
    most = mix["boxes"][1]
    u = torch.rand((n, most, 4), generator=generator, device=device)
    k = torch.randint(mix["boxes"][0], most + 1, (n, 1),
                      generator=generator, device=device)
    empty = torch.rand((n, 1), generator=generator,
                       device=device) < mix["empty_share"]
    ids = torch.randint(0, cfg["bank_heads"], (n,), generator=generator,
                        device=device)
    sides = []
    for ax, size in ((0, mh), (1, mw)):
        top = min(hi, size)
        least = min(lo, top)
        side = least + (u[..., ax] * (top - least + 1)).floor()
        start = (u[..., 2 + ax] * (size - side + 1)).floor()
        sides.append((start, start + side))
    ys = torch.arange(mh, device=device).view(1, 1, mh, 1)
    xs = torch.arange(mw, device=device).view(1, 1, 1, mw)
    (y0, y1), (x0, x1) = ((a[..., None, None], b[..., None, None])
                          for a, b in sides)
    inside = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
    used = torch.arange(most, device=device)[None] < k
    union = (inside & used[..., None, None]).any(dim=1) & ~empty[..., None]
    return union.float()[..., None], ids


@torch.no_grad()
def make_state_dict(cfg: dict, seed: int, device, scales=None):
    """(the configuration's weights from ``seed``, the calibration's
    scales), as :func:`.weights.make_state_dict` makes them, in
    :func:`layout`; ``scales`` from an earlier call replaces the
    calibration."""
    leaves = layout(cfg)
    total = sum(math.prod(shape) for _, shape, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    spread = cfg["init"]["bn_spread"]
    sd, off = {}, 0
    for key, shape, kind, std in leaves:
        n = math.prod(shape)
        v = draw[off:off + n].view(shape)
        off += n
        if kind == "normal":
            v.mul_(std)
        elif kind == "bn_weight":
            v.mul_(spread).add_(1.0)
        elif kind == "bn_var":
            v.abs_().mul_(2 * spread).add_(1.0)
        else:
            v.mul_(spread)
        sd[key] = v
    init = cfg["init"]
    sd["object_head.drt_layer_2.weight"].mul_(init["duration_kernel_scale"])
    sd["object_head.drt_layer_2.bias"].copy_(torch.tensor(
        [math.log(init["duration_median_s"]),
         math.log(init["duration_sigma2"])], device=device))
    if scales is None:
        scales = calibrate(sd, cfg, seed, device)
    weights._scale(sd, scales)
    return sd, scales


# the calibration's detector map: one to three boxes of 3 to 20 cells
CALIBRATION_MIX = {"boxes": [1, 3], "box_cells": [3, 20], "empty_share": 0.0}


@torch.no_grad()
def calibrate(sd, cfg: dict, seed: int, device) -> dict:
    """The scales of ``sal_conv`` and of the head's 1x1 convs, as
    :func:`.weights.calibrate` sets them, from one calibration image and
    detector map of the seed's searched for every target: the action
    scale makes the widest logit range over the 18 the configuration's
    ``logit_range``."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    image = torch.randn((1, cfg["height"], cfg["width"], 3), generator=gen,
                        device=device)
    maps, _ = boxes(gen, 1, cfg, CALIBRATION_MIX, device)
    pre = F.conv2d(model.trunk(sd, cfg, image), sd["sal_conv.weight"],
                   sd["sal_conv.bias"], padding=1)
    feature = cfg["init"]["feature_rms"] / float(pre.pow(2).mean().sqrt())
    probe = dict(sd)
    for key in weights.FEATURE_KEYS:
        probe[key] = sd[key] * feature
    k = len(CATEGORIES)
    steps = {**cfg, "max_length": weights.CALIBRATION_STEPS}
    out = forward(probe, steps, image.expand(k, -1, -1, -1),
                  maps.expand(k, -1, -1, -1),
                  torch.arange(k, device=device))
    span = float((out["logits"].amax(-1) - out["logits"].amin(-1)).max())
    return {"feature": feature,
            "action": cfg["init"]["logit_range"] / max(span, 1e-6)}


@torch.no_grad()
def forward(sd, cfg, images, attention_maps, task_ids):
    """images NHWC [N, H, W, 3], detector maps [N, mh, mw, 1], target
    ids [N] -> ``logits`` [N, T, 1 + HW], ``mu`` and ``sigma2`` [N, T],
    in float32.  It computes in the dtype of ``images`` and of the
    weights ``sd``."""
    mh, mw, steps = cfg["map_height"], cfg["map_width"], cfg["max_length"]
    visual = F.relu(model._conv(model.trunk(sd, cfg, images), sd,
                                "sal_conv", padding=1))
    conds = [f"{BANK}.{CATEGORIES[k]}" for k in task_ids.tolist()]
    history = [model._entry(sd, attention_maps[..., 0].to(visual.dtype),
                            visual)]
    xterm = {g: model._conv(visual, sd, f"lstm.{g}_x", padding=1)
             for g in LSTM_GATES}
    h = torch.zeros_like(visual)
    c = torch.zeros_like(visual)
    out = {"logits": [], "mu": [], "sigma2": []}
    for _ in range(steps):
        pre = {g: xterm[g] + model._conv(h, sd, f"lstm.{g}_h", padding=1)
               for g in LSTM_GATES}
        smem, cmem = model._attend(sd, history, mh, mw)
        signal = smem[:, None] * cmem[:, :, None, None]
        for g in SIGNAL_GATES:
            pre[g] = pre[g] + model._conv(signal, sd, f"lstm.{g}", padding=1)
        c = torch.sigmoid(pre["forget"]) * c \
            + torch.sigmoid(pre["input"]) * torch.tanh(pre["memory"])
        h = torch.sigmoid(pre["output"]) * c
        per = [model._head(sd, cond, h[i:i + 1])
               for i, cond in enumerate(conds)]
        logits, mu, sigma2, amap = (torch.cat(v) for v in zip(*per))
        out["logits"].append(logits)
        out["mu"].append(mu)
        out["sigma2"].append(sigma2)
        history.append(model._entry(sd, amap, visual))
    return {k: torch.stack(v, dim=1).float() for k, v in out.items()}


@torch.no_grad()
def served(sd, cfg, images, attention_maps, task_ids, noise=None,
           precision: str = "tf32"):
    """What the control serves for a batch (:func:`.control.served`, one
    stream): the reference in the program's place, with TF32 on
    (``tf32``, on the card) or in bfloat16 (``bfloat16``; the CPU has no
    TF32), its own distributions decoded by the same rules and ``noise``
    (a (gumbel, normal) pair, None for greedy)."""
    if precision == "bfloat16":
        sd = {k: v.bfloat16() for k, v in sd.items()}
        out = forward(sd, cfg, images.bfloat16(), attention_maps, task_ids)
    else:
        with control.tf32():
            out = forward(sd, cfg, images, attention_maps, task_ids)
    if noise is None:
        dec = sampler.greedy(out["logits"], out["mu"], cfg)
    else:
        dec = sampler.sample(out["logits"], out["mu"], out["sigma2"],
                             *noise, cfg)
    actions, durations, fix, lengths = dec
    return {"probs": torch.softmax(out["logits"], dim=-1), "mu": out["mu"],
            "sigma2": out["sigma2"], "actions": actions,
            "durations": durations, "fix": fix, "fix_len": lengths}
