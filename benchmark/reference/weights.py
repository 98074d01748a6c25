"""The weights of a configuration, made on the card from a seed, in the
layout of the published model's own checkpoints (chenxy99/Scanpaths:
``resnet.*`` for the trunk, one conv per ConvLSTM gate and input,
``performance_sal_layer`` for the conditioner, ``object_head.*``).

Both sides take this one dict: the program through its own loader,
which fuses and folds what it needs, and the plain reference as it is.

Every leaf is one slice of a single normal draw from a generator on the
card, scaled by its init: He-normal trunk convs, Xavier-normal decoder
convs (each per-gate conv with its own fans), normal(0.01) dense
layers; biases and BatchNorm's affine terms and running statistics are
drawn too (a trained model has them; zeros would leave the folds that
the program makes untested).  The configuration's ``init`` then sets
what a trained model has and seed weights lack, the first two measured
on a calibration image drawn from the seed (:func:`calibrate`):

* ``feature_rms``: ``sal_conv`` (weight and bias) is scaled so that its
  output has this rms, and so are the decoder's visual features.  Seed
  trunks differ in the scale of their output (an rms of 11 to 44 over a
  dozen seeds), and where the features are large the decoder saturates
  (|h| grows by about one a step) and two correct float32 summation
  orders end far apart after 16 steps;
* ``logit_range``: the head's two 1x1 convs (the STOP logit's and the
  action map's) are scaled so that the action logits of the first steps
  span this range, as peaked as a trained model's maps rather than all
  but uniform, and no more peaked;
* ``duration_kernel_scale`` scales the duration head's last conv, and
  its bias is set to [log(``duration_median_s``), log(``duration_sigma2``)]:
  at seed scale its LogNormal scale overflows float32.
"""

from __future__ import annotations

import math

import torch

# (planes, first-block stride, dilation) of the trunk's four stages,
# children 4..7 of the reference's ``resnet`` Sequential
TRUNK_STAGES = ((64, 1, 1), (128, 1, 1), (256, 2, 2), (512, 1, 4))
LSTM_GATES = ("input", "forget", "output", "memory")
SIGNAL_GATES = ("input", "forget", "output")
# each stream's signal-gate suffix and conditioner key
STREAMS = {"osie": (("", "performance_sal_layer"),),
           "air": (("_pos", "performance_sal_layer.True"),
                   ("_neg", "performance_sal_layer.False"))}


def _he(shape):
    out, _, kh, kw = shape
    return math.sqrt(2.0 / (kh * kw * out))


def _xavier(shape):
    out, cin, kh, kw = shape
    return math.sqrt(2.0 / (kh * kw * cin + kh * kw * out))


def layout(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(key, shape, kind, std) of every leaf; ``kind`` is one of
    ``normal`` (std), ``bn_weight``, ``bn_bias``, ``bn_mean``,
    ``bn_var``."""
    e, mh, mw = cfg["embed"], cfg["map_height"], cfg["map_width"]
    bias = cfg["init"]["bias_std"]
    leaves = []

    def conv(key, shape, std, with_bias=True):
        leaves.append((f"{key}.weight", tuple(shape), "normal", std))
        if with_bias:
            leaves.append((f"{key}.bias", (shape[0],), "normal", bias))

    def dense(key, out, inp):
        leaves.append((f"{key}.weight", (out, inp), "normal", 0.01))
        leaves.append((f"{key}.bias", (out,), "normal", bias))

    def bn(key, c):
        for part in ("weight", "bias", "mean", "var"):
            name = {"mean": "running_mean", "var": "running_var"}.get(
                part, part)
            leaves.append((f"{key}.{name}", (c,), f"bn_{part}", 0.0))

    conv("resnet.0", (64, 3, 7, 7), _he((64, 3, 7, 7)), with_bias=False)
    bn("resnet.1", 64)
    cin = 64
    for si, ((planes, _, _), blocks) in enumerate(
            zip(TRUNK_STAGES, cfg["backbone_layers"])):
        for b in range(blocks):
            pre = f"resnet.{4 + si}.{b}"
            for i, shape in enumerate(((planes, cin, 1, 1),
                                       (planes, planes, 3, 3),
                                       (4 * planes, planes, 1, 1)), start=1):
                conv(f"{pre}.conv{i}", shape, _he(shape), with_bias=False)
                bn(f"{pre}.bn{i}", shape[0])
            if b == 0:
                shape = (4 * planes, cin, 1, 1)
                conv(f"{pre}.downsample.0", shape, _he(shape),
                     with_bias=False)
                bn(f"{pre}.downsample.1", 4 * planes)
            cin = 4 * planes
    conv("sal_conv", (e, cin, 3, 3), _xavier((e, cin, 3, 3)))
    for g in LSTM_GATES:
        for src in ("x", "h"):
            conv(f"lstm.{g}_{src}", (e, e, 3, 3), _xavier((e, e, 3, 3)))
    for suffix, _ in STREAMS[cfg["task"]]:
        for g in SIGNAL_GATES:
            conv(f"lstm.{g}{suffix}", (e, e, 3, 3), _xavier((e, e, 3, 3)))
    dense("semantic_embed", e, e)
    dense("spatial_embed", mh * mw, mh * mw)
    dense("semantic_att.semantic_lists", e, e)
    dense("semantic_att.semantic_cur", e, e)
    dense("semantic_att.semantic_attention", 1, e)
    conv("spatial_att.spatial_lists", (1, 1, 3, 3), _xavier((1, 1, 3, 3)))
    conv("spatial_att.spatial_cur", (1, 1, 3, 3), _xavier((1, 1, 3, 3)))
    conv("spatial_att.spatial_attention", (1, 1, mh, mw),
         _xavier((1, 1, mh, mw)))
    for _, cond in STREAMS[cfg["task"]]:
        conv(cond, (e, e, 5, 5), _xavier((e, e, 5, 5)))
    for key, shape in (("sal_layer_2", (1, e, 1, 1)),
                       ("sal_layer_3", (1, e, 1, 1)),
                       ("drt_layer_1", (1, e, 7, 7)),
                       ("drt_layer_2", (2, 1, mh // 5, mw // 5))):
        conv(f"object_head.{key}", shape, _xavier(shape))
    return leaves


@torch.no_grad()
def make_state_dict(cfg: dict, seed: int, device, scales=None):
    """(the configuration's weights from ``seed``, the calibration's
    scales): one normal draw on ``device`` for every leaf, sliced and
    scaled (module docstring).  ``scales``, returned by an earlier call,
    replaces the calibration, so that both sides of a check get the
    same weights bit for bit."""
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
    _scale(sd, scales)
    return sd, scales


FEATURE_KEYS = ("sal_conv.weight", "sal_conv.bias")
ACTION_KEYS = ("object_head.sal_layer_2.weight",
               "object_head.sal_layer_3.weight")
# the steps whose logit range sets the action scale
CALIBRATION_STEPS = 4


def _scale(sd, scales) -> None:
    for key in FEATURE_KEYS:
        sd[key].mul_(scales["feature"])
    for key in ACTION_KEYS:
        sd[key].mul_(scales["action"])


@torch.no_grad()
def calibrate(sd, cfg: dict, seed: int, device) -> dict:
    """The scales of ``sal_conv`` and of the head's 1x1 convs (module
    docstring), from the plain reference on one calibration image (and
    attention map) of the seed's: {"feature": ..., "action": ...}."""
    import torch.nn.functional as F

    from . import model
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    image = torch.randn((1, cfg["height"], cfg["width"], 3), generator=gen,
                        device=device)
    maps = torch.rand((1, cfg["map_height"], cfg["map_width"], 1),
                      generator=gen, device=device) \
        if cfg["task"] == "air" else None
    pre = F.conv2d(model.trunk(sd, cfg, image), sd["sal_conv.weight"],
                   sd["sal_conv.bias"], padding=1)
    feature = cfg["init"]["feature_rms"] / float(pre.pow(2).mean().sqrt())
    probe = dict(sd)
    for key in FEATURE_KEYS:
        probe[key] = sd[key] * feature
    steps = {**cfg, "max_length": CALIBRATION_STEPS}
    spans = [float((o["logits"].amax(-1) - o["logits"].amin(-1)).max())
             for o in model.forward(probe, steps, image, maps)]
    return {"feature": feature,
            "action": cfg["init"]["logit_range"] / max(max(spans), 1e-6)}
