"""Analytic FLOP model of the OSIE model (the port's copy of
``bench.py``'s ``conv_flops``, ``model_flops_parts``,
``model_flops_per_image`` and ``train_flops_per_image``), and the
H100's peak rates for an MFU.

The port has no remat (its trainer logs ``--remat`` as not applied), so
``train_flops_per_image`` takes the mode ``"none"`` alone.
``model_flops_parts`` also takes the trunk's ``layers`` (blocks per
stage), the reference's (3, 4, 6, 3) by default, for the thin trunks of
the convergence run and the tests.

Peak rates: the H100 SXM's public dense figures, 989 TFLOP/s in
bfloat16 and 67 TFLOP/s in float32 (the rates ``chip_smoke.py``'s
bounds use).  :func:`mfu` raises for an MFU over 1.0: a time that
implies more than the card's peak is a timing fault.
"""

from __future__ import annotations

import torch

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(dtype)


def peak_flops(dtype) -> float:
    """The H100 SXM's dense peak in FLOP/s for ``dtype`` (a torch dtype or
    its name)."""
    return PEAK_FLOPS[_dtype_name(dtype)]


def mfu(flops: float, seconds: float, dtype) -> float:
    """``flops`` done in ``seconds`` as a share of the peak; raises over
    1.0."""
    share = flops / seconds / peak_flops(dtype)
    if not share <= 1.0:
        raise ValueError(f"MFU {share:.4f} over 1.0 ({flops:.4g} FLOP in "
                         f"{seconds:.4g} s, {_dtype_name(dtype)}): the "
                         "timing did not wait for the work")
    return share


def conv_flops(hw: int, k: int, cin: int, cout: int) -> float:
    """2 * MACs for a kxk conv producing ``hw`` output pixels."""
    return 2.0 * k * k * cin * cout * hw


def model_flops_parts(h: int = 240, w: int = 320, t: int = 16,
                      embed: int = 512, fuse_head: bool = True,
                      layers=(3, 4, 6, 3)) -> dict:
    """Forward FLOPs of the OSIE model by part (convs only; the dense
    attention terms are under 1% and left out): ``stem`` (the 7x7 input
    conv), ``blocks`` (every bottleneck conv), ``hoisted`` (sal_conv and
    the x-gates, once a forward), ``step_gates`` (a step's 3x3
    embed -> 4 embed h-gate conv), ``step_other`` (a step's factorized
    signal gates and head) and ``t``.  ``fuse_head``: the composed
    conditioner+head (a 5x5 512->2 conv, an 11x11 stride-5 512->1 conv
    and border strips) that the model evaluates, else the plain
    conditioner and head convs."""
    h2, w2 = h // 2, w // 2                       # conv1 stride 2
    stem = conv_flops(h2 * w2, 7, 3, 64)
    hp = -(-(h2 - 3) // 2) + 1                    # ceil maxpool
    wp = -(-(w2 - 3) // 2) + 1
    blocks_total = 0.0
    cin = 64
    cur_h, cur_w = hp, wp
    for (planes, stride), blocks in zip(((64, 1), (128, 1), (256, 2),
                                         (512, 1)), layers):
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            out_h, out_w = cur_h // s, cur_w // s
            hw = out_h * out_w
            blocks_total += conv_flops(hw, 1, cin, planes)         # conv1
            blocks_total += conv_flops(hw, 3, planes, planes)      # conv2
            blocks_total += conv_flops(hw, 1, planes, planes * 4)  # conv3
            if bi == 0:
                blocks_total += conv_flops(hw, 1, cin, planes * 4)
            cin = planes * 4
            cur_h, cur_w = out_h, out_w
    fh, fw = cur_h, cur_w                          # 30 x 40 feature grid
    fhw = fh * fw
    hoisted = (conv_flops(fhw, 3, 2048, embed)       # sal_conv
               + conv_flops(fhw, 3, embed, 4 * embed))  # xgates
    # the signal gates run factorized over the rank-1 signal
    gates_s = (2.0 * 9 * embed * 3 * embed
               + 2.0 * fhw * 9 * 3 * embed)
    h5, w5 = fh // 5, fw // 5
    if fuse_head:
        head = (conv_flops(fhw, 5, embed, 2)
                + 2.0 * 11 * 11 * embed * h5 * w5
                + 2.0 * 2 * 11 * embed * w5
                + 2.0 * 11 * 2 * embed * h5
                + 2.0 * h5 * w5 * 2 * h5 * w5)
    else:
        head = (conv_flops(fhw, 5, embed, embed)
                + conv_flops(fhw, 1, embed, 2)
                + conv_flops(h5 * w5, 7, embed, 1))
    step_gates = conv_flops(fhw, 3, embed, 4 * embed)
    return {"stem": stem, "blocks": blocks_total, "hoisted": hoisted,
            "step_gates": step_gates, "step_other": gates_s + head, "t": t}


def model_flops_per_image(h: int = 240, w: int = 320, t: int = 16,
                          embed: int = 512, fuse_head: bool = True,
                          layers=(3, 4, 6, 3)) -> float:
    """Forward FLOPs of the OSIE model (see :func:`model_flops_parts`)."""
    p = model_flops_parts(h, w, t, embed, fuse_head, layers)
    return (p["stem"] + p["blocks"] + p["hoisted"]
            + p["t"] * (p["step_gates"] + p["step_other"]))


def train_flops_per_image(remat_mode: str = "none", **kw) -> float:
    """FLOPs of one training step per image: the forward, and a backward
    of two convs per conv (dX and dW) but the stem's dX (images carry no
    gradient)."""
    if remat_mode != "none":
        raise ValueError(f"remat {remat_mode!r}: the port has no remat")
    p = model_flops_parts(**kw)
    fwd = (p["stem"] + p["blocks"] + p["hoisted"]
           + p["t"] * (p["step_gates"] + p["step_other"]))
    return fwd + 2.0 * fwd - p["stem"]
