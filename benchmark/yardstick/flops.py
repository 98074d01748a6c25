"""The analytic FLOP count of the scanpath model, extended to S streams,
and the share of the card's peak it gives.

Copied from ``scanpaths_tpu_torch/tools/flops.py`` (``conv_flops``,
``model_flops_parts``, ``mfu``), which counts OSIE alone.  Here a
forward of S streams (AiR: good and poor) counts the trunk, the hoisted
convs and each step's gate conv once, and each step's signal gates and
composed conditioner+head once per stream: the streams share one
ConvLSTM and each has its own conditioner, head and history.  The dense
attention terms are under 1% and left out, as in the original.
"""

from __future__ import annotations

from .roofline import PEAK_FLOPS


def conv_flops(hw: int, k: int, cin: int, cout: int) -> float:
    """2 * MACs for a kxk conv producing ``hw`` output pixels."""
    return 2.0 * k * k * cin * cout * hw


def model_flops_parts(h: int = 240, w: int = 320, t: int = 16,
                      embed: int = 512, layers=(3, 4, 6, 3)) -> dict:
    """Forward FLOPs of one stream's model by part (convs only):
    ``stem`` (the 7x7 input conv), ``blocks`` (every bottleneck conv),
    ``hoisted`` (sal_conv and the x-gates, once a forward),
    ``step_gates`` (a step's 3x3 embed -> 4 embed h-gate conv),
    ``step_other`` (a step's factorized signal gates and the composed
    conditioner+head: a 5x5 embed->2 conv, an 11x11 stride-5 embed->1
    conv and its border strips, and the duration tail) and ``t``."""
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
    head = (conv_flops(fhw, 5, embed, 2)
            + 2.0 * 11 * 11 * embed * h5 * w5
            + 2.0 * 2 * 11 * embed * w5
            + 2.0 * 11 * 2 * embed * h5
            + 2.0 * h5 * w5 * 2 * h5 * w5)
    step_gates = conv_flops(fhw, 3, embed, 4 * embed)
    return {"stem": stem, "blocks": blocks_total, "hoisted": hoisted,
            "step_gates": step_gates, "step_other": gates_s + head, "t": t}


def flops_per_image(streams: int = 1, **geo) -> float:
    """Forward FLOPs of one image through a model of ``streams``
    streams (``model_flops_parts``'s geometry keywords)."""
    p = model_flops_parts(**geo)
    return (p["stem"] + p["blocks"] + p["hoisted"]
            + p["t"] * (p["step_gates"] + streams * p["step_other"]))


def mfu_pct(flops: float, seconds: float, dtype: str = "float32") -> float:
    """``flops`` done in ``seconds`` as a percentage of the card's peak
    for ``dtype``; raises over 100%: a time that implies more than the
    card's peak did not wait for the work."""
    pct = 100.0 * flops / seconds / PEAK_FLOPS[dtype]
    if not pct <= 100.0:
        raise ValueError(f"MFU {pct:.2f}% over 100% ({flops:.4g} FLOP in "
                         f"{seconds:.4g} s, {dtype}): the timing did not "
                         "wait for the work")
    return pct
