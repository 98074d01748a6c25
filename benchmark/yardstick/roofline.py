"""The card's peaks and the least time a call of each of the port's
kernels could take.

Copied from ``chip_smoke.py`` (``PEAK_FLOPS``, ``PEAK_BYTES``,
``NW_OPS_PER_CELL``, ``_bound``, ``cell_bound``, ``stage_work``), with
dtypes named by strings so that this file needs no torch.  The copies
live here so that a change to the program cannot move the yardstick.

A call's bound is the larger of its operations over the peak for their
type and its bytes (each input read once, each output written once)
over the memory bandwidth.  A share of the bound over 100% means the
operations or bytes are counted too high, or the time left out part of
the work: :func:`share` raises for one.
"""

from __future__ import annotations

# Published H100 SXM peaks (dense): float32 on the CUDA cores, bf16 on
# the tensor cores, HBM bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
ITEMSIZE = {"float32": 4, "bfloat16": 2}
# float operations per NW DP cell: 2 subs, 2 muls, add, sqrt, sub (the
# substitution score), the diag add, and 3 maxes (cand, running max,
# combine)
NW_OPS_PER_CELL = 11

# (planes, first-block stride, dilation) of the trunk's four stages
# after the reference's dilation patch
TRUNK_STAGES = ((64, 1, 1), (128, 1, 1), (256, 2, 2), (512, 1, 4))


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """(bound_ms, bound_by) of a call."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def cell_bound(n, h, w, c, s, dtype: str) -> tuple[float, str]:
    """The cell step: the 3x3 C->4C gate conv, the signal taps, the xg
    add and the state update, over h, c, xg, smaps, kps, kh in and h', c'
    out."""
    p = n * h * w
    flops = 2 * p * (9 * c * 4 * c + 9 * s * 3 * c) + 4 * p * c + 4 * p * c
    elems = 2 * p * c + 4 * p * c + p * s + n * s * 27 * c + 36 * c * c \
        + 2 * p * c
    return bound(flops, elems * ITEMSIZE[dtype], PEAK_FLOPS[dtype])


def stage_work(n, h, w, c, m, nb, dtype: str) -> tuple[float, float]:
    """(operations, bytes) of one stage of nb bottleneck blocks: three
    products each (1x1 C->M, 3x3 M->M, 1x1 M->C) over x and the folded
    weights in, y out."""
    p = n * h * w
    per_block = c * m + 9 * m * m + m * c
    flops = 2 * p * nb * per_block
    nbytes = ITEMSIZE[dtype] * (2 * p * c + nb * per_block) \
        + 4 * nb * (2 * m + c)
    return flops, nbytes


def stage_shapes(height: int, width: int, layers) -> list[tuple]:
    """(h, w, c, m, nb) of each stage call of the trunk (layers 1-3, the
    uniform blocks after each stage's first), at an input of
    ``height`` x ``width``: the stem halves it, the ceil max-pool halves
    it again, and each stage's first block applies its stride."""
    h = -(-(height // 2 - 3) // 2) + 1
    w = -(-(width // 2 - 3) // 2) + 1
    out = []
    for si, ((planes, stride, _), blocks) in enumerate(
            zip(TRUNK_STAGES, layers), start=1):
        h, w = h // stride, w // stride
        if si <= 3 and blocks > 1:
            out.append((h, w, 4 * planes, planes, blocks - 1))
    return out


def stage_bound_ms(n, height, width, layers, dtype: str) -> float:
    """The least time of the stage kernel's calls in one trunk forward
    at batch ``n``: each call's bound, summed."""
    return sum(bound(*stage_work(n, h, w, c, m, nb, dtype),
                     PEAK_FLOPS[dtype])[0]
               for h, w, c, m, nb in stage_shapes(height, width, layers))


def nw_bound(cells: int, pairs: int, ta: int, tb: int) -> tuple[float, str]:
    """One NW call over ``pairs`` pairs of ``ta`` and ``tb`` symbols whose
    lengths give ``cells`` DP cells in all: the cells' operations, the
    symbols and lengths in and the scores out (``chip_smoke.py``'s
    ``nw_call_stats``)."""
    return bound(NW_OPS_PER_CELL * cells, 4 * (pairs * (ta + tb) + 3 * pairs),
                 PEAK_FLOPS["float32"])


def share(bound_ms: float, ms: float, what: str) -> float:
    """``bound_ms`` over ``ms`` in percent; raises over 100%."""
    pct = 100.0 * bound_ms / ms
    if not pct <= 100.0:
        raise ValueError(f"{what}: {pct:.2f}% of its bound ({bound_ms:.4g} "
                         f"ms bound against {ms:.4g} ms): the work is "
                         "counted too high or the time left part of it out")
    return pct
