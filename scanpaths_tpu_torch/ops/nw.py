"""Batched Needleman-Wunsch ScanMatch score with gap 0 (port of
``scanpaths_tpu/ops/pallas_nw.py::nw_scores_bins``).

For each pair of raster-ordered bin symbol sequences the substitution
score is ``threshold - ||bin_a - bin_b||`` from the bin coordinates
``(s % xbin, s // xbin)``, cells outside the lengths get -3.4e38, each
DP row is ``max(cummax(max(diag + s, up)), 0)`` with ``F[., 0] = 0``,
and the score is ``max F / (threshold * max(la, lb))``, NaN when both
lengths are 0.

:func:`nw_scores_bins` runs the hand-written CUDA kernel
(``csrc/nw.cu``) on CUDA tensors and :func:`nw_scores_bins_plain`, the
same recurrence as a row loop of ``torch.cummax``, on CPU tensors.  The
two agree bit for bit (the kernel's source says why).  The kernel reads
the scores of in-range bins from :func:`kernel_table`, built once per
ScanMatch spec and device by the plain version's own expression
(:func:`_score`), and takes its launch shape from
:func:`launch_geometry`.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import _build

NEG = -3.4e38
MAX_COLUMNS = 1024   # the kernel keeps at most 32 columns a lane
TABLE_MAX = 1024     # scores by offset that the kernel's shared table
                     # holds (16 x 16 bins); beyond, it computes them


def _check(seq_a, len_a, seq_b, len_b):
    dev, i32 = seq_a.device, torch.int32
    if (seq_a.dim() == seq_b.dim() == 2
            and len_a.shape == len_b.shape == seq_a.shape[:1]
            and seq_b.shape[0] == seq_a.shape[0]
            and seq_a.dtype == len_a.dtype == seq_b.dtype == len_b.dtype == i32
            and len_a.device == seq_b.device == len_b.device == dev):
        return        # the common case, cheaply: the host time of a call
    if seq_a.dim() != 2 or seq_b.dim() != 2:
        raise ValueError(f"seq_a, seq_b must be [B, T], got "
                         f"{tuple(seq_a.shape)}, {tuple(seq_b.shape)}")
    b = seq_a.shape[0]
    for name, t, shape in (("seq_b", seq_b, (b, seq_b.shape[1])),
                           ("len_a", len_a, (b,)), ("len_b", len_b, (b,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("seq_a", seq_a), ("len_a", len_a), ("seq_b", seq_b),
                    ("len_b", len_b)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if t.device != seq_a.device:
            raise ValueError(f"{name} is on {t.device}, seq_a on "
                             f"{seq_a.device}")


def _coords(seq, xbin):
    return (torch.remainder(seq, xbin).float(),
            torch.div(seq, xbin, rounding_mode="floor").float())


def _score(dx, dy, threshold: float):
    """The substitution score at bin offset (dx, dy), float32."""
    return threshold - torch.sqrt(dx ** 2 + dy ** 2)


def kernel_table(threshold: float, xbin: int, ybin: int, device=None):
    """The table the kernel stages in shared memory: the scores of
    in-range bins by offset, n = (2 ybin - 1)(2 xbin - 1) of them, entry
    ``(dy + ybin - 1) * (2 xbin - 1) + dx + xbin - 1`` = threshold -
    ||(dx, dy)|| (the plain version's ``s``: one expression,
    :func:`_score`, on the same exact integer offsets); then (n + 1) / 2
    entries of -3.4e38, which a row outside the lengths reads (the plain
    version's mask), padded with them to a multiple of 4 floats."""
    dx = torch.arange(1 - xbin, xbin, device=device).float()
    dy = torch.arange(1 - ybin, ybin, device=device).float()
    scores = _score(dx[None, :], dy[:, None], threshold).flatten()
    n = scores.numel()
    total = -(-(n + (n + 1) // 2) // 4) * 4
    return torch.cat([scores, scores.new_full((total - n,), NEG)])


@functools.lru_cache(maxsize=None)
def _device_table(threshold: float, xbin: int, ybin: int, device):
    """:func:`kernel_table` on ``device``, built once; None when its
    scores pass TABLE_MAX (the kernel then computes every score)."""
    if ybin < 1 or (2 * xbin - 1) * (2 * ybin - 1) > TABLE_MAX:
        return None
    return kernel_table(threshold, xbin, ybin, device)


def launch_geometry(b: int, tb: int, sms: int) -> tuple[int, int]:
    """(columns a lane at most, warps a block) of a kernel launch for b
    pairs of tb columns on a card of ``sms`` SMs.  The kernel has
    instances for 1, 8 and 32 columns a lane (tb <= 32, 256, 1024); a
    pair uses ceil(lb / 32) of them.  Four pairs a block while that
    leaves at least two blocks an SM, else two, else one, so a small
    batch spreads over the card."""
    if not 0 <= tb <= MAX_COLUMNS:
        raise ValueError(f"the NW kernel takes at most {MAX_COLUMNS} "
                         f"columns, got Tb={tb}")
    chmax = next(c for c in (1, 8, 32) if 32 * c >= tb)
    warps = next(w for w in (4, 2, 1) if w == 1 or -(-b // w) >= 2 * sms)
    return chmax, warps


@functools.lru_cache(maxsize=None)
def _launch_args(b: int, tb: int, threshold: float, xbin: int, ybin: int,
                 index: int):
    """The arguments of a launch that depend on its shape and spec only,
    on CUDA device ``index``: (table pointer or None, table floats,
    columns a lane at most, warps a block), the table built once."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    chmax, warps = launch_geometry(b, tb, sms)
    table = _device_table(threshold, xbin, ybin, torch.device("cuda", index))
    if table is None:
        return None, 0, chmax, warps
    return table.data_ptr(), table.numel(), chmax, warps


def nw_scores_bins_plain(threshold: float, xbin: int, ybin: int,
                         seq_a, len_a, seq_b, len_b):
    """Plain PyTorch version of :func:`nw_scores_bins` (same arguments)."""
    _check(seq_a, len_a, seq_b, len_b)
    b, ta = seq_a.shape
    tb = seq_b.shape[1]
    xa, ya = _coords(seq_a, xbin)
    xb, yb = _coords(seq_b, xbin)
    la, lb = len_a[:, None], len_b[:, None]
    col_ok = torch.arange(tb, device=seq_b.device) < lb        # [B, Tb]
    prev = torch.zeros(b, tb, device=seq_a.device)
    best = torch.zeros(b, tb, device=seq_a.device)
    for i in range(ta if tb else 0):
        s = _score(xa[:, i:i + 1] - xb, ya[:, i:i + 1] - yb, threshold)
        s = torch.where(col_ok & (i < la), s, NEG)
        diag = F.pad(prev[:, :-1], (1, 0))                     # F[i-1, j-1]
        cand = torch.maximum(diag + s, prev)
        prev = torch.cummax(cand, dim=1).values.clamp_min(0.0)
        best = torch.maximum(best, prev)
    best = best.amax(dim=1) if tb else best.new_zeros(b)
    scale = threshold * torch.maximum(len_a, len_b).float()
    return torch.where(scale > 0, best / scale, torch.nan)


def nw_scores_bins(threshold: float, xbin: int, ybin: int,
                   seq_a, len_a, seq_b, len_b):
    """Batched NW alignment scores from raster-ordered bin symbols.

    seq_a: [B, Ta] int32, len_a: [B] int32; likewise seq_b, len_b.
    Returns [B] float32.  The symbols are raster-ordered on ``xbin``;
    ``ybin`` bounds them and sizes the kernel's score table (a symbol
    beyond ``xbin * ybin`` is scored all the same).  A CPU tensor runs
    :func:`nw_scores_bins_plain`; a CUDA tensor runs ``csrc/nw.cu``
    (contiguous, Tb <= 1024; any int32 symbols and lengths, the lengths
    clamped to [0, T]) or raises.
    """
    if seq_a.device.type == "cpu":
        return nw_scores_bins_plain(threshold, xbin, ybin, seq_a, len_a,
                                    seq_b, len_b)
    _check(seq_a, len_a, seq_b, len_b)
    if seq_a.device.type != "cuda":
        raise ValueError(f"no NW kernel for device {seq_a.device}")
    if not (seq_a.is_contiguous() and len_a.is_contiguous()
            and seq_b.is_contiguous() and len_b.is_contiguous()):
        raise ValueError("the NW kernel needs contiguous tensors")
    b, ta = seq_a.shape
    tb = seq_b.shape[1]
    index = seq_a.device.index
    xbin, ybin, threshold = int(xbin), int(ybin), float(threshold)
    table, table_len, chmax, warps = _launch_args(b, tb, threshold, xbin,
                                                  ybin, index)
    out = torch.empty(b, dtype=torch.float32, device=seq_a.device)
    if b == 0:
        return out
    # The raw current stream, without building a torch.cuda.Stream, and
    # the shape's arguments from one cache: this wrapper's host time is
    # most of a small batch's call (PERF.md).
    err = _build.kernel("sp_nw_scores_bins", 6, 9, 1)(
        seq_a.data_ptr(), len_a.data_ptr(), seq_b.data_ptr(),
        len_b.data_ptr(), table, out.data_ptr(), b, ta, tb, xbin, ybin,
        table_len, chmax, warps, index, threshold,
        torch._C._cuda_getCurrentRawStream(index))
    if err:
        _build.check("sp_nw_scores_bins", err)
    tracing.count("nw_scores_bins.launches")
    return out
