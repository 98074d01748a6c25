"""Batched Needleman-Wunsch ScanMatch score with gap 0 (port of
``scanpaths_tpu/ops/pallas_nw.py::nw_scores_bins``).

For each pair of raster-ordered bin symbol sequences the substitution
score is ``threshold - ||bin_a - bin_b||`` from the bin coordinates
``(s % xbin, s // xbin)`` (no table), cells outside the lengths get
-3.4e38, each DP row is ``max(cummax(max(diag + s, up)), 0)`` with
``F[., 0] = 0``, and the score is ``max F / (threshold * max(la, lb))``,
NaN when both lengths are 0.

:func:`nw_scores_bins` runs the hand-written CUDA kernel
(``csrc/nw.cu``) on CUDA tensors and :func:`nw_scores_bins_plain`, the
same recurrence as a row loop of ``torch.cummax``, on CPU tensors.  The
two agree bit for bit (the kernel's source says why).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

# launches of the CUDA kernel in this process (read by chip_smoke.py)
nw_launches = 0

NEG = -3.4e38
MAX_COLUMNS = 1024  # the kernel keeps at most 32 columns a lane


def _check(seq_a, len_a, seq_b, len_b):
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
        s = threshold - torch.sqrt((xa[:, i:i + 1] - xb) ** 2
                                   + (ya[:, i:i + 1] - yb) ** 2)
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
    Returns [B] float32.  ``ybin`` only bounds the symbols (they are
    raster-ordered on ``xbin``).  A CPU tensor runs
    :func:`nw_scores_bins_plain`; a CUDA tensor runs ``csrc/nw.cu``
    (contiguous, Tb <= 1024) or raises.
    """
    global nw_launches
    if seq_a.device.type == "cpu":
        return nw_scores_bins_plain(threshold, xbin, ybin, seq_a, len_a,
                                    seq_b, len_b)
    _check(seq_a, len_a, seq_b, len_b)
    if seq_a.device.type != "cuda":
        raise ValueError(f"no NW kernel for device {seq_a.device}")
    ts = (seq_a, len_a, seq_b, len_b)
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the NW kernel needs contiguous tensors")
    b, ta = seq_a.shape
    tb = seq_b.shape[1]
    if tb > MAX_COLUMNS:
        raise ValueError(f"the NW kernel takes at most {MAX_COLUMNS} "
                         f"columns, got Tb={tb}")
    out = torch.empty(b, dtype=torch.float32, device=seq_a.device)
    if b == 0:
        return out
    fn = _build.kernel("sp_nw_scores_bins", 5, 4, 1)
    with torch.cuda.device(seq_a.device):
        err = fn(*(t.data_ptr() for t in ts), out.data_ptr(), b, ta, tb,
                 int(xbin), float(threshold),
                 torch.cuda.current_stream(seq_a.device).cuda_stream)
    _build.check("sp_nw_scores_bins", err)
    nw_launches += 1
    return out
