"""Device-side scanpath metrics on fixed-shape padded tensors (port of
``scanpaths_tpu/metrics/jax_metrics.py``).

They power the device evaluation sweep (``metrics/device_eval.py``) and,
in the training slice, the SCST reward.

Conventions:
* a scanpath batch is ``(fix [B, L, 3], length [B])`` where the last
  axis is (x_pixel, y_pixel, duration_seconds) and entries at or beyond
  ``length`` are padding;
* the DP tables are statically padded and masked; ``lax.scan`` and
  ``fori_loop`` of the JAX version become Python loops over ``[B, ...]``
  tensors, and ``vmap`` the batch axis.

The ScanMatch alignment (:func:`scanmatch_scores`) always goes through
``ops/nw.py``: its CUDA kernel on a CUDA tensor, its plain version on a
CPU tensor.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import nw

_BIG = 3.4e38


class ScanMatchSpec(NamedTuple):
    """Static ScanMatch configuration (framework standard:
    16x12 bins over 320x240, threshold 3.5 — reference AiR/train.py:216-218)."""
    xres: int = 320
    yres: int = 240
    xbin: int = 16
    ybin: int = 12
    threshold: float = 3.5
    temp_bin: float = 0.0       # ms per symbol repeat; 0 = no expansion
    max_symbols: int = 16       # static bound on expanded sequence length

    @property
    def num_bins(self) -> int:
        return self.xbin * self.ybin


def sub_matrix(spec: ScanMatchSpec, device=None) -> torch.Tensor:
    """S[a, b] = threshold - ||bin_a - bin_b|| (bins raster-ordered)."""
    idx = torch.arange(spec.num_bins, device=device)
    ys, xs = idx // spec.xbin, idx % spec.xbin
    d = torch.hypot((xs[:, None] - xs[None, :]).float(),
                    (ys[:, None] - ys[None, :]).float())
    return spec.threshold - d


def _floordiv(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def _reps(spec: ScanMatchSpec, fix, length):
    """Symbol repeats per fixation, float: round(floor(ms) / temp_bin)
    (round half to even, as jnp.round), 0 beyond the length."""
    valid = torch.arange(fix.shape[-2], device=fix.device) < length[..., None]
    dur_ms = torch.floor(torch.clamp_min(fix[..., 2] * 1000.0, 0.0))
    return torch.where(valid, torch.round(dur_ms / spec.temp_bin), 0.0)


def quantize(spec: ScanMatchSpec, fix, length):
    """Fixations -> (symbols [..., max_symbols] int32, n_symbols [...]).

    Applies the reference clamping (negative -> 0, >=res -> res-1,
    truncate to int) and, when ``temp_bin`` != 0, repeats each symbol
    ``round(duration_ms / temp_bin)`` times (durations here are SECONDS
    and scaled by 1000 like the callers do).  Sequences longer than
    ``max_symbols`` are prefix-truncated.
    """
    x = torch.clamp(fix[..., 0], 0, spec.xres - 1).to(torch.int32)
    y = torch.clamp(fix[..., 1], 0, spec.yres - 1).to(torch.int32)
    bx = _floordiv(x * spec.xbin, spec.xres)
    by = _floordiv(y * spec.ybin, spec.yres)
    bins = (by * spec.xbin + bx).to(torch.int32)                  # [..., L]
    L = fix.shape[-2]
    k = torch.arange(spec.max_symbols, device=fix.device)
    if spec.temp_bin == 0:
        n = torch.clamp_max(length, spec.max_symbols).to(torch.int32)
        take = torch.clamp_max(k, L - 1).expand(*bins.shape[:-1], -1)
        return torch.gather(bins, -1, take), n
    reps = torch.clamp(_reps(spec, fix, length), 0,
                       spec.max_symbols).to(torch.int32)
    cum = torch.cumsum(reps, dim=-1)                              # [..., L]
    total = torch.clamp_max(cum[..., -1], spec.max_symbols).to(torch.int32)
    # symbol k belongs to fixation l = #{cum <= k}  (searchsorted right)
    src = (k[:, None] >= cum[..., None, :]).sum(dim=-1)           # [..., K]
    src = torch.clamp_max(src, L - 1)
    return torch.gather(bins, -1, src), total


def expansion_overflow(spec: ScanMatchSpec, fix, length):
    """True where a scanpath's TempBin symbol expansion exceeds the
    static ``max_symbols`` bound (where :func:`quantize` prefix-truncates
    it and the device score diverges from the host oracle)."""
    if spec.temp_bin == 0:
        return length > spec.max_symbols
    return _reps(spec, fix, length).sum(dim=-1) > spec.max_symbols


def nw_scores(sub, seq_a, len_a, seq_b, len_b):
    """Batched Needleman-Wunsch alignment scores with gap value 0 over a
    substitution table ``sub``.  seq_a: [B, Ta] int, len_a: [B]; likewise
    seq_b.  Returns [B] float32 scores maxF / (max(sub) * max(len_a,
    len_b)); 0/0 -> nan like the reference (scanmatch.py:190-193)."""
    b, ta = seq_a.shape
    tb = seq_b.shape[1]
    dev = seq_a.device
    s_full = sub[seq_a.long()[:, :, None], seq_b.long()[:, None, :]]
    col_ok = torch.arange(tb, device=dev) < len_b[:, None]
    prev = torch.zeros(b, tb, device=dev)
    max_f = torch.zeros(b, device=dev)
    for i in range(ta if tb else 0):
        ok = col_ok & (i < len_a)[:, None]
        s_row = torch.where(ok, s_full[:, i], -_BIG)
        diag = torch.nn.functional.pad(prev[:, :-1], (1, 0))
        cand = torch.maximum(diag + s_row, prev)
        # F[i,0] = 0 boundary enters as the floor of the running max.
        prev = torch.cummax(cand, dim=1).values.clamp_min(0.0)
        max_f = torch.maximum(max_f, prev.amax(dim=1))
    scale = sub.max() * torch.maximum(len_a, len_b).float()
    return torch.where(scale > 0, max_f / scale, torch.nan)


def scanmatch_scores(spec: ScanMatchSpec, fix_a, len_a, fix_b, len_b):
    """End-to-end batched ScanMatch: quantize + align through
    ``ops/nw.py``.  fix_*: [B, L, 3]."""
    sa, na = quantize(spec, fix_a, len_a)
    sb, nb = quantize(spec, fix_b, len_b)
    return nw.nw_scores_bins(spec.threshold, spec.xbin, spec.ybin,
                             sa.contiguous(), na.contiguous(),
                             sb.contiguous(), nb.contiguous())


# ---------------------------------------------------------------------------
# SED (Levenshtein over 5x5-grid strings)
# ---------------------------------------------------------------------------

def sed_symbols(fix, height: int = 240, width: int = 320, n: int = 5):
    """Reference letter mapping (visual_attention_metrics.py:288-298)."""
    wstep, hstep = width // n, height // n
    x = fix[..., 0].to(torch.int32)
    y = fix[..., 1].to(torch.int32)
    return _floordiv(x, wstep) + _floordiv(y, hstep) * n


def levenshtein(sym_a, len_a, sym_b, len_b):
    """Batched Levenshtein distance.  sym_*: [B, L] int.  Returns [B]
    int32 D[len_a, len_b] of the padded DP."""
    b, ta = sym_a.shape
    tb = sym_b.shape[1]
    dev = sym_a.device
    jb = torch.arange(1, tb + 1, dtype=torch.int32, device=dev)
    prev = torch.arange(tb + 1, dtype=torch.int32, device=dev).expand(b, -1)
    rows = [prev]
    for i in range(1, ta + 1):
        neq = (sym_b != sym_a[:, i - 1:i]).to(torch.int32)
        cand = torch.minimum(prev[:, :-1] + neq, prev[:, 1:] + 1)
        base = cand - jb
        base[:, 0] = torch.clamp_max(base[:, 0], i)
        tail = torch.cummin(base, dim=1).values + jb
        prev = torch.cat([torch.full((b, 1), i, dtype=torch.int32,
                                     device=dev), tail], dim=1)
        rows.append(prev)
    table = torch.stack(rows, dim=1)                   # [B, Ta+1, Tb+1]
    ia = torch.clamp(len_a.long(), 0, ta)
    ib = torch.clamp(len_b.long(), 0, tb)
    return table[torch.arange(b, device=dev), ia, ib].to(torch.int32)


def sed_scores(fix_a, len_a, fix_b, len_b, height: int = 240,
               width: int = 320):
    return levenshtein(sed_symbols(fix_a, height, width), len_a,
                       sed_symbols(fix_b, height, width), len_b)


# ---------------------------------------------------------------------------
# STDE (scaled time-delay-embedding similarity)
# ---------------------------------------------------------------------------

def stde_scores(fix_h, len_h, fix_s, len_s, height: int = 240,
                width: int = 320):
    """Batched STDE (reference visual_attention_metrics.py:393-441).

    fix_h (human) and fix_s (simulated): [B, L, 3].  Returns [B] float32;
    nan when either length is 0 (reference returns None).
    """
    max_dim = float(max(height, width))
    lh, ls = fix_h.shape[-2], fix_s.shape[-2]
    dev = fix_h.device
    h = fix_h[..., :2] / max_dim
    s = fix_s[..., :2] / max_dim
    # c[b, i, j] = ||s_i - h_j||
    c = torch.hypot(s[:, :, None, 0] - h[:, None, :, 0],
                    s[:, :, None, 1] - h[:, None, :, 1])     # [B, ls, lh]
    max_k = torch.minimum(len_h, len_s)
    w = c
    acc = torch.zeros(c.shape[0], device=dev)
    ar_s = torch.arange(ls, device=dev)
    ar_h = torch.arange(lh, device=dev)
    for k in range(1, min(lh, ls) + 1):
        # w holds the window sums of length k (built incrementally)
        i_ok = ar_s < (len_s - k + 1)[:, None]                # [B, ls]
        j_ok = ar_h < (len_h - k + 1)[:, None]                # [B, lh]
        wm = torch.where(j_ok[:, None, :], w, _BIG)
        mins = wm.amin(dim=2) / float(k)
        sk = torch.where(i_ok, mins, 0.0).sum(dim=1) / torch.clamp_min(
            i_ok.sum(dim=1), 1).float()
        acc = acc + torch.where(k <= max_k, torch.exp(-sk), 0.0)
        # extend windows: w'[i, j] = w[i, j] + c[i+k, j+k]
        w = w + torch.roll(c, shifts=(-k, -k), dims=(1, 2))
    return torch.where(max_k > 0, acc / torch.clamp_min(max_k, 1).float(),
                       torch.nan)


# ---------------------------------------------------------------------------
# MultiMatch (Jarodzka alignment)
# ---------------------------------------------------------------------------

def _mm_align_table(m):
    """Min-cost monotone-path DP over a padded lattice, batched.

    D[i, j] = M[i, j] + min(D[i-1, j], D[i-1, j-1], D[i, j-1]), D[0, 0]=0
    (the start node's cost is excluded — host `_align` semantics).  The
    in-row dependency is removed with a min-plus prefix scan:
    D[i, j] = P[j] + cummin_k(U[k] - P[k-1]) where P = cumsum(M[i, :])
    and U[k] = min(D[i-1, k], D[i-1, k-1]).  m: [B, A, Bm]; returns the
    full [B, A, Bm] table.
    """
    prev = torch.cumsum(m[:, 0], dim=1) - m[:, 0, :1]
    rows = [prev]
    for r in range(1, m.shape[1]):
        p = torch.cumsum(m[:, r], dim=1)
        p_shift = torch.nn.functional.pad(p[:, :-1], (1, 0))
        diag = torch.nn.functional.pad(prev[:, :-1], (1, 0), value=_BIG)
        u = torch.minimum(prev, diag)
        prev = p + torch.cummin(u - p_shift, dim=1).values
        rows.append(prev)
    return torch.stack(rows, dim=1)


def _mm_traceback(table, na, nb, max_path: int):
    """Walk the DP table back from (na-1, nb-1) to (0, 0), preferring
    diagonal, then up, then left on ties (the host `_align` tie order).
    Returns (cells [B, max_path, 2] int64, valid [B, max_path] bool) —
    cells are emitted end-first and include both endpoints.

    Ties are detected with a tolerance scaled to the LOCAL cell
    magnitude, ``16 eps (|best| + 1)``: `_mm_align_table`'s min-plus
    prefix scan reassociates the cost sums (cumsum then cummin), so two
    EXACTLY tied alignments — common for decoded scanpaths, where
    repeated saccades make whole DP columns identical — land a few ulps
    apart in the float32 table, and a raw <= would break the tie by
    rounding noise instead of by the host's diag > up > left order
    (``jax_metrics._mm_traceback`` gives the full account)."""
    bsz, a, bm = table.shape
    dev = table.device
    eps16 = 16 * torch.finfo(table.dtype).eps
    flat = table.reshape(bsz, a * bm)
    ar = torch.arange(bsz, device=dev)

    def at(i, j, ok):
        v = flat[ar, (torch.clamp_min(i, 0) * bm + torch.clamp_min(j, 0))]
        return torch.where(ok, v, _BIG)

    i, j = na.long() - 1, nb.long() - 1
    done = torch.zeros(bsz, dtype=torch.bool, device=dev)
    cells, valid = [], []
    for _ in range(max_path):
        cells.append(torch.stack([i, j], dim=-1))
        valid.append(~done)
        d_diag = at(i - 1, j - 1, (i > 0) & (j > 0))
        d_up = at(i - 1, j, i > 0)
        d_left = at(i, j - 1, j > 0)
        best = torch.minimum(d_diag, torch.minimum(d_up, d_left))
        tol = eps16 * (best.abs() + 1)
        take_diag = d_diag <= best + tol
        take_up = ~take_diag & (d_up <= best + tol)
        ni = torch.where(take_diag | take_up, i - 1, i)
        nj = torch.where(take_diag | ~take_up, j - 1, j)
        done = done | ((i == 0) & (j == 0))
        i = torch.where(done, i, ni)
        j = torch.where(done, j, nj)
    return torch.stack(cells, dim=1), torch.stack(valid, dim=1)


def _masked_median(vals, valid):
    """numpy-median semantics over the masked entries of the last axis
    (nan propagates)."""
    has_nan = (valid & torch.isnan(vals)).any(dim=-1)
    v = torch.sort(torch.where(valid & ~torch.isnan(vals), vals, _BIG),
                   dim=-1).values
    cnt = valid.sum(dim=-1)
    lo = torch.clamp_min(_floordiv(cnt - 1, 2), 0)
    hi = torch.clamp_min(_floordiv(cnt, 2), 0)
    med = 0.5 * (v.gather(-1, lo[..., None])[..., 0]
                 + v.gather(-1, hi[..., None])[..., 0])
    return torch.where(has_nan | (cnt == 0), torch.nan, med)


def multimatch_scores(fix_a, len_a, fix_b, len_b, xres: int = 320,
                      yres: int = 240):
    """Batched MultiMatch (vector, direction, length, position, duration)
    similarities; [B, 5].  nan rows where either scanpath has < 3
    fixations — the host `metrics.multimatch.docomparison` contract."""
    amax, bmax = fix_a.shape[-2] - 1, fix_b.shape[-2] - 1
    max_path = amax + bmax
    diag = math.hypot(float(xres), float(yres))
    a, b = fix_a, fix_b
    ax, ay, adur = a[:, :-1, 0], a[:, :-1, 1], a[:, :-1, 2]
    bx, by, bdur = b[:, :-1, 0], b[:, :-1, 1], b[:, :-1, 2]
    adx, ady = a[:, 1:, 0] - a[:, :-1, 0], a[:, 1:, 1] - a[:, :-1, 1]
    bdx, bdy = b[:, 1:, 0] - b[:, :-1, 0], b[:, 1:, 1] - b[:, :-1, 1]
    atheta = torch.atan2(ady, adx)
    btheta = torch.atan2(bdy, bdx)
    arho = torch.hypot(adx, ady)
    brho = torch.hypot(bdx, bdy)

    m = torch.hypot(adx[:, :, None] - bdx[:, None, :],
                    ady[:, :, None] - bdy[:, None, :])     # [B, amax, bmax]
    na = torch.clamp(len_a - 1, 1, amax)
    nb = torch.clamp(len_b - 1, 1, bmax)
    cells, valid = _mm_traceback(_mm_align_table(m), na, nb, max_path)
    ci, cj = cells[..., 0], cells[..., 1]

    def g(t, idx):
        return torch.gather(t, 1, idx)

    vec = m[torch.arange(m.shape[0], device=m.device)[:, None], ci, cj]
    two_pi = 2 * math.pi
    ta = torch.remainder(g(atheta, ci) + two_pi, two_pi)
    tb = torch.remainder(g(btheta, cj) + two_pi, two_pi)
    dth = (ta - tb).abs()
    ang = torch.where(dth > math.pi, two_pi - dth, dth)
    ln = (g(arho, ci) - g(brho, cj)).abs()
    pos = torch.hypot(g(ax, ci) - g(bx, cj), g(ay, ci) - g(by, cj))
    ad, bd = g(adur, ci), g(bdur, cj)
    denom = torch.maximum(ad, bd)
    dur = torch.where(denom > 0, (ad - bd).abs() / denom, torch.nan)

    sims = torch.stack([
        1.0 - _masked_median(vec, valid) / (2 * diag),
        1.0 - _masked_median(ang, valid) / math.pi,
        1.0 - _masked_median(ln, valid) / diag,
        1.0 - _masked_median(pos, valid) / diag,
        1.0 - _masked_median(dur, valid),
    ], dim=-1)
    ok = (len_a >= 3) & (len_b >= 3)
    return torch.where(ok[:, None], sims, torch.nan)


# ---------------------------------------------------------------------------
# Pair-sweep helpers (sample x subject grids for rewards / validation)
# ---------------------------------------------------------------------------

def scanmatch_pair_grid(spec_wd: ScanMatchSpec, spec_wod: ScanMatchSpec,
                        gt_fix, gt_len, gt_mask, pred_fix, pred_len):
    """Score every (GT subject, prediction) pair of a batch.

    gt_fix: [N, S, L, 3], gt_len: [N, S], gt_mask: [N, S] (1 = real
    subject), pred_fix: [N, L, 3], pred_len: [N].
    Returns (wod [N, S], wd [N, S]) score grids (garbage where mask==0).
    """
    n, s = gt_fix.shape[:2]
    gt_flat = gt_fix.reshape(n * s, *gt_fix.shape[2:])
    gt_len_flat = gt_len.reshape(n * s)
    pred_rep = torch.repeat_interleave(pred_fix, s, dim=0)
    pred_len_rep = torch.repeat_interleave(pred_len, s, dim=0)
    wd = scanmatch_scores(spec_wd, gt_flat, gt_len_flat, pred_rep,
                          pred_len_rep)
    wod = scanmatch_scores(spec_wod, gt_flat, gt_len_flat, pred_rep,
                           pred_len_rep)
    return wod.reshape(n, s), wd.reshape(n, s)
