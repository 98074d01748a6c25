"""Host (numpy) ScanMatch oracle.

ScanMatch (Cristino et al. 2010) scores the similarity of two fixation
sequences by quantizing fixations onto a spatial grid, optionally
repeating symbols by temporal bins, and running a Needleman-Wunsch
global alignment with a distance-derived substitution matrix.

This is an independent, vectorized implementation of the protocol used
by the reference framework (see reference
OSIE/utils/evaltools/scanmatch.py:88-197 for the behavioural contract):

* substitution score between grid cells a=(ya,xa), b=(yb,xb) is
  ``Threshold - euclidean_bin_distance(a, b)`` (the reference builds the
  same values via ``abs(mat-max_sub) - (max_sub - Threshold)``,
  scanmatch.py:103),
* fixation (x, y) is clamped into the screen, offset-shifted, truncated
  to int, and mapped to bin ``(y*Ybin//Yres)*Xbin + (x*Xbin//Xres)``
  (scanmatch.py:105-124),
* if ``TempBin`` != 0 each symbol is repeated ``round(duration/TempBin)``
  times (scanmatch.py:126-131) — note a round to 0 drops the fixation,
* NW recurrence F[i,j] = max(F[i-1,j-1]+S[a,b], F[i-1,j]+Gap, F[i,j-1]+Gap)
  with boundary F[i,0] = Gap*(i+1) (the reference's off-by-one boundary,
  scanmatch.py:140-143, harmless when Gap==0),
* score = max(F) / (max(S) * max(len_a, len_b)) (scanmatch.py:188-193).

The standard configuration everywhere in the framework is
Xres=320, Yres=240, Xbin=16, Ybin=12, Threshold=3.5, Gap=0,
TempBin=50 (with-duration) or 0 (without) — reference AiR/train.py:216-218.

The inner DP is vectorized row-by-row: with gap value g,
F[i,j] = max(cand[j], F[i,j-1] + g) where cand[j] = max(diag, up); the
left-moving dependency is a max-plus prefix scan, computed as a running
maximum of cand[j] - g*j.

The port's own copy of ``scanpaths_tpu/metrics/scanmatch.py``
(the port imports nothing of the JAX package); keep the two identical.
"""

from __future__ import annotations

import numpy as np


class ScanMatch:
    """ScanMatch scorer.  API mirrors the reference object so the
    evaluation drivers read the same."""

    def __init__(self, Xres=1024, Yres=768, Xbin=8, Ybin=6, Threshold=3.5,
                 GapValue=0.0, TempBin=0.0, Offset=(0, 0)):
        self.Xres = Xres
        self.Yres = Yres
        self.Xbin = Xbin
        self.Ybin = Ybin
        self.Threshold = Threshold
        self.GapValue = GapValue
        self.TempBin = TempBin
        self.Offset = Offset
        self.SubMatrix = self._sub_matrix()

    def _sub_matrix(self) -> np.ndarray:
        """S[a, b] = Threshold - ||bin_a - bin_b||, bins indexed y*Xbin+x."""
        ys, xs = np.divmod(np.arange(self.Xbin * self.Ybin), self.Xbin)
        d = np.hypot(xs[:, None] - xs[None, :], ys[:, None] - ys[None, :])
        return self.Threshold - d

    def fixationToSequence(self, data: np.ndarray) -> np.ndarray:
        """Quantize an [L, >=2] (x, y[, duration_ms]) array to symbols."""
        d = np.array(data, dtype=np.float64, copy=True)
        d[:, :2] -= self.Offset
        d[d < 0] = 0
        d[d[:, 0] >= self.Xres, 0] = self.Xres - 1
        d[d[:, 1] >= self.Yres, 1] = self.Yres - 1
        d = d.astype(np.int64)
        # Same bin arithmetic as the reference's precomputed pixel mask:
        # mask[y, x] = (y*Ybin//Yres)*Xbin + x*Xbin//Xres.
        bx = d[:, 0] * self.Xbin // self.Xres
        by = d[:, 1] * self.Ybin // self.Yres
        seq = by * self.Xbin + bx
        if self.TempBin != 0:
            reps = np.round(d[:, 2] / float(self.TempBin)).astype(np.int64)
            seq = np.repeat(seq, np.maximum(reps, 0))
        return seq.astype(np.float64)

    def match(self, A, B):
        """Needleman-Wunsch alignment score of two symbol sequences.

        Returns (score, align, F) like the reference; ``align`` is the
        traceback alignment (not needed for the score, provided for API
        parity), ``F`` is the transposed DP table.
        """
        A = np.asarray(A, dtype=np.int64)
        B = np.asarray(B, dtype=np.int64)
        n, m = len(A), len(B)
        g = self.GapValue

        F = np.zeros((n + 1, m + 1))
        # Reference boundary quirk: Gap*(i+1) rather than Gap*i
        # (scanmatch.py:140-143).  Identical when g == 0.
        F[:, 0] = g * (np.arange(n + 1) + 1)
        F[0, :] = g * (np.arange(m + 1) + 1)
        F[0, 0] = g  # both loops write Gap*1 at (0,0)

        if n and m:
            S = self.SubMatrix[A][:, B]  # [n, m] substitution scores
            joff = g * np.arange(1, m + 1)
            for i in range(1, n + 1):
                cand = np.maximum(F[i - 1, :-1] + S[i - 1], F[i - 1, 1:] + g)
                # F[i,j] = max(cand[j], F[i,j-1]+g) is a max-plus prefix
                # scan: F[i,j] = max(F[i,0], max_{k<=j} cand[k]-g*k) + g*j.
                base = cand - joff
                base[0] = max(base[0], F[i, 0])
                F[i, 1:] = np.maximum.accumulate(base) + joff

        max_f = F.max()
        max_sub = self.SubMatrix.max()
        scale = max_sub * max(m, n)
        # Two empty sequences give 0/0 -> nan, like the reference
        # (scanmatch.py:190-193 divides unconditionally).
        score = max_f / scale if scale > 0 else float("nan")
        align = self._traceback(F, A, B) if (n and m) else np.zeros((0, 2))
        return score, align, F.T

    def _traceback(self, F, A, B):
        """Greedy traceback, prefer-diagonal then up (reference
        scanmatch.py:158-186).  Only used for the returned alignment."""
        n, m = len(A), len(B)
        g = self.GapValue
        ra, rb = [], []
        i, j = n, m
        while i > 0 and j > 0:
            if F[i, j] == F[i - 1, j - 1] + self.SubMatrix[A[i - 1], B[j - 1]]:
                ra.append(A[i - 1]); rb.append(B[j - 1]); i -= 1; j -= 1
            elif F[i, j] == F[i - 1, j] + g:
                ra.append(A[i - 1]); rb.append(-1); i -= 1
            else:
                ra.append(-1); rb.append(B[j - 1]); j -= 1
        while i > 0:
            ra.append(A[i - 1]); rb.append(-1); i -= 1
        while j > 0:
            ra.append(-1); rb.append(B[j - 1]); j -= 1
        return np.stack([ra[::-1], rb[::-1]], axis=1).astype(np.float64)


def make_scanmatch_pair(width: int = 320, height: int = 240,
                        temp_bin: float = 50.0):
    """The (with-duration, without-duration) scorer pair used throughout
    training and evaluation (reference AiR/train.py:216-218)."""
    wd = ScanMatch(Xres=width, Yres=height, Xbin=16, Ybin=12,
                   Offset=(0, 0), TempBin=temp_bin, Threshold=3.5)
    wod = ScanMatch(Xres=width, Yres=height, Xbin=16, Ybin=12,
                    Offset=(0, 0), Threshold=3.5)
    return wd, wod
