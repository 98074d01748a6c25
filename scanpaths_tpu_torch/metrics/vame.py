"""Host (numpy) VAME scanpath metrics: string edit distance (SED) and
scaled time-delay-embedding similarity (STDE).

Independent vectorized implementations of the protocol used by the
reference evaluation (behavioural contract:
OSIE/utils/evaltools/visual_attention_metrics.py:236-441):

SED: each fixation (x, y) maps to one of n*n grid letters via
``x // (width//n) + (y // (height//n)) * n`` on the stimulus size
(240x320 everywhere in this framework, n=5), and the score is the plain
Levenshtein distance between the two letter strings (substitution cost 1).

STDE: coordinates are scaled by the maximum stimulus dimension; for each
k in 1..min(len1, len2) the time-delay-embedding distance is computed
(for every length-k window of the simulated path, the minimum over human
windows of the summed pointwise euclidean distance, divided by k; then
averaged over simulated windows), and the final score is the mean over k
of exp(-distance).

The port's own copy of ``scanpaths_tpu/metrics/vame.py``
(the port imports nothing of the JAX package); keep the two identical.
"""

from __future__ import annotations

import numpy as np


def _levenshtein_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Levenshtein distance between two symbol arrays, vectorized rows.

    Row recurrence D[i,j] = min(D[i-1,j]+1, D[i,j-1]+1, D[i-1,j-1]+neq)
    computed with a min-plus prefix scan for the left dependency:
    D[i,j] = min(cand[j] - j, min_{k<j}(D[i,k] ... )) — since all left
    steps cost exactly +1, D[i,j] = min over k<=j of cand[k] + (j-k),
    i.e. a running minimum of cand[k] - k.
    """
    n, m = len(a), len(b)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = np.arange(m + 1, dtype=np.int64)
    js = np.arange(1, m + 1, dtype=np.int64)
    for i in range(1, n + 1):
        neq = (b != a[i - 1]).astype(np.int64)
        cand = np.minimum(prev[:-1] + neq, prev[1:] + 1)
        base = cand - js
        base[0] = min(base[0], i)  # seed D[i,0] = i at j offset 0
        cur = np.empty(m + 1, dtype=np.int64)
        cur[0] = i
        cur[1:] = np.minimum.accumulate(base) + js
        prev = cur
    return int(prev[m])


def scanpath_to_string(scanpath: np.ndarray, height: int, width: int,
                       n: int = 5) -> np.ndarray:
    """Quantize [L,>=2] (x, y) fixations to grid-letter symbols.

    Same cell arithmetic as the reference (visual_attention_metrics.py:288-298):
    symbol = x // (width//n) + (y // (height//n)) * n on int-truncated coords.
    """
    fix = np.asarray(scanpath)[:, :2].astype(np.int32)
    wstep, hstep = width // n, height // n
    return (fix[:, 0] // wstep + (fix[:, 1] // hstep) * n).astype(np.int64)


def string_edit_distance(stimulus, human_scanpath, simulated_scanpath,
                         n: int = 5) -> int:
    """SED between two scanpaths on the given stimulus (HxWx3 array or
    (H, W) shape tuple)."""
    shape = stimulus if isinstance(stimulus, tuple) else np.shape(stimulus)
    height, width = shape[0], shape[1]
    s1 = scanpath_to_string(human_scanpath, height, width, n)
    s2 = scanpath_to_string(simulated_scanpath, height, width, n)
    return _levenshtein_distance(s1, s2)


def _tde_distance(human: np.ndarray, simulated: np.ndarray, k: int) -> float:
    """Time-delay-embedding distance for one window length k.

    ``human``/``simulated`` are [L,2] scaled coordinate arrays.
    """
    # Pairwise pointwise distances C[i, j] = ||sim[i] - hum[j]||.
    c = np.hypot(simulated[:, None, 0] - human[None, :, 0],
                 simulated[:, None, 1] - human[None, :, 1])
    ns, nh = len(simulated) - k + 1, len(human) - k + 1
    # Window sums along diagonals: W[i, j] = sum_{t<k} C[i+t, j+t].
    w = np.zeros((ns, nh))
    for t in range(k):
        w += c[t:t + ns, t:t + nh]
    # For each simulated window: min over human windows, divided by k.
    return float(np.mean(w.min(axis=1) / k))


def scaled_time_delay_embedding_similarity(human_scanpath, simulated_scanpath,
                                           image) -> float:
    """STDE similarity (reference visual_attention_metrics.py:393-441)."""
    shape = image if isinstance(image, tuple) else np.shape(image)
    max_dim = float(max(shape))
    hum = np.asarray(human_scanpath, dtype=np.float64)[:, :2] / max_dim
    sim = np.asarray(simulated_scanpath, dtype=np.float64)[:, :2] / max_dim
    max_k = min(len(hum), len(sim))
    if max_k == 0:
        return None
    sims = [np.exp(-_tde_distance(hum, sim, k)) for k in range(1, max_k + 1)]
    return float(np.mean(sims))


# ---------------------------------------------------------------------------
# Saliency-map metrics (reference visual_attention_metrics.py:41-191).
# Unused by the training/eval pipeline (the reference imports but never
# calls them); kept so the metric surface matches the reference.
# ---------------------------------------------------------------------------

def auc_judd(saliency_map, fixation_map, jitter: bool = True,
             rng: np.random.Generator | None = None) -> float:
    """AUC-Judd: ROC area sweeping thresholds over the saliency values at
    fixated locations (reference visual_attention_metrics.py:41-133).

    ``fixation_map`` is a binary matrix of the same shape; returns nan
    when it has no fixations.  ``rng`` seeds the tie-breaking jitter
    (the reference uses the global numpy RNG).
    """
    s = np.asarray(saliency_map, dtype=np.float64)
    f = np.asarray(fixation_map)
    if not f.any():
        return float("nan")
    assert s.shape == f.shape, "resize the saliency map to the fixation map"
    if jitter:
        rng = rng or np.random.default_rng()
        s = s + rng.random(s.shape) / 1e7
    s = (s - s.min()) / (s.max() - s.min())
    if np.isnan(s).all():
        return float("nan")

    sv = s.ravel()
    fv = f.ravel()
    sth = np.sort(sv[fv > 0])[::-1]        # thresholds, descending
    n_fix = len(sth)
    n_pix = len(sv)
    # vectorized sweep: #(values >= thresh) per threshold
    above = n_pix - np.searchsorted(np.sort(sv), sth, side="left")
    tp = np.concatenate([[0.0], (np.arange(n_fix) + 1) / n_fix, [1.0]])
    fp = np.concatenate([[0.0], (above - np.arange(n_fix))
                         / (n_pix - n_fix), [1.0]])
    return float(np.trapezoid(tp, x=fp))


def kl_div(saliency_map, fixation_map) -> float:
    """KL divergence between the maps as distributions (reference
    visual_attention_metrics.py:136-163)."""
    a = np.asarray(saliency_map, dtype=np.float64)
    b = np.asarray(fixation_map, dtype=np.float64)
    assert a.shape == b.shape, "resize the saliency map to the fixation map"
    if a.any():
        a = a / a.sum()
    if b.any():
        b = b / b.sum()
    eps = 1e-12
    return float((b * np.log(eps + b / (a + eps))).sum())


def nss(saliency_map, fixation_map) -> float:
    """Normalized scanpath saliency: mean z-scored saliency at fixated
    locations (reference visual_attention_metrics.py:166-191; note the
    reference z-scores with ddof=1)."""
    s = np.asarray(saliency_map, dtype=np.float64)
    f = np.asarray(fixation_map)
    if not f.any():
        return float("nan")
    assert s.shape == f.shape, "resize the saliency map to the fixation map"
    if s.max() != 0:
        s = s / s.max()
    if s.std(ddof=1) != 0:
        s = (s - s.mean()) / s.std(ddof=1)
    return float(s[f.astype(bool)].mean())
