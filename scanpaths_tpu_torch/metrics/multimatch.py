"""Host MultiMatch scanpath comparison (Jarodzka et al. 2010, Dewhurst
et al. 2012).

The reference framework consumes the external ``multimatch_gaze``
package via ``docomparison(fix_vector_1, fix_vector_2, screensize=[320,240])``
(reference OSIE/utils/evaluation.py:38) with no simplification
(grouping off).  That package is not vendored here (and cannot be
pip-installed in the offline build environment); this module is an
independent implementation of the published algorithm.  Parity
evidence (tests/test_multimatch_parity.py): a second clean-room
implementation that mirrors the package's own computation route
(lattice graph + heap Dijkstra, tests/mm_oracle.py) agrees with this
module to float precision on 300+ random and grid-quantized pairs,
the alignment is proven optimal by exhaustive enumeration, and the
worst-case tie-breaking sensitivity on grid data is measured at
~1/300 pairs x <=0.09 on one column (~3e-4 effect on the averaged
metrics the reference reports — two orders below the 1% parity
budget).  Algorithm:

1. if either scanpath has fewer than 3 fixations, return [nan]*5;
2. build saccade vectors between consecutive fixations;
3. align the two saccade sequences with a shortest path through the
   lattice of vector-difference magnitudes (edges go right, down and
   diagonal; entering node (i, j) costs M[i, j]);
4. along the aligned path compute five difference series —
   vector (magnitude of saccade-vector difference), direction (wrapped
   angular difference), length (saccade-amplitude difference), position
   (distance between fixation positions), duration (relative fixation
   duration difference);
5. take the median of each series and normalize to a similarity in
   [0, 1]: vector by 2*screen diagonal, direction by pi, length and
   position by the screen diagonal, duration is already relative.

Returned order matches the package: [vector, direction, length,
position, duration].

The port's own copy of ``scanpaths_tpu/metrics/multimatch.py``
(the port imports nothing of the JAX package); keep the two identical.
"""

from __future__ import annotations

import math

import numpy as np


def _scanpath_structure(fix: np.ndarray):
    """[L,3] (x, y, dur) -> dict of fixation and saccade series."""
    x, y, dur = fix[:, 0], fix[:, 1], fix[:, 2]
    lenx = np.diff(x)
    leny = np.diff(y)
    return {
        "fix_x": x, "fix_y": y, "fix_dur": dur,
        "sac_x": x[:-1], "sac_y": y[:-1],
        "sac_lenx": lenx, "sac_leny": leny,
        "sac_theta": np.arctan2(leny, lenx),
        "sac_rho": np.hypot(lenx, leny),
    }


def _vector_difference_matrix(s1, s2) -> np.ndarray:
    """M[i, j] = || saccade_i(1) - saccade_j(2) || over vector components."""
    dx = s1["sac_lenx"][:, None] - s2["sac_lenx"][None, :]
    dy = s1["sac_leny"][:, None] - s2["sac_leny"][None, :]
    return np.hypot(dx, dy)


def _align(m: np.ndarray) -> list[tuple[int, int]]:
    """Minimum-cost monotone path through the lattice from (0, 0) to
    (n-1, m-1); moves are right, down, diagonal; entering (i, j) costs
    m[i, j].  Ties prefer the predecessor with the smallest distance,
    then row-major order (emulating a Dijkstra with first-set-wins
    relaxation)."""
    n, k = m.shape
    dist = np.full((n, k), np.inf)
    dist[0, 0] = 0.0
    prev = np.full((n, k, 2), -1, dtype=np.int64)
    for i in range(n):
        for j in range(k):
            if i == 0 and j == 0:
                continue
            best = None
            for pi, pj in ((i - 1, j - 1), (i - 1, j), (i, j - 1)):
                if pi < 0 or pj < 0:
                    continue
                cand = dist[pi, pj] + m[i, j]
                key = (cand, dist[pi, pj], pi * k + pj)
                if best is None or key < best[0]:
                    best = (key, (pi, pj))
            dist[i, j] = best[0][0]
            prev[i, j] = best[1]
    path = [(n - 1, k - 1)]
    while path[-1] != (0, 0):
        i, j = path[-1]
        path.append(tuple(prev[i, j]))
    return path[::-1]


def _wrapped_angle_diff(t1: float, t2: float) -> float:
    a, b = (t1 + 2 * math.pi) % (2 * math.pi), (t2 + 2 * math.pi) % (2 * math.pi)
    d = abs(a - b)
    return 2 * math.pi - d if d > math.pi else d


def docomparison(fixation_vector1, fixation_vector2, screensize=(320, 240)):
    """Compare two fixation vectors; returns a 5-list of similarities
    [vector, direction, length, position, duration] or [nan]*5 if either
    scanpath has fewer than 3 fixations."""
    f1 = _as_xy_dur(fixation_vector1)
    f2 = _as_xy_dur(fixation_vector2)
    if len(f1) < 3 or len(f2) < 3:
        return [np.nan] * 5
    s1, s2 = _scanpath_structure(f1), _scanpath_structure(f2)
    m = _vector_difference_matrix(s1, s2)
    path = _align(m)

    vec, ang, length, pos, dur = [], [], [], [], []
    for i, j in path:
        vec.append(m[i, j])
        ang.append(_wrapped_angle_diff(s1["sac_theta"][i], s2["sac_theta"][j]))
        length.append(abs(s1["sac_rho"][i] - s2["sac_rho"][j]))
        pos.append(math.hypot(s1["sac_x"][i] - s2["sac_x"][j],
                              s1["sac_y"][i] - s2["sac_y"][j]))
        d1, d2 = s1["fix_dur"][i], s2["fix_dur"][j]
        denom = max(d1, d2)
        dur.append(abs(d1 - d2) / denom if denom > 0 else np.nan)

    diag = math.hypot(screensize[0], screensize[1])
    return [
        1.0 - float(np.median(vec)) / (2 * diag),
        1.0 - float(np.median(ang)) / math.pi,
        1.0 - float(np.median(length)) / diag,
        1.0 - float(np.median(pos)) / diag,
        1.0 - float(np.median(dur)),
    ]


def _as_xy_dur(v) -> np.ndarray:
    """Accept structured fixation vectors or plain [L,3] arrays."""
    v = np.asarray(v)
    if v.dtype.names:
        return np.stack([v["start_x"], v["start_y"], v["duration"]], axis=-1)
    return v.astype(np.float64).reshape(-1, 3) if v.size else np.zeros((0, 3))
