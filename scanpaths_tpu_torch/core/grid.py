"""Grid geometry shared by the model, sampler and metrics.

The framework predicts fixations on a fixed 30x40 action grid over a
240x320 (HxW) input image (reference: AiR/models/sampling.py:5-14,
AiR/opts.py:10-13).  Action index 0 is the STOP token; indices 1..1200
raster-scan the grid row-major (reference: AiR/models/sampling.py:64-68).

The port's own copy of ``scanpaths_tpu/core/grid.py``
(the port imports nothing of the JAX package); keep the two identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Geometry of the action grid.

    Attributes mirror the reference Sampling object
    (AiR/models/sampling.py:5-14).
    """

    map_width: int = 40
    map_height: int = 30
    width: int = 320
    height: int = 240
    max_length: int = 16
    min_length: int = 1

    @property
    def num_cells(self) -> int:
        return self.map_width * self.map_height

    @property
    def num_actions(self) -> int:
        # +1 for the STOP action at index 0.
        return self.num_cells + 1

    @property
    def x_granularity(self) -> float:
        return float(self.width / self.map_width)

    @property
    def y_granularity(self) -> float:
        return float(self.height / self.map_height)

    def action_to_xy(self, action: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Map non-STOP action ids (1..HW) to pixel-center coordinates.

        Matches the reference decode (AiR/models/sampling.py:64-68):
        cell index = action - 1; x = (idx % W)*gx + gx/2, y = (idx // W)*gy + gy/2.
        """
        idx = np.asarray(action) - 1
        map_x = idx % self.map_width
        map_y = idx // self.map_width
        pos_x = map_x * self.x_granularity + self.x_granularity / 2
        pos_y = map_y * self.y_granularity + self.y_granularity / 2
        return pos_x, pos_y


DEFAULT_GRID = GridSpec()

FIX_DTYPE = np.dtype({"names": ("start_x", "start_y", "duration"),
                      "formats": ("f8", "f8", "f8")})


def fix_vector(xs, ys, ts) -> np.ndarray:
    """Build a structured fixation vector (the framework's host-side
    interchange format, same layout as the reference's
    AiR/models/sampling.py:73-75)."""
    out = np.empty(len(xs), dtype=FIX_DTYPE)
    out["start_x"] = xs
    out["start_y"] = ys
    out["duration"] = ts
    return out


def fix_vector_to_array(v: np.ndarray) -> np.ndarray:
    """Structured fixation vector -> plain [L,3] float array (x, y, dur)."""
    return np.stack([v["start_x"], v["start_y"], v["duration"]], axis=-1) \
        if len(v) else np.zeros((0, 3))


def pad_fix_vectors(vectors, max_len: int, max_subjects: int | None = None):
    """Pack a (possibly ragged) list of fixation vectors into padded arrays.

    Returns (data [S, max_len, 3], lengths [S]).  Fixations beyond
    ``max_len`` are truncated.  If ``max_subjects`` is given the subject
    axis is padded/truncated too and a subject-validity mask is returned.
    """
    n = len(vectors)
    s = max_subjects if max_subjects is not None else n
    data = np.zeros((s, max_len, 3), dtype=np.float32)
    lengths = np.zeros((s,), dtype=np.int32)
    for i, v in enumerate(vectors[:s]):
        arr = fix_vector_to_array(v)
        l = min(len(arr), max_len)
        data[i, :l] = arr[:l]
        lengths[i] = l
    if max_subjects is not None:
        mask = (np.arange(s) < n).astype(np.float32)
        return data, lengths, mask
    return data, lengths
