"""The evaluation split's data: fixation JSON -> numpy batches (port of
``scanpaths_tpu/data/datasets.py``, eval view, OSIE).

:class:`EvaluationDataset` groups the records per image and carries all
subjects' ground truth, both as ragged host lists (``fix_vectors``, for
the host metric suite) and as padded arrays (``gt_fix`` [S, L, 3] with
durations in seconds, ``gt_len`` [S], ``gt_mask`` [S], for the device
sweep).  The pad sizes come from the split, so no ground truth is cut:
the subject axis is the largest group, the fixation axis the longest
scanpath.  :class:`Loader` batches it in order in one process.

Only the OSIE task is ported, so the config holds only what its
evaluation split reads.  The supervised view waits for the training
slice; the packed image store and the native gather of the JAX package
are not carried over (``packed_cache_dir`` raises).
"""

from __future__ import annotations

import dataclasses
import json
import os
from os.path import join
from typing import Any

import numpy as np

from ..core.grid import fix_vector, pad_fix_vectors
from .transforms import load_image


@dataclasses.dataclass
class DataConfig:
    img_dir: str
    fix_dir: str
    resize: tuple[int, int] = (240, 320)
    # floors for the pad sizes derived from the split
    max_subjects: int = 1               # floor for the subject axis
    gt_max_length: int = 1              # floor for the fixation axis
    cache_images: bool = True
    packed_cache_dir: str | None = None  # not ported: raises if set


class _ImageCache:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._cache: dict[str, np.ndarray] = {}

    def load(self, path: str, hw) -> np.ndarray:
        if not self.enabled:
            return load_image(path, *hw)
        if path not in self._cache:
            self._cache[path] = load_image(path, *hw)
        return self._cache[path]


class TaskAdapter:
    """Task-specific record accessors; one subclass per task plugin."""

    name = "base"

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def load_records(self, split: str) -> list[dict]:
        raise NotImplementedError

    def group_key(self, rec) -> Any:
        raise NotImplementedError

    def image_path(self, rec) -> str:
        raise NotImplementedError

    def origin_hw(self, rec) -> tuple[int, int]:
        raise NotImplementedError

    def xyd_ms(self, rec):
        """(pos_x, pos_y, duration_ms) arrays of the record."""
        return (np.asarray(rec["X"], np.float32),
                np.asarray(rec["Y"], np.float32),
                np.asarray(rec["T"], np.float32))


class OSIETask(TaskAdapter):
    """Free viewing; no conditioning (reference OSIE/dataset/dataset.py:18-114)."""

    name = "osie"
    origin = (600, 800)

    def load_records(self, split):
        with open(join(self.cfg.fix_dir, f"osie_fixations_{split}.json")) as f:
            return json.load(f)

    def group_key(self, rec):
        return rec["name"]

    def image_path(self, rec):
        return join(self.cfg.img_dir, rec["name"])

    def origin_hw(self, rec):
        return self.origin


TASKS = {"osie": OSIETask}


def make_task(task: str | TaskAdapter, cfg: DataConfig) -> TaskAdapter:
    if isinstance(task, TaskAdapter):
        return task
    if task not in TASKS:
        raise NotImplementedError(
            f"task {task!r}: only the OSIE data is ported so far")
    return TASKS[task](cfg)


class EvaluationDataset:
    """Per-group samples with all subjects' ground truth."""

    def __init__(self, task: str | TaskAdapter, cfg: DataConfig,
                 split: str = "validation"):
        if cfg.packed_cache_dir:
            raise NotImplementedError(
                "packed_cache_dir: the packed image store is not ported")
        self.cfg = cfg
        self.task = make_task(task, cfg)
        self.records = self.task.load_records(split)
        self._images = _ImageCache(cfg.cache_images)
        self.groups: dict[Any, list[int]] = {}
        for i, rec in enumerate(self.records):
            self.groups.setdefault(self.task.group_key(rec), []).append(i)
        self.keys = list(self.groups.keys())

        # Pad sizes from the split (subject axis = largest group,
        # fixation axis = longest scanpath), and the symbol expansion
        # ScanMatch-with-duration needs (sum of round(dur_ms / 50) per
        # scanpath), which sizes the static NW table.
        self.pad_subjects = max(
            cfg.max_subjects,
            max((len(g) for g in self.groups.values()), default=1))
        max_len, wd_need = 1, 1
        for rec in self.records:
            x, _, dur = self.task.xyd_ms(rec)
            length = int(rec.get("length", len(x)))
            max_len = max(max_len, length)
            reps = np.round(np.floor(np.maximum(dur[:length], 0.0)) / 50.0)
            wd_need = max(wd_need, int(reps.sum()))
        self.pad_gt_len = max(cfg.gt_max_length, max_len)
        self.wd_symbols_needed = wd_need

    def __len__(self):
        return len(self.keys)

    def _sample_without_image(self, idx: int) -> tuple[dict, str]:
        """Everything but the image tensor, plus the image path."""
        key = self.keys[idx]
        members = [self.records[i] for i in self.groups[key]]
        rec0 = members[0]
        oy, ox = self.task.origin_hw(rec0)
        ry, rx = self.cfg.resize
        sx, sy = ox / rx, oy / ry

        fix_vectors = []
        for rec in members:
            x, y, dur = self.task.xyd_ms(rec)
            length = rec.get("length", len(x))
            fix_vectors.append(fix_vector(
                (x / sx)[:length], (y / sy)[:length], (dur / 1000.0)[:length]))

        gt_fix, gt_len, gt_mask = pad_fix_vectors(
            fix_vectors, self.pad_gt_len, self.pad_subjects)
        path = self.task.image_path(rec0)
        out = {
            "fix_vectors": fix_vectors,
            "gt_fix": gt_fix, "gt_len": gt_len, "gt_mask": gt_mask,
            "img_name": os.path.basename(path),
        }
        return out, path

    def __getitem__(self, idx: int) -> dict:
        out, path = self._sample_without_image(idx)
        out["image"] = self._images.load(path, self.cfg.resize)
        return out

    def get_batch(self, indices) -> dict:
        """``collate([self[i] for i in indices])``."""
        return collate([self[int(i)] for i in indices])


RAGGED_KEYS = ("fix_vectors", "img_name")

_PLURAL = {"image": "images", "img_name": "img_names"}


def collate(samples: list[dict]) -> dict:
    """Stack numeric fields to [N, ...] arrays; ragged fields to lists;
    pluralize key names (matches the reference collate_func)."""
    out: dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        name = _PLURAL.get(key, key)
        if key in RAGGED_KEYS:
            out[name] = vals
        else:
            out[name] = np.stack(vals)
    return out


class Loader:
    """Batches of an evaluation dataset in order, in one process; the
    last batch may be partial.  The training slice brings the seeded
    shuffle of the JAX package's Loader."""

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        for start in range(0, len(idx), self.batch_size):
            yield self.dataset.get_batch(idx[start:start + self.batch_size])
