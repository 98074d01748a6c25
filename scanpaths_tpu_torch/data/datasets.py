"""Task data: fixation JSON -> numpy batches (port of
``scanpaths_tpu/data/datasets.py``), with one task adapter per plugin:

* ``osie`` — free viewing (reference OSIE/dataset/dataset.py);
* ``air`` — VQA: a machine-attention map per question and the subjects'
  answer correctness (reference AiR/dataset/dataset.py);
* ``coco`` — visual search: the union of the target category's detector
  boxes as the attention map, and the category id (reference
  COCO_Search18/dataset/dataset.py).

:class:`SupervisedDataset` gives one training sample per subject: the
image, the soft target scanpath [T, H*W+1] (:func:`tensorize_scanpath`),
durations and masks, plus the task's conditioning.
:class:`EvaluationDataset` groups the records per image and carries all
subjects' ground truth, both as ragged host lists (``fix_vectors``, for
the host metric suite) and as padded arrays (``gt_fix`` [S, L, 3] with
durations in seconds, ``gt_len`` [S], ``gt_mask`` [S], for the device
sweep and the SCST reward, which reads it over the train split).  The
pad sizes come from the split, so no ground truth is cut: the subject
axis is the largest group, the fixation axis the longest scanpath.
:class:`Loader` batches either, in order or in a seeded shuffle.

Batches are assembled as the JAX package assembles them: with
``packed_cache_dir`` the images come from an on-disk packed uint8 store
(``data/packed_cache.py``), and when the host C++ library builds
(``native/``, g++ at first use) the scanpath tensorization and the packed
gather run in it, multi-threaded; both are bit-identical to the numpy
path, which runs where the library does not build or ``SP_NATIVE=0``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from os.path import join
from typing import Any

import numpy as np

from ..core.grid import fix_vector, pad_fix_vectors
from .transforms import load_image, resize_map

EPSILON = 1e-7

COCO_OBJECT_NAMES = [
    "bottle", "bowl", "car", "chair", "clock", "cup", "fork", "keyboard",
    "knife", "laptop", "microwave", "mouse", "oven", "potted plant", "sink",
    "stop sign", "toilet", "tv",
]


@dataclasses.dataclass
class DataConfig:
    img_dir: str
    fix_dir: str
    att_dir: str | None = None          # AiR attention maps / COCO detector dir
    action_map: tuple[int, int] = (30, 40)
    resize: tuple[int, int] = (240, 320)
    max_length: int = 16
    blur_sigma: float | None = None
    detector_threshold: float = 0.8     # COCO (reference COCO opts.py:15)
    coco_split: str = "split1"
    # floors for the pad sizes derived from the split
    max_subjects: int = 1               # floor for the subject axis
    gt_max_length: int = 1              # floor for the fixation axis
    cache_images: bool = True
    # on-disk packed image store (data/packed_cache.py), built on first
    # use; loads are bit-identical to the PIL path
    packed_cache_dir: str | None = None


def tensorize_scanpath(pos_x, pos_y, duration_ms, origin_hw, cfg: DataConfig,
                       clamp_to_grid: bool = False):
    """Ground-truth scanpath -> (target [T, H*W+1], duration [T],
    action_mask [T], duration_mask [T]): grid cells by integer division,
    ms -> s, a one-hot (optionally Gaussian-blurred) target per fixation,
    STOP one-hot at index 0 after the last, and the extra STOP-supervision
    step in ``action_mask`` (reference OSIE/dataset/dataset.py:68-102;
    the coordinate clamping of the COCO variant, COCO dataset.py:98-100,
    when ``clamp_to_grid``)."""
    mh, mw = cfg.action_map
    t_max = cfg.max_length
    oy, ox = origin_hw
    down_x = ox / mw
    down_y = oy / mh

    pos_x = np.asarray(pos_x, np.float32).copy()
    pos_y = np.asarray(pos_y, np.float32).copy()
    duration_ms = np.asarray(duration_ms, np.float32)
    if clamp_to_grid:
        pos_x[pos_x >= mw * down_x] = mw * down_x - 1
        pos_y[pos_y >= mh * down_y] = mh * down_y - 1

    target = np.zeros((t_max, mh * mw + 1), np.float32)
    duration = np.zeros(t_max, np.float32)
    action_mask = np.zeros(t_max, np.float32)
    duration_mask = np.zeros(t_max, np.float32)

    n = min(len(pos_x), t_max)
    xd = (pos_x[:n] / down_x).astype(np.int32)
    yd = (pos_y[:n] / down_y).astype(np.int32)
    duration[:n] = duration_ms[:n] / 1000.0
    action_mask[:n] = 1
    duration_mask[:n] = 1
    if n <= t_max - 1:
        action_mask[n] = 1  # extra STOP-supervision step

    for i in range(t_max):
        if i >= n:
            target[i, 0] = 1.0
        else:
            grid = np.zeros((mh, mw), np.float32)
            grid[yd[i], xd[i]] = 1.0
            if cfg.blur_sigma:
                import scipy.ndimage as filters
                grid = filters.gaussian_filter(grid, cfg.blur_sigma)
                grid /= grid.sum()
            target[i, 1:] = grid.reshape(-1)
    return target, duration, action_mask, duration_mask


class _ImageCache:
    def __init__(self, enabled: bool, packed=None):
        self.enabled = enabled
        self.packed = packed  # PackedImageCache | None
        self._cache: dict[str, np.ndarray] = {}

    def _read(self, path: str, hw) -> np.ndarray:
        if self.packed is not None:
            if self.packed.hw != tuple(hw):
                raise ValueError(f"packed store built at {self.packed.hw}, "
                                 f"requested {tuple(hw)}")
            return self.packed.load(path)
        return load_image(path, *hw)

    def load(self, path: str, hw) -> np.ndarray:
        if not self.enabled:
            return self._read(path, hw)
        if path not in self._cache:
            self._cache[path] = self._read(path, hw)
        return self._cache[path]

    def gather(self, paths: list[str], hw) -> np.ndarray:
        """[len(paths), H, W, 3] float32: the packed store's (native when
        the library is up) gather, else one load per path."""
        if self.packed is not None:
            return self.packed.gather(paths)
        return np.stack([self.load(p, hw) for p in paths])


def _make_image_cache(cfg: DataConfig, task, records: list[dict]):
    packed = None
    if cfg.packed_cache_dir:
        from .packed_cache import PackedImageCache
        packed = PackedImageCache(cfg.packed_cache_dir,
                                  [task.image_path(rec) for rec in records],
                                  cfg.resize)
    return _ImageCache(cfg.cache_images, packed)


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

    def extras(self, rec) -> dict:
        """Per-record conditioning tensors / labels."""
        return {}

    def clamp_to_grid(self) -> bool:
        return False


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


def _answered_right(rec) -> bool:
    """An AiR subject's answer correctness (reference
    AiR/dataset/dataset.py:149)."""
    return (rec["subject_answer"] == rec["answer"]
            and rec["subject_answer"] != "faild")


class AiRTask(TaskAdapter):
    """VQA: machine-attention map + answer correctness
    (reference AiR/dataset/dataset.py:20-210)."""

    name = "air"

    def load_records(self, split):
        with open(join(self.cfg.fix_dir, f"AiR_fixations_{split}.json")) as f:
            return json.load(f)

    def group_key(self, rec):
        return rec["question_id"]

    def image_path(self, rec):
        return join(self.cfg.img_dir, rec["image_id"])

    def origin_hw(self, rec):
        return rec["height"], rec["width"]

    def xyd_ms(self, rec):
        dur = (np.asarray(rec["T_end"], np.float32)
               - np.asarray(rec["T_start"], np.float32))
        return (np.asarray(rec["X"], np.float32),
                np.asarray(rec["Y"], np.float32), dur)

    def extras(self, rec):
        att = np.load(join(self.cfg.att_dir,
                           rec["question_id"] + ".npy")).astype(np.float32)
        att = resize_map(att, self.cfg.action_map)
        att = att / att.max()
        return {"attention_map": att[..., None],  # [mh, mw, 1] NHWC
                "performance": np.bool_(_answered_right(rec)),
                "question_id": rec["question_id"]}


class COCOTask(TaskAdapter):
    """Visual search: detector-bbox attention + 18 categories
    (reference COCO_Search18/dataset/dataset.py:24-212)."""

    name = "coco"
    origin = (320, 512)

    def __init__(self, cfg: DataConfig):
        super().__init__(cfg)
        self.name2int = {n: i for i, n in enumerate(COCO_OBJECT_NAMES)}
        det_file = join(cfg.att_dir or cfg.fix_dir,
                        "coco_search18_detector.json")
        self.imgs_2_det: dict[str, list] = {}
        if os.path.exists(det_file):
            with open(det_file) as f:
                detector = json.load(f)
            for det in detector:
                if (det["category"] in self.name2int
                        and det["score"] >= cfg.detector_threshold):
                    self.imgs_2_det.setdefault(det["image_id"], []).append(det)

    def load_records(self, split):
        fn = f"coco_search18_fixations_TP_{split}_{self.cfg.coco_split}.json"
        with open(join(self.cfg.fix_dir, fn)) as f:
            return json.load(f)

    def group_key(self, rec):
        return (rec["task"], rec["name"])

    def image_path(self, rec):
        return join(self.cfg.img_dir, rec["task"], rec["name"])

    def origin_hw(self, rec):
        return self.origin

    def clamp_to_grid(self):
        return True

    def extras(self, rec):
        image_id = rec["name"].split(".")[0]
        # the union of the target category's detector boxes in the
        # recorded origin frame, then an antialiased resize to the action
        # map (reference COCO dataset.py:150-160)
        det_h = rec.get("det_height", self.origin[0])
        det_w = rec.get("det_width", self.origin[1])
        att = np.zeros((det_h, det_w), np.float32)
        for det in self.imgs_2_det.get(image_id, []):
            if det["category"] == rec["task"]:
                x0, y0, x1, y1 = (int(det["bbox"][0]), int(det["bbox"][1]),
                                  int(det["bbox"][2]), int(det["bbox"][3]))
                att[y0:y1, x0:x1] = 1.0
        att = resize_map(att, self.cfg.action_map)
        att = att / (att.max() + EPSILON)
        return {"attention_map": att[..., None],
                "task": np.int32(self.name2int[rec["task"]]),
                "task_name": rec["task"]}


TASKS = {"osie": OSIETask, "air": AiRTask, "coco": COCOTask}


def make_task(task: str | TaskAdapter, cfg: DataConfig) -> TaskAdapter:
    if isinstance(task, TaskAdapter):
        return task
    if task not in TASKS:
        raise ValueError(f"task {task!r}: one of {sorted(TASKS)}")
    return TASKS[task](cfg)


class SupervisedDataset:
    """Per-subject supervised samples."""

    def __init__(self, task: str | TaskAdapter, cfg: DataConfig,
                 split: str = "train"):
        self.cfg = cfg
        self.task = make_task(task, cfg)
        self.records = self.task.load_records(split)
        self._images = _make_image_cache(cfg, self.task, self.records)
        self._blur_rows = None  # [mh*mw, mh*mw] blur table (native path)

    def __len__(self):
        return len(self.records)

    def __getitem__(self, idx: int) -> dict:
        rec = self.records[idx]
        x, y, dur = self.task.xyd_ms(rec)
        target, duration, amask, dmask = tensorize_scanpath(
            x, y, dur, self.task.origin_hw(rec), self.cfg,
            clamp_to_grid=self.task.clamp_to_grid())
        out = {
            "image": self._images.load(self.task.image_path(rec),
                                       self.cfg.resize),
            "target_scanpath": target,
            "duration": duration,
            "action_mask": amask,
            "duration_mask": dmask,
            "img_name": os.path.basename(self.task.image_path(rec)),
        }
        out.update(self.task.extras(rec))
        return out

    def get_batch(self, indices) -> dict:
        """``collate([self[i] for i in indices])``: ``images``,
        ``scanpaths``, ``durations``, ``action_masks``,
        ``duration_masks``, ``img_names`` and the task's fields; the
        scanpath tensorization and the packed-image gather run in the
        native library when it is up (bit-identical)."""
        from .. import native

        if not native.available():
            return collate([self[int(i)] for i in indices])
        recs = [self.records[int(i)] for i in indices]
        xs, ys, ds, origins = [], [], [], []
        for rec in recs:
            x, y, d = self.task.xyd_ms(rec)
            xs.append(x), ys.append(y), ds.append(d)
            origins.append(self.task.origin_hw(rec))
        mh, mw = self.cfg.action_map
        if self.cfg.blur_sigma and self._blur_rows is None:
            self._blur_rows = native.make_blur_rows(mh, mw,
                                                    self.cfg.blur_sigma)
        target, duration, amask, dmask = native.tensorize_batch(
            xs, ys, ds, origins, self.cfg.max_length, mh, mw,
            clamp_to_grid=self.task.clamp_to_grid(),
            blur_rows=self._blur_rows)
        paths = [self.task.image_path(rec) for rec in recs]
        out = {"images": self._images.gather(paths, self.cfg.resize),
               "scanpaths": target, "durations": duration,
               "action_masks": amask, "duration_masks": dmask,
               "img_names": [os.path.basename(p) for p in paths]}
        extras = [self.task.extras(rec) for rec in recs]
        if extras and extras[0]:
            out.update(collate(extras))
        return out


class EvaluationDataset:
    """Per-group samples with all subjects' ground truth."""

    def __init__(self, task: str | TaskAdapter, cfg: DataConfig,
                 split: str = "validation"):
        self.cfg = cfg
        self.task = make_task(task, cfg)
        self.records = self.task.load_records(split)
        self._images = _make_image_cache(cfg, self.task, self.records)
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
        performances = []
        for rec in members:
            x, y, dur = self.task.xyd_ms(rec)
            length = rec.get("length", len(x))
            fix_vectors.append(fix_vector(
                (x / sx)[:length], (y / sy)[:length], (dur / 1000.0)[:length]))
            if self.task.name == "air":
                performances.append(_answered_right(rec))

        gt_fix, gt_len, gt_mask = pad_fix_vectors(
            fix_vectors, self.pad_gt_len, self.pad_subjects)
        path = self.task.image_path(rec0)
        out = {
            "fix_vectors": fix_vectors,
            "gt_fix": gt_fix, "gt_len": gt_len, "gt_mask": gt_mask,
            "img_name": os.path.basename(path),
        }
        out.update(self.task.extras(rec0))
        if self.task.name == "air":
            out["performances"] = performances
            perf_pad = np.zeros(self.pad_subjects, np.float32)
            perf_pad[:len(performances)] = np.asarray(performances, np.float32)
            out["gt_performance"] = perf_pad
        return out, path

    def __getitem__(self, idx: int) -> dict:
        out, path = self._sample_without_image(idx)
        out["image"] = self._images.load(path, self.cfg.resize)
        return out

    def get_batch(self, indices) -> dict:
        """``collate([self[i] for i in indices])``, the images through
        the packed store's gather when it is set."""
        samples, paths = zip(*(self._sample_without_image(int(i))
                               for i in indices))
        out = collate(list(samples))
        out["images"] = self._images.gather(list(paths), self.cfg.resize)
        return out


RAGGED_KEYS = ("fix_vectors", "performances", "img_name", "question_id",
               "task_name")

_PLURAL = {"image": "images", "target_scanpath": "scanpaths",
           "duration": "durations", "action_mask": "action_masks",
           "duration_mask": "duration_masks",
           "attention_map": "attention_maps",
           "img_name": "img_names", "performance": "performances",
           "task": "tasks", "question_id": "question_ids",
           "task_name": "task_names"}


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
    """Fixed-size batches of a dataset: in order, or in a shuffle seeded by
    ``seed`` plus the epoch (each pass over the loader is an epoch),
    optionally dropping the trailing partial batch.

    Several processes: each passes its ``process_index`` of
    ``process_count``; all draw the SAME shuffle from the shared seed and
    each loads its contiguous ``batch_size / process_count`` slice of
    every full batch (a trailing partial batch is loaded whole by every
    process).  ``len()`` counts the global batches."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False,
                 process_index: int = 0, process_count: int = 1):
        if process_count > 1 and batch_size % process_count:
            raise ValueError(f"batch_size {batch_size} must divide evenly "
                             f"over {process_count} processes")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        self.epoch += 1
        for start in range(0, n, self.batch_size):
            batch_idx = idx[start:start + self.batch_size]
            if self.drop_last and len(batch_idx) < self.batch_size:
                break
            if self.process_count > 1 and len(batch_idx) == self.batch_size:
                per = self.batch_size // self.process_count
                lo = self.process_index * per
                batch_idx = batch_idx[lo:lo + per]
            yield self.dataset.get_batch(batch_idx)
