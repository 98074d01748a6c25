"""On-disk packed image cache.

The reference re-decodes every JPEG through PIL in its DataLoader
workers each epoch (reference AiR/train.py:43-47 transform pipeline).
The in-RAM `_ImageCache` already avoids that within one process; this
module persists the decoded images ACROSS runs: one uint8 memmap of
shape [N, H, W, 3] holding the resized images plus a name->row JSON
index, built once and then served by O(1) slice reads with zero image
decoding.

Bit-fidelity: `load_image` resizes with PIL (whose output is uint8)
and only then converts to float and normalizes — so storing the
post-resize uint8 array and normalizing on read reproduces
`load_image` EXACTLY.

The store is keyed by the image-set fingerprint (sorted paths, their
sizes and mtimes, and the target geometry), so a changed dataset —
including in-place re-downloads under the same filenames — or a
changed resize automatically builds a new file instead of serving
stale rows.  Writes are atomic (tmp + rename) and row-streamed (O(1)
host memory); concurrent builders race benignly to the same content.

The port's own copy of ``scanpaths_tpu/data/packed_cache.py``
(the port imports nothing of the JAX package); keep the two identical.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np
from PIL import Image

from .transforms import IMAGENET_MEAN, IMAGENET_STD


class PackedImageCache:
    """Memmap-backed store of resized uint8 images.

    Parameters
    ----------
    cache_dir: directory for the .npy memmap + .json index.
    paths: every image file the dataset can request (deduplicated).
    hw: (height, width) resize target.
    """

    def __init__(self, cache_dir: str, paths: list[str],
                 hw: tuple[int, int]):
        self.hw = tuple(hw)
        self.paths = sorted(set(paths))
        stamp = "|".join(
            f"{p}:{st.st_size}:{st.st_mtime_ns}"
            for p, st in ((p, os.stat(p)) for p in self.paths))
        fp = hashlib.md5((stamp + f"@{self.hw}").encode()).hexdigest()[:16]
        os.makedirs(cache_dir, exist_ok=True)
        self._data_path = os.path.join(cache_dir, f"images_{fp}.npy")
        self._index_path = os.path.join(cache_dir, f"images_{fp}.json")
        if not (os.path.exists(self._data_path)
                and os.path.exists(self._index_path)):
            self._build()
            size = os.path.getsize(self._data_path)
            total = sum(
                os.path.getsize(os.path.join(cache_dir, f))
                for f in os.listdir(cache_dir) if f.startswith("images_"))
            print(f"[packed_cache] built {os.path.basename(self._data_path)}"
                  f" ({size / 1e9:.2f} GB); cache dir now {total / 1e9:.2f}"
                  " GB — stale stores from superseded fingerprints are"
                  " removed by PackedImageCache.prune()", file=sys.stderr)
        # mark the store as in-use so prune() keeps it (other fingerprints
        # in the same dir may belong to sibling splits, not staleness —
        # age since last open is the only safe eviction signal)
        now = time.time()
        os.utime(self._index_path, (now, now))
        os.utime(self._data_path, (now, now))
        with open(self._index_path) as f:
            self._row = json.load(f)
        self._mm = np.load(self._data_path, mmap_mode="r")

    @staticmethod
    def prune(cache_dir: str, keep_days: float = 30.0) -> list[str]:
        """Delete packed stores not opened for ``keep_days`` (every open
        touches the store's mtime).  Fingerprint mismatch alone is NOT
        staleness — sibling splits share the cache dir — so eviction is
        by age.  Returns the removed file names."""
        removed = []
        cutoff = time.time() - keep_days * 86400.0
        if not os.path.isdir(cache_dir):
            return removed
        for f in os.listdir(cache_dir):
            if not f.startswith("images_"):
                continue
            p = os.path.join(cache_dir, f)
            try:
                if os.path.getmtime(p) < cutoff:
                    os.remove(p)
                    removed.append(f)
            except OSError:
                pass
        return removed

    def _build(self):
        h, w = self.hw
        tmp = self._data_path + f".tmp{os.getpid()}"
        # stream rows straight into the file: O(1) host memory even for
        # datasets whose packed form is many GB
        arr = np.lib.format.open_memmap(
            tmp, mode="w+", dtype=np.uint8,
            shape=(len(self.paths), h, w, 3))
        for i, p in enumerate(self.paths):
            img = Image.open(p).convert("RGB").resize((w, h),
                                                      Image.BILINEAR)
            arr[i] = np.asarray(img, np.uint8)
        arr.flush()
        del arr
        os.replace(tmp, self._data_path)
        tmp = self._index_path + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({p: i for i, p in enumerate(self.paths)}, f)
        os.replace(tmp, self._index_path)

    def load(self, path: str) -> np.ndarray:
        """Normalized [H, W, 3] float32, identical to
        ``transforms.load_image(path, *hw)``."""
        row = self._mm[self._row[path]]
        return ((row.astype(np.float32) / 255.0 - IMAGENET_MEAN)
                / IMAGENET_STD).astype(np.float32)

    def gather(self, paths: list[str]) -> np.ndarray:
        """Batched ``load``: [len(paths), H, W, 3] normalized float32.
        Uses the native (C++, multi-threaded, GIL-free) gather when
        available — bit-identical to the numpy path
        (tests/test_native.py)."""
        from .. import native

        if native.available():
            rows = np.array([self._row[p] for p in paths], np.int64)
            return native.gather_normalize(self._mm, rows,
                                           IMAGENET_MEAN, IMAGENET_STD)
        return np.stack([self.load(p) for p in paths])
