"""Native (C++) host-side batch assembly: build-on-demand + ctypes.

The reference's input path runs in torch DataLoader native workers
(reference AiR/train.py:98-109); this package is the rebuild's
equivalent — the per-sample hot loops compiled once with g++ and run
multi-threaded over whole batches, GIL-free.  Results are
bit-identical to the numpy reference path (``tests/test_native.py``).

Usage: ``native.available()`` gates every call site; any build or
load failure (no g++, read-only cache, exotic platform) silently
falls back to the numpy path.  ``SP_NATIVE=0`` disables the module
outright; ``SP_NATIVE_CACHE`` overrides the .so cache directory;
``SP_NATIVE_THREADS`` pins the worker count (default: cpu count).

The port's own copy of ``scanpaths_tpu/native/__init__.py``
(the port imports nothing of the JAX package); keep the two identical.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "sp_native.cpp")
_lock = threading.Lock()
_lib = None
_tried = False


def _n_threads(n_threads: int | None) -> int:
    if n_threads is not None:
        return int(n_threads)
    env = os.environ.get("SP_NATIVE_THREADS")
    return int(env) if env else (os.cpu_count() or 1)


def _build_and_load():
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.md5(src).hexdigest()[:12]
    cache = os.environ.get("SP_NATIVE_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "scanpaths_tpu")
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache, f"sp_native_{tag}.so")
    if not os.path.exists(so):
        tmp = so + f".tmp{os.getpid()}"
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
             _SRC, "-o", tmp],
            check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)  # atomic: concurrent builders race benignly
    lib = ctypes.CDLL(so)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.sp_gather_normalize.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, f32p, f32p, f32p, ctypes.c_int]
    lib.sp_gather_normalize.restype = None
    lib.sp_tensorize_batch.argtypes = [
        f32p, f32p, f32p, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, f32p, f32p, f32p, f32p, f32p, f32p, f32p,
        f32p, f32p, f32p, f32p, ctypes.c_int]
    lib.sp_tensorize_batch.restype = None
    return lib


def available() -> bool:
    """Build (once) and report whether the native library is usable."""
    global _lib, _tried
    if os.environ.get("SP_NATIVE", "1") == "0":
        return False
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _build_and_load()
            except Exception:  # no g++ / sandboxed cache / load failure
                _lib = None
        return _lib is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def gather_normalize(store: np.ndarray, rows: np.ndarray,
                     mean: np.ndarray, std: np.ndarray,
                     n_threads: int | None = None) -> np.ndarray:
    """[len(rows), H, W, 3] normalized f32 gathered from a [M, H, W, 3]
    uint8 store; bit-identical to ``PackedImageCache.load`` per row."""
    assert _lib is not None
    assert store.dtype == np.uint8 and store.ndim == 4
    rows = np.ascontiguousarray(rows, np.int64)
    n = len(rows)
    _, h, w, _ = store.shape
    out = np.empty((n, h, w, 3), np.float32)
    mean32 = np.ascontiguousarray(mean, np.float32)
    std32 = np.ascontiguousarray(std, np.float32)
    _lib.sp_gather_normalize(
        store.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, h * w, _f32p(mean32), _f32p(std32), _f32p(out),
        _n_threads(n_threads))
    return out


def tensorize_batch(xs: list[np.ndarray], ys: list[np.ndarray],
                    durs: list[np.ndarray], origins: list[tuple[int, int]],
                    t_max: int, mh: int, mw: int, clamp_to_grid: bool,
                    blur_rows: np.ndarray | None = None,
                    n_threads: int | None = None):
    """Batched ``tensorize_scanpath``: returns (target [N, T, HW+1],
    duration [N, T], action_mask [N, T], duration_mask [N, T]),
    bit-identical to the per-sample numpy path.

    The per-sample scalars (down factors, clamp thresholds) are
    precomputed here in the exact float32 values NEP-50 numpy promotion
    would use inside ``tensorize_scanpath``, so the C++ arithmetic
    reproduces the numpy results bit-for-bit.
    """
    assert _lib is not None
    n = len(xs)
    lens = np.array([len(x) for x in xs], np.int32)
    l_max = max(1, int(lens.max()) if n else 1)
    xs_p = np.zeros((n, l_max), np.float32)
    ys_p = np.zeros((n, l_max), np.float32)
    ds_p = np.zeros((n, l_max), np.float32)
    for i in range(n):
        xs_p[i, :lens[i]] = xs[i]
        ys_p[i, :lens[i]] = ys[i]
        ds_p[i, :lens[i]] = durs[i]
    down_x = np.empty(n, np.float32)
    down_y = np.empty(n, np.float32)
    for i, (oy, ox) in enumerate(origins):
        down_x[i] = np.float32(ox / mw)   # f64 ratio rounded to f32,
        down_y[i] = np.float32(oy / mh)   # as numpy's weak promotion does
    if clamp_to_grid:
        lim_x = np.empty(n, np.float32)
        val_x = np.empty(n, np.float32)
        lim_y = np.empty(n, np.float32)
        val_y = np.empty(n, np.float32)
        for i, (oy, ox) in enumerate(origins):
            lim_x[i] = np.float32(mw * (ox / mw))
            val_x[i] = np.float32(mw * (ox / mw) - 1)
            lim_y[i] = np.float32(mh * (oy / mh))
            val_y[i] = np.float32(mh * (oy / mh) - 1)
        clamp_ptrs = (_f32p(lim_x), _f32p(val_x), _f32p(lim_y), _f32p(val_y))
    else:
        null = ctypes.POINTER(ctypes.c_float)()
        clamp_ptrs = (null, null, null, null)
    if blur_rows is not None:
        blur_rows = np.ascontiguousarray(blur_rows, np.float32)
        assert blur_rows.shape == (mh * mw, mh * mw)
        blur_ptr = _f32p(blur_rows)
    else:
        blur_ptr = ctypes.POINTER(ctypes.c_float)()
    target = np.empty((n, t_max, mh * mw + 1), np.float32)
    duration = np.empty((n, t_max), np.float32)
    amask = np.empty((n, t_max), np.float32)
    dmask = np.empty((n, t_max), np.float32)
    _lib.sp_tensorize_batch(
        _f32p(xs_p), _f32p(ys_p), _f32p(ds_p),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, l_max, t_max, mh, mw, _f32p(down_x), _f32p(down_y),
        *clamp_ptrs, blur_ptr, _f32p(target), _f32p(duration),
        _f32p(amask), _f32p(dmask), _n_threads(n_threads))
    return target, duration, amask, dmask


def make_blur_rows(mh: int, mw: int, sigma: float) -> np.ndarray:
    """Precompute every possible blurred one-hot row: row[y*mw+x] is
    exactly what ``tensorize_scanpath`` computes per step with
    ``blur_sigma`` (scipy gaussian_filter + sum-normalize), so gathering
    rows is bit-identical to blurring on the fly."""
    import scipy.ndimage as filters

    rows = np.empty((mh * mw, mh * mw), np.float32)
    for y in range(mh):
        for x in range(mw):
            grid = np.zeros((mh, mw), np.float32)
            grid[y, x] = 1.0
            grid = filters.gaussian_filter(grid, sigma)
            grid /= grid.sum()
            rows[y * mw + x] = grid.reshape(-1)
    return rows
