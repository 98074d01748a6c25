"""Build the port's CUDA sources into one shared library and bind it.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, which is
loaded with :mod:`ctypes`.  The library lands in
``build/scanpaths_tpu_torch/`` at the root of the checkout, named by a
hash of the sources and flags, so an unchanged tree builds once.  The
build runs at first use: the first kernel launch (or an explicit
:func:`library` call) compiles.

There is no fallback: if ``nvcc`` is missing or fails, :func:`library`
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD = pathlib.Path(__file__).resolve().parents[2] / "build" / \
    "scanpaths_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``); raises if neither has one."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin (CUDA_HOME="
        f"{home!r}): the CUDA kernels of scanpaths_tpu_torch cannot be "
        "built")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    """Where the library for the current sources lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD / f"libsp_kernels_{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if it is not built."""
    out = library_path()
    if not out.exists():
        nvcc = find_nvcc()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        # ptxas -v: registers, shared memory and spills per kernel
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


@functools.lru_cache(maxsize=None)
def kernel(name: str, n_ptr: int, n_int: int, n_float: int = 0):
    """C entry point ``name(ptr * n_ptr, int * n_int, float * n_float,
    stream) -> int`` with its ctypes signature declared (pointers and
    the stream as ``c_void_p``, so none is cut to 32 bits)."""
    fn = getattr(library(), name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float] * n_float + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        msg_fn = library().sp_error_string
        msg_fn.argtypes = [ctypes.c_int]
        msg_fn.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{name} failed: CUDA error {err} ({msg_fn(err).decode()})")
