"""Build the port's CUDA sources into one shared library and bind it.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per file, all started together, and
the objects are linked into one shared library with a plain C interface,
which is loaded with :mod:`ctypes`.  The library lands in
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

import torch
from torch.utils.weak import WeakIdKeyDictionary

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD = pathlib.Path(__file__).resolve().parents[2] / "build" / \
    "scanpaths_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# cached(): owner -> {name: (key, value, sources held)}
_CACHE = WeakIdKeyDictionary()


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
        stem = out.with_name(f"{out.stem}.{os.getpid()}")
        objs = [stem.with_name(f"{stem.name}.{src.stem}.o")
                for src in _sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj),
                 str(src)] for src, obj in zip(_sources(), objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]
        tmp = stem.with_name(f"{stem.name}.tmp.so")
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        if all(proc.returncode == 0 for proc in procs):
            proc = subprocess.run(link, capture_output=True, text=True)
            logs.append(proc.stdout + proc.stderr)
            cmds.append(link)
            procs.append(proc)
        for obj in objs:
            obj.unlink(missing_ok=True)
        for cmd, proc, log in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with exit code {proc.returncode}:\n"
                    f"{' '.join(cmd)}\n{log}")
        # ptxas -v: registers, shared memory and spills per kernel
        out.with_suffix(".log").write_text("".join(logs))
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


def refuse_grad(name: str, *tensors) -> None:
    """Raise if autograd would record a call of kernel wrapper ``name``
    on ``tensors``: the kernels define no backward, so a call under grad
    mode with an input that requires grad would give an output detached
    from the graph (JAX refuses a ``pallas_call`` with no VJP the same
    way).  The training forward computes these steps with stock ops."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or "
            "with inputs that do not require grad")


def cached(owner, name, sources, build):
    """``build()`` under ``no_grad``, kept for ``owner`` (a module or a
    tensor) under ``name`` until a tensor of ``sources`` changes its
    identity (a view's is the tensor it views), storage, device, dtype
    or version: the port's one rule for what it derives from weights.
    The entry lives in a weak table, not on ``owner``, goes with it and
    holds the other sources, so no later tensor takes one's identity.
    Under ``torch.export`` or ``torch.compile``, or on tensors with no
    storage, ``build()`` is traced as it is and nothing is kept."""
    if torch.compiler.is_compiling():
        return build()
    roots = [t if t._base is None else t._base for t in sources]
    try:
        key = [(id(r), t.data_ptr(), t.device, t.dtype, t._version)
               for r, t in zip(roots, sources)]
    except RuntimeError:        # fake or functional tensors: traced
        return build()
    slots = _CACHE.setdefault(owner, {})
    hit = slots.get(name)
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        value = build()
    slots[name] = (key, value, [r for r in roots if r is not owner])
    return value


def packed(t, pack):
    """``pack(t)``, the layout a kernel reads a weight in, kept for ``t``
    (:func:`cached`), so a weight passed to many launches is laid out
    once a version."""
    return cached(t, pack, (t,), lambda: pack(t))


def grid_report(name: str, n_out: int, *args: int) -> list[int]:
    """What C entry point ``name(int *out, int...)`` reports of a
    launch: grid sizes and blocks per SM, ``n_out`` ints."""
    fn = getattr(library(), name)
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * len(args)
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * n_out)()
    check(name, fn(ctypes.addressof(out), *args))
    return list(out)
