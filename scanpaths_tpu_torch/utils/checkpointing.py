"""Checkpoint management (port of ``scanpaths_tpu/utils/checkpointing.py``,
its synchronous single-file backend; reference
AiR/utils/checkpointing.py:9-113).

The triad semantics are the reference's:

* ``checkpoint.pth`` -- model + optimizer, written on EVERY
  ``step(metric)`` call (the resume checkpoint);
* ``checkpoint_best.pth`` -- model only, written when the tracked metric
  improves under the configured mode (ties count as an improvement, and
  a falsy initial best adopts the first metric);
* the pre-RL ``<logdir>_supervised_save`` copy is made by the trainer.

Each write goes to a temporary file that ``os.replace`` then moves over
the final name, so a crash mid-write never loses the previous file.

The files are the reference's own ``.pth`` format: ``torch.save`` of
``{"model": state_dict, "optimizer": ...}`` with the model in the
reference's key layout (``models/port.py::to_reference_state_dict``), so
``models/port.py::load_reference_state_dict`` and
``serve/predictor.py`` read the port's runs as they read the
reference's.  The optimizer entry is the port's own torch Adam
``state_dict``, keyed by the index of the port's parameters (the fused
ConvLSTM gate convs among them): only the port resumes from it.

Two managers write these files: :class:`CheckpointManager` writes them
synchronously, :class:`AsyncCheckpointManager` on a writer thread from a
host copy of the state (``--ckpt_backend orbax``, the flag of the JAX
package's async saves; :func:`make_checkpoint_manager` picks by the
flag).  A checkpoints directory that holds a JAX run's ``.msgpack`` or
``.orbax`` artifacts raises here: the port does not read flax msgpack.
"""

from __future__ import annotations

import concurrent.futures
import os
import time
from os.path import join
from typing import Any

import torch

SUFFIX = ".pth"
JAX_SUFFIXES = (".msgpack", ".orbax")


def _jax_artifacts(directory: str, prefix: str = "checkpoint") -> list[str]:
    """The JAX package's checkpoint files in ``directory`` (final names
    and orbax's ``.old``/``.new`` commit leftovers)."""
    names = []
    for suffix in JAX_SUFFIXES:
        for stem in (f"{prefix}{suffix}", f"{prefix}_best{suffix}"):
            for n in (stem, stem + ".old", stem + ".new"):
                if os.path.exists(join(directory, n)):
                    names.append(n)
    return names


def _refuse_jax_run(directory: str, prefix: str = "checkpoint") -> None:
    found = _jax_artifacts(directory, prefix)
    if found:
        raise RuntimeError(
            f"{directory!r} holds checkpoints of a JAX run {found}: the "
            f"PyTorch port reads and writes only reference-layout .pth "
            f"checkpoints (flax msgpack and orbax are not read)")


def save(path: str, obj: Any) -> None:
    """``torch.save`` to a temporary file, then ``os.replace`` over
    ``path``."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    def __init__(self, serialization_dir: str, mode: str = "max",
                 best_metric=None, filename_prefix: str = "checkpoint"):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode!r}: 'min' or 'max'")
        self._dir = serialization_dir
        self._mode = mode
        self._prefix = filename_prefix
        self._best_metric = best_metric
        os.makedirs(serialization_dir, exist_ok=True)
        _refuse_jax_run(serialization_dir, filename_prefix)

    @property
    def path(self) -> str:
        return join(self._dir, self._prefix + SUFFIX)

    @property
    def best_path(self) -> str:
        return join(self._dir, f"{self._prefix}_best{SUFFIX}")

    def step(self, metric: float, model_state: Any, opt_state: Any = None):
        """Write the rolling checkpoint; write the best checkpoint if
        ``metric`` improves (ties count as improvement, like the
        reference's <=/>=; a falsy initial best adopts the first metric,
        reference checkpointing.py:83-84)."""
        save(self.path, {"model": model_state, "optimizer": opt_state})
        if self._improves(metric):
            save(self.best_path, {"model": model_state})

    def _improves(self, metric: float) -> bool:
        """Whether ``metric`` is a new best (then kept as the best)."""
        if not self._best_metric:
            self._best_metric = metric
        improved = (metric <= self._best_metric if self._mode == "min"
                    else metric >= self._best_metric)
        if improved:
            self._best_metric = metric
        return improved

    def get_best_metric(self):
        return self._best_metric

    def wait(self):
        """Writes are synchronous; nothing to wait for."""

    def close(self):
        """Nothing to release."""


def host_copy(obj: Any) -> Any:
    """``obj`` (nested dicts, lists and tuples) with every tensor copied
    to the host: a card's tensors into pinned buffers by non-blocking
    copies and one synchronize, a host tensor by a clone."""
    on_card = False

    def copy(x):
        nonlocal on_card
        if torch.is_tensor(x):
            x = x.detach()
            if x.device.type == "cpu":
                return x.clone()
            on_card = True
            buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return buf.copy_(x, non_blocking=True)
        if isinstance(x, dict):
            return type(x)((k, copy(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        return x
    out = copy(obj)
    if on_card:
        torch.cuda.synchronize()
    return out


class AsyncCheckpointManager(CheckpointManager):
    """The triad of :class:`CheckpointManager` written on a writer
    thread: ``step()`` returns once the state is copied to the host
    (:func:`host_copy`), and the write overlaps the next steps.  It is
    what ``--ckpt_backend orbax`` selects, so that one command line means
    the same to both packages, but it writes the same ``checkpoint.pth``
    and ``checkpoint_best.pth`` as the synchronous manager, not orbax
    directories.

    One write is in flight at a time: ``step()`` first waits for the
    previous step's writes, then enqueues the rolling write and, if the
    metric improved, the best write.  ``wait()`` returns when every write
    is on disk under its final name; ``close()`` also stops the writer
    (a second call does nothing).  An error of the writer is raised from
    the next ``step``, ``wait`` or ``close``.  ``writes`` holds, per file
    written, (its name, the ms the write took, its size in bytes)."""

    def __init__(self, serialization_dir: str, mode: str = "max",
                 best_metric=None, filename_prefix: str = "checkpoint"):
        super().__init__(serialization_dir, mode, best_metric,
                         filename_prefix)
        self._writer = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="checkpoint-writer")
        self._pending: list[concurrent.futures.Future] = []
        self._closed = False
        self.writes: list[tuple[str, float, int]] = []

    def _write(self, path: str, obj: Any) -> None:
        t0 = time.perf_counter()
        save(path, obj)
        self.writes.append((os.path.basename(path),
                            1e3 * (time.perf_counter() - t0),
                            os.path.getsize(path)))

    def _submit(self, path: str, obj: Any) -> None:
        self._pending.append(self._writer.submit(self._write, path, obj))

    def step(self, metric: float, model_state: Any, opt_state: Any = None):
        if self._closed:
            raise RuntimeError("AsyncCheckpointManager.step after close()")
        self.wait()
        state = host_copy({"model": model_state, "optimizer": opt_state})
        self._submit(self.path, state)
        if self._improves(metric):
            self._submit(self.best_path, {"model": state["model"]})

    def wait(self):
        """Blocks until every enqueued write is on disk under its final
        name; raises the first error of those writes."""
        pending, self._pending = self._pending, []
        errors = [f.exception() for f in pending]
        for e in errors:
            if e is not None:
                raise e

    def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            self.wait()
        finally:
            self._writer.shutdown(wait=True)


def make_checkpoint_manager(serialization_dir: str, mode: str = "max",
                            best_metric=None, backend: str = "msgpack"):
    """The manager of ``--ckpt_backend``: ``msgpack`` (the default)
    writes synchronously, ``orbax`` on a writer thread; both write the
    reference-layout ``.pth`` triad."""
    managers = {"msgpack": CheckpointManager,
                "orbax": AsyncCheckpointManager}
    if backend not in managers:
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    return managers[backend](serialization_dir, mode=mode,
                             best_metric=best_metric)


def restore_checkpoint(checkpoints_dir: str) -> dict:
    """The rolling checkpoint (resume path): ``{"model": reference-layout
    state dict, "optimizer": the port's Adam state_dict}`` on the CPU."""
    _refuse_jax_run(checkpoints_dir)
    return load(join(checkpoints_dir, "checkpoint" + SUFFIX))


def restore_best_checkpoint(checkpoints_dir: str) -> dict:
    """The best checkpoint's reference-layout model state dict, on the
    CPU."""
    _refuse_jax_run(checkpoints_dir)
    return load(join(checkpoints_dir, "checkpoint_best" + SUFFIX))["model"]
