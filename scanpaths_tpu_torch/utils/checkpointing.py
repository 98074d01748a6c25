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

There is one backend: ``--ckpt_backend orbax`` (the JAX package's async
saves, ROADMAP A17) is refused by the trainer
(``train/trainer.py::check_ported_flags``).  A checkpoints directory
that holds a JAX run's ``.msgpack`` or ``.orbax`` artifacts raises here:
the port does not read flax msgpack.
"""

from __future__ import annotations

import os
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
        if not self._best_metric:
            self._best_metric = metric
        improved = (metric <= self._best_metric if self._mode == "min"
                    else metric >= self._best_metric)
        if improved:
            self._best_metric = metric
            save(self.best_path, {"model": model_state})

    def get_best_metric(self):
        return self._best_metric


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
