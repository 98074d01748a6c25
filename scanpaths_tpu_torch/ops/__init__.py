"""The port's kernels and their wrappers.  Importing this package
registers the custom ops ``scanpaths_tpu_torch::cell_step``,
``scanpaths_tpu_torch::stage_apply``, ``scanpaths_tpu_torch::cond_head``
and ``scanpaths_tpu_torch::cond_compose``: all that a host running an
exported bundle (``serve/export.py``) must import besides torch."""

from . import block, cell, compose, head  # noqa: F401
