"""The port's kernels and their wrappers.  Importing this package
registers the custom ops ``scanpaths_tpu_torch::cell_step``,
``scanpaths_tpu_torch::stage_apply`` and
``scanpaths_tpu_torch::cond_head``: all that a host running an exported
bundle (``serve/export.py``) must import besides torch."""

from . import block, cell, head  # noqa: F401
