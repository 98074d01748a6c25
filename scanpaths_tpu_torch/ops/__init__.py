"""The port's kernels and their wrappers.  Importing this package
registers the custom ops ``scanpaths_tpu_torch::cell_step`` and
``scanpaths_tpu_torch::stage_apply``: all that a host running an
exported bundle (``serve/export.py``) must import besides torch."""

from . import block, cell  # noqa: F401
