"""File + console logger (reference AiR/utils/logger.py:3-26).

Level parity: the AiR/COCO loggers run at INFO, OSIE's at DEBUG
(reference OSIE/utils/logger.py:6-14) — callers pass
``level=task_log_level(task)``.

The port's own copy of ``scanpaths_tpu/utils/logger.py``
(the port imports nothing of the JAX package); keep the two identical.
"""

from __future__ import annotations

import logging
import sys


def task_log_level(task: str) -> int:
    """OSIE logs at DEBUG, AiR/COCO at INFO (reference
    OSIE/utils/logger.py:6 vs AiR/utils/logger.py:8)."""
    return logging.DEBUG if task == "osie" else logging.INFO


def Logger(log_file: str, level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(log_file)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    logger.propagate = False
    return logger
