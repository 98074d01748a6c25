"""The benchmark of ``scanpaths_tpu_torch`` on the H100 (``run.py``)."""
