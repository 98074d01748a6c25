"""The sampler's ms a batch (``ops/sampling.py::random_sample``, every
stream's rollouts with their noise): CUDA events around each call, the
mean over the traced run's window."""

import statistics


def read(run, cell):
    ms = run.spans.get("sample")
    return statistics.fmean(ms) if ms else None
