"""The trunk's ms a batch (``models/resnet.py::fused_forward``: the
folded convs and the stage kernel): CUDA events around each call, the
mean over the traced run's window."""

import statistics


def read(run, cell):
    ms = run.spans.get("trunk")
    return statistics.fmean(ms) if ms else None
