"""The decoder's ms a batch (``ScanpathModel.forward`` on the trunk's
grid: the hoisted convs and the T steps of the cell kernel, the
attention and the composed heads): CUDA events around each call, the
mean over the traced run's window."""

import statistics


def read(run, cell):
    ms = run.spans.get("decode")
    return statistics.fmean(ms) if ms else None
