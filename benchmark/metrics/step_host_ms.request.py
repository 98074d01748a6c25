"""A batch-1 decode step's host ms (``decode.step`` in
``ScanpathModel._decode``, ``utils/tracing.py``): the mean over a
request's T steps of the host's time in the step, the median over the
profiled requests.  What issuing a step costs the host."""

import statistics


def read(run, cell):
    try:
        from scanpaths_tpu_torch.utils import tracing
    except ImportError:  # a program that records no spans
        return None
    spans = tracing.spans()
    if run.trace is None or not spans:
        return None
    roots = [s for s in spans
             if s.parent is None and s.name == "serve.forward"]
    if len(roots) != run.trace.units:
        raise RuntimeError(f"{len(roots)} serve.forward spans for "
                           f"{run.trace.units} profiled requests")
    return statistics.median(
        statistics.fmean(s.host_ms for s in spans
                         if s.name == "decode.step" and s.root == r.id)
        for r in roots)
