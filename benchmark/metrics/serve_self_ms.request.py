"""The serving layer's own host ms a request (``serve.forward`` in
``serve/predictor.py::Predictor.forward``: the array conversion, the
copy to the card and the call into the model, ``utils/tracing.py``):
the span's host ms less its children's (``trunk``, ``decode``), the
median over the profiled requests."""

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
        r.host_ms - sum(s.host_ms for s in spans if s.parent == r.id)
        for r in roots)
