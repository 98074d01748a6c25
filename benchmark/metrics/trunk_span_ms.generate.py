"""The trunk's device ms a batch from the program's own span
(``trunk`` in ``models/resnet.py::fused_forward``, ``utils/tracing.py``):
the mean over the profiled slice's batches."""


def read(run, cell):
    try:
        from scanpaths_tpu_torch.utils import tracing
    except ImportError:  # a program that records no spans
        return None
    spans = tracing.spans()
    if run.trace is None or not spans:
        return None
    ms = [s.device_ms for s in spans
          if s.parent is None and s.name == "trunk"]
    if len(ms) != run.trace.units:
        raise RuntimeError(f"{len(ms)} trunk spans for {run.trace.units} "
                           "profiled batches")
    return sum(ms) / len(ms)
