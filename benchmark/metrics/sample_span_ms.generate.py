"""The sampler's device ms a batch from the program's own spans
(``sample`` in ``ops/sampling.py::random_sample``, one a stream,
``utils/tracing.py``): every stream's summed, the mean over the profiled
slice's batches."""


def read(run, cell):
    try:
        from scanpaths_tpu_torch.utils import tracing
    except ImportError:  # a program that records no spans
        return None
    spans = tracing.spans()
    if run.trace is None or not spans:
        return None
    ms = [s.device_ms for s in spans
          if s.parent is None and s.name == "sample"]
    want = run.trace.units * run.counts["streams"]
    if len(ms) != want:
        raise RuntimeError(f"{len(ms)} sample spans for {want} "
                           "(profiled batches x streams)")
    return sum(ms) / run.trace.units
