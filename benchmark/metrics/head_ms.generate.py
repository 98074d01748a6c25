"""The decoder's heads, device ms a batch (``decode.step.head`` in
``ScanpathModel._decode``: every stream's composed conditioner+head, its
duration and its next history entry, ``utils/tracing.py``): the T steps
summed, the mean over the profiled slice's batches."""


def read(run, cell):
    try:
        from scanpaths_tpu_torch.utils import tracing
    except ImportError:  # a program that records no spans
        return None
    spans = tracing.spans()
    if run.trace is None or not spans:
        return None
    roots = {s.id for s in spans if s.parent is None and s.name == "decode"}
    if len(roots) != run.trace.units:
        raise RuntimeError(f"{len(roots)} decode spans for "
                           f"{run.trace.units} profiled batches")
    ms = sum(s.device_ms for s in spans
             if s.name == "decode.step.head" and s.root in roots)
    return ms / len(roots)
