"""The conditioner+head compositions' device ms a batch
(``decode.hoist.compose`` inside ``decode.hoist`` in
``ScanpathModel._decode``: one composition for OSIE, two for AiR, one a
distinct target id for COCO; ``utils/tracing.py``): the mean over the
profiled slice's batches.  None for a program without the span."""


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
    ms = [s.device_ms for s in spans
          if s.name == "decode.hoist.compose" and s.root in roots]
    if not ms:
        return None
    return sum(ms) / len(roots)
