"""The decoder's device ms a batch from the program's own span
(``decode`` in ``models/scanpath_model.py::ScanpathModel.eval_forward``:
the hoisted invariants, the T steps and the softmax;
``utils/tracing.py``): the mean over the profiled slice's batches."""


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
             if s.name == "decode" and s.root in roots)
    return ms / len(roots)
