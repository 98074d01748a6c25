"""The stage kernel's share of its roofline (``csrc/block.cu``): the
least time of a forward's stage calls, layers 1-3 at the batch's N
(``yardstick/roofline.py::stage_work``, each call's bound summed), over
the stage kernel's time a forward in the profiled slice."""

from benchmark import harness
from benchmark.yardstick import roofline


def read(run, cell):
    tr = harness.checked_trace(run, cell.cfg)
    if tr is None:
        return None
    cfg = cell.cfg
    ms, calls = tr.kernel_ms((harness.kernel_name("stage", cfg),))
    if calls == 0:
        return None
    bound_ms = roofline.stage_bound_ms(run.counts["batch"], cfg["height"],
                                       cfg["width"], cfg["backbone_layers"],
                                       cfg["dtype"])
    return roofline.share(bound_ms, ms / tr.units, "the stage kernel")
