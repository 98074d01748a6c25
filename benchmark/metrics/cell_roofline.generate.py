"""The cell kernel's share of its roofline (``csrc/cell.cu``): the
least time of one call at the batch's N and the configuration's S
streams (``yardstick/roofline.py::cell_bound``) over the mean time of
a call in the profiled slice."""

from benchmark import harness
from benchmark.yardstick import roofline


def read(run, cell):
    tr = harness.checked_trace(run, cell.cfg)
    if tr is None:
        return None
    cfg = cell.cfg
    ms, calls = tr.kernel_ms((harness.kernel_name("cell", cfg),))
    if calls == 0:
        return None
    bound_ms, _ = roofline.cell_bound(
        run.counts["batch"], cfg["map_height"], cfg["map_width"],
        cfg["embed"], run.counts["streams"], cfg["dtype"])
    return roofline.share(bound_ms, ms / calls, "the cell kernel")
