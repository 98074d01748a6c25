"""The serving layer's host time (``serve/predictor.py``): the median
over the profiled requests of a request's wall time less the time in it
during which something ran on the card."""

import statistics

from benchmark import harness


def read(run, cell):
    tr = harness.checked_trace(run, cell.cfg)
    if tr is None:
        return None
    own = [(b - a) / 1e3 - tr.busy_inside_ms(a, b)
           for name, a, b in tr.spans if name == "unit"]
    return statistics.median(own) if own else None
