"""The share of the profiled slice of requests in which no
kernel, copy or set ran on the card, on any stream."""

from benchmark import harness


def read(run, cell):
    tr = harness.checked_trace(run, cell.cfg)
    return None if tr is None else tr.idle_pct()
