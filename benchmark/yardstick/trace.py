"""What the benchmark reads from a ``torch.profiler`` trace: the device
intervals, the host spans the benchmark opened around its calls, the
busy time, the idle gaps and the kernel time by name.

The busy time is the union of the kernel and copy intervals on every
stream (``chip_smoke.py``'s ``_union_ms`` and ``_device_events``).  A
trace is checked against the work it must hold before anything is read
from it (``scanpaths_tpu_torch/tools/profile_scan.py``'s
``trace_problem``): a process can lose profiler events, and a busy
share read from such a trace is wrong without a sign.
"""

from __future__ import annotations

import dataclasses
import math

# the benchmark's host spans carry this prefix in the trace
SPAN_PREFIX = "bench:"
# the device events' summed time may pass the traced window by this
# share (the clocks' agreement) and no more
SPAN_SLACK = 0.01


def union_us(intervals) -> float:
    """The time (us) covered by a list of (start, end) intervals in us."""
    busy, reach = 0.0, -math.inf
    for lo, hi in sorted(intervals):
        busy += max(0.0, hi - max(lo, reach))
        reach = max(reach, hi)
    return busy


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


@dataclasses.dataclass
class Trace:
    """A profiled slice: ``device`` (name, start_us, end_us) of every
    kernel, copy and set on the card; ``spans`` (name, start_us,
    end_us) of the benchmark's host spans, the prefix taken off;
    ``units`` the slice's units of work (batches, requests) and
    ``window`` (start_us, end_us), from the first unit's span's start to
    the last one's end."""
    device: list
    spans: list
    units: int
    window: tuple

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_us(self) -> float:
        return union_us(clip([(a, b) for _, a, b in self.device],
                             *self.window))

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_us() / self.window_us)

    def kernel_ms(self, names) -> tuple[float, int]:
        """(summed ms, count) of the device events whose name holds one
        of ``names`` (a trace spells a kernel ``void cell_f32(...)``)."""
        hits = [b - a for name, a, b in self.device
                if any(k in name for k in names)]
        return sum(hits) / 1e3, len(hits)

    def problem(self, kernel_names, expected_calls: int) -> str | None:
        """Why this trace cannot be read, or None: fewer events of the
        named kernels than the slice's work launched (the trace lost
        events), or device events whose summed time passes the window
        (they were not all inside it)."""
        _, calls = self.kernel_ms(kernel_names)
        if calls < expected_calls:
            return (f"{calls} events of {kernel_names} in the trace for "
                    f"{expected_calls} launches")
        total = sum(b - a for _, a, b in self.device)
        if total > self.window_us * (1 + SPAN_SLACK):
            return (f"device events sum to {total / 1e3:.3f} ms over a "
                    f"{self.window_us / 1e3:.3f} ms window")
        if total <= 0.0:
            return "no device time in the trace"
        return None

    def busy_inside_ms(self, lo: float, hi: float) -> float:
        return union_us(clip([(a, b) for _, a, b in self.device],
                             lo, hi)) / 1e3

    def top_ops(self, k: int = 10) -> list[list]:
        """The ``k`` device operations (by name) that took the most
        time: [name, seconds]."""
        times: dict[str, float] = {}
        for name, a, b in self.device:
            times[name] = times.get(name, 0.0) + (b - a) / 1e6
        top = sorted(times.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:120], secs] for name, secs in top]

    def idle_gaps(self, k: int = 10) -> list[list]:
        """The ``k`` longest stretches of the window with nothing on the
        card, each named by the innermost benchmark span the host was in
        at its middle ("between spans" when none): [name, seconds]."""
        busy = sorted(clip([(a, b) for _, a, b in self.device],
                           *self.window))
        gaps, reach = [], self.window[0]
        for lo, hi in busy:
            if lo > reach:
                gaps.append((reach, lo))
            reach = max(reach, hi)
        if self.window[1] > reach:
            gaps.append((reach, self.window[1]))
        named = []
        for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            mid = 0.5 * (lo + hi)
            inside = [(b - a, n) for n, a, b in self.spans if a <= mid <= b]
            named.append([min(inside)[1] if inside else "between spans",
                          (hi - lo) / 1e6])
        return named


def read_profile(prof, units: int) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``: its
    device events (every kernel, copy and set of the CUDA activity) and
    the host spans the benchmark opened with
    ``torch.profiler.record_function(SPAN_PREFIX + name)``."""
    from torch.autograd import DeviceType
    device, spans = [], []
    for evt in prof.events():
        lo, hi = evt.time_range.start, evt.time_range.end
        if evt.name.startswith(SPAN_PREFIX):
            # a span also shows on the device timeline as an annotation,
            # which is no device work
            if evt.device_type == DeviceType.CPU:
                spans.append((evt.name[len(SPAN_PREFIX):], lo, hi))
        elif evt.device_type == DeviceType.CUDA:
            device.append((evt.name, lo, hi))
    unit_spans = [(a, b) for n, a, b in spans if n == "unit"]
    if not unit_spans:
        raise RuntimeError("the trace holds no unit span of the benchmark")
    window = (min(a for a, _ in unit_spans), max(b for _, b in unit_spans))
    return Trace(device=device, spans=spans, units=units, window=window)
