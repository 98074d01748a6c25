"""The port's spans and counters: where a unit of work spends its time,
layer by layer, and how often each kernel ran.

* :func:`span` marks a layer boundary (``with tracing.span("decode"):``).
  Off, it checks one flag and returns a shared do-nothing context: no
  allocation, no clock read, no CUDA call, nothing in a ``torch.export``
  graph.  It is on while a ``torch.profiler`` session runs, and between
  :func:`enable` and :func:`disable`.  On, it records its name, its id,
  its parent's (the span open around it on the same thread) and its
  root's (the outermost span of the unit of work it belongs to), and its
  start and end on the host as unix-epoch ns from ``time.time_ns()``,
  the clock kineto stamps its trace with: a span shifted by the trace's
  ``trace_start_ns()`` lines up with the trace's events.  Once CUDA is
  initialised it also records a timing ``torch.cuda.Event`` pair on the
  current stream, for the span's device time.  It opens no profiler
  range: under the profiler such a range also shows on the device
  timeline, where a reader of the trace would count it as device work.
* Records stay in memory, the newest :data:`CAPACITY` of them.
  :func:`spans` returns them (without draining) with their host and
  device ms, the latter read once the work is done; :func:`clear`
  empties them.
* :func:`count` always counts (an integer add); :func:`counter` and
  :func:`counters` read, :func:`reset_counters` zeroes.  The kernels'
  wrappers count their launches as ``cell_step.launches``,
  ``stage_apply.launches``, ``nw_scores_bins.launches`` and
  ``cond_head.launches`` (:func:`launches` reads the four), at Python
  dispatch: a CUDA graph's replay does not pass through them.
  ``cond_head.composed`` counts the conditioner+head compositions
  (``models/components.py::fuse_cond_head``: 1 a forward for OSIE, 2 for
  AiR, the distinct task ids for COCO), only while spans are on
  (:func:`active`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 16
# the kernels whose wrappers count their launches, as "<kernel>.launches"
KERNELS = ("cell_step", "stage_apply", "nw_scores_bins", "cond_head")


@dataclasses.dataclass(frozen=True)
class Span:
    """A finished span: ``parent`` None for a root, ``root`` its own id
    for a root; ``device_ms`` None where no CUDA events were recorded."""
    id: int
    parent: int | None
    root: int
    name: str
    t0_ns: int
    t1_ns: int
    device_ms: float | None

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6


# what span() returns while tracing is off
_OFF = contextlib.nullcontext()
_enabled = False
_ids = itertools.count(1)
_records: collections.deque = collections.deque(maxlen=CAPACITY)
_local = threading.local()
_streams: dict = {}
_counts: dict[str, int] = {}


class _On:
    __slots__ = ("name", "id", "parent", "root", "t0", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        self.start = None
        if torch.cuda.is_initialized():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(_current_stream())
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        events = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(_current_stream())
            events = (self.start, end)
        _stack().pop()
        # [id, parent, root, name, t0, t1, device ms or its events]
        _records.append([self.id, self.parent, self.root, self.name,
                         self.t0, t1, events])
        return False


def _current_stream() -> torch.cuda.Stream:
    """``torch.cuda.current_stream()``, looked up by the raw stream: the
    call itself costs ~8 us on the host, a quarter of an on span's."""
    device = torch._C._cuda_getDevice()
    key = (device, torch._C._cuda_getCurrentRawStream(device))
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.current_stream(device)
    return stream


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def active() -> bool:
    """Whether spans are on: between :func:`enable` and :func:`disable`,
    or while a ``torch.profiler`` session runs."""
    return _enabled or _profiler._is_profiler_enabled


def span(name: str):
    """A context that records a span named ``name`` while tracing is on
    (module docstring), and does nothing otherwise."""
    if not active():
        return _OFF
    return _On(name)


def enable() -> None:
    """Records spans outside a profiler session too."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Records spans only while a profiler session runs."""
    global _enabled
    _enabled = False


def spans() -> list[Span]:
    """The recorded spans in the order they ended, without draining
    them.  A span's device ms is read here, once its end event has
    completed (this waits for it)."""
    out = []
    for rec in list(_records):
        events = rec[6]
        if isinstance(events, tuple):
            start, end = events
            end.synchronize()
            rec[6] = start.elapsed_time(end)
        out.append(Span(*rec))
    return out


def clear() -> None:
    """Drops every recorded span."""
    _records.clear()


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counter(name: str) -> int:
    return _counts.get(name, 0)


def counters() -> dict[str, int]:
    """Every counter, by name."""
    return dict(_counts)


def launches() -> dict[str, int]:
    """Each of :data:`KERNELS`' launches, by kernel."""
    return {k: counter(f"{k}.launches") for k in KERNELS}


def reset_counters(*names: str) -> None:
    """Sets the counters ``names`` (every counter, with none) to zero."""
    for name in names or list(_counts):
        _counts[name] = 0
