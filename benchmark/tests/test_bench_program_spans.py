"""The readers of the program's own spans (``metrics/*`` that read
``scanpaths_tpu_torch/utils/tracing.py``) on synthetic span trees: each
gives the mean or median it defines, nothing for a program or a run
without spans, and raises where the slice's root spans do not match its
profiled units.  On a card (marked ``gpu``): the spans' device ms,
recorded on the stream current at each end."""

import itertools
import sys
import types

import pytest
import torch

from benchmark import harness
from scanpaths_tpu_torch import utils
from scanpaths_tpu_torch.utils import tracing

GENERATE = ["trunk_span_ms.generate", "decode_span_ms.generate",
            "sample_span_ms.generate", "hoist_ms.generate",
            "attend_ms.generate", "cell_ms.generate", "head_ms.generate"]
REQUEST = ["step_host_ms.request", "step_device_ms.request",
           "serve_self_ms.request"]
T = 3


class Tree:
    """Spans as the program records them: ids in the order opened, each
    with its parent's root."""

    def __init__(self):
        self.spans, self.ids, self.t = [], itertools.count(1), 0

    def add(self, name, parent=None, host_ms=1.0, device_ms=1.0):
        sid = next(self.ids)
        root = sid if parent is None else parent.root
        t0 = self.t
        self.t += int(host_ms * 1e6)
        s = tracing.Span(sid, None if parent is None else parent.id, root,
                         name, t0, t0 + int(host_ms * 1e6), device_ms)
        self.spans.append(s)
        return s


def generate_tree(units, streams):
    """Batch b: trunk 10 + b ms, decode 100 + b with a hoist of 1 + b and
    T steps of attend 2, cell 5, head 3; a sample of 0.5 a stream."""
    tree = Tree()
    for b in range(units):
        tree.add("trunk", device_ms=10.0 + b)
        decode = tree.add("decode", device_ms=100.0 + b)
        tree.add("decode.hoist", decode, device_ms=1.0 + b)
        for _ in range(T):
            step = tree.add("decode.step", decode, device_ms=10.0)
            for name, ms in (("attend", 2.0), ("cell", 5.0), ("head", 3.0)):
                tree.add(f"decode.step.{name}", step, device_ms=ms)
        for _ in range(streams):
            tree.add("sample", device_ms=0.5)
    return tree.spans


def request_tree(units):
    """Request r: serve.forward of 50 + r host ms holding a trunk of 10
    and a decode of 30, whose T steps take 1 + r + k host ms and 0.5 + k
    device ms (step k); then a greedy sample."""
    tree = Tree()
    for r in range(units):
        serve = tree.add("serve.forward", host_ms=50.0 + r)
        tree.add("trunk", serve, host_ms=10.0)
        decode = tree.add("decode", serve, host_ms=30.0)
        tree.add("decode.hoist", decode)
        for k in range(T):
            tree.add("decode.step", decode, host_ms=1.0 + r + k,
                     device_ms=0.5 + k)
        tree.add("sample")
    return tree.spans


def stub_run(units, streams=1):
    return types.SimpleNamespace(trace=types.SimpleNamespace(units=units),
                                 counts={"streams": streams})


def read(name, spans, run, monkeypatch):
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    reader = harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                                 f"metric_{name.replace('.', '_')}")
    return reader.read(run, None)


@pytest.mark.parametrize("streams", [1, 2])
def test_generate_readers_give_the_mean_a_batch(streams, monkeypatch):
    spans = generate_tree(2, streams)
    want = {"trunk_span_ms.generate": 10.5, "decode_span_ms.generate": 100.5,
            "sample_span_ms.generate": 0.5 * streams,
            "hoist_ms.generate": 1.5, "attend_ms.generate": 2.0 * T,
            "cell_ms.generate": 5.0 * T, "head_ms.generate": 3.0 * T}
    for name in GENERATE:
        got = read(name, spans, stub_run(2, streams), monkeypatch)
        assert got == pytest.approx(want[name]), name


def test_request_readers_give_the_median_request(monkeypatch):
    spans = request_tree(3)
    # step host means 2, 3, 4; device means 1.5; self 10, 11, 12 ms
    want = {"step_host_ms.request": 3.0, "step_device_ms.request": 1.5,
            "serve_self_ms.request": 11.0}
    for name in REQUEST:
        got = read(name, spans, stub_run(3), monkeypatch)
        assert got == pytest.approx(want[name]), name


@pytest.mark.parametrize("name", GENERATE + REQUEST)
def test_nothing_to_read_gives_none(name, monkeypatch):
    spans = generate_tree(2, 1) if name in GENERATE else request_tree(2)
    assert read(name, [], stub_run(2), monkeypatch) is None
    untraced = types.SimpleNamespace(trace=None, counts={"streams": 1})
    assert read(name, spans, untraced, monkeypatch) is None
    # a program from before the tracing module
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "scanpaths_tpu_torch.utils.tracing",
                        None)
    reader = harness.load_module(harness.HERE / "metrics" / f"{name}.py",
                                 "metric_without_tracing")
    assert reader.read(stub_run(2), None) is None


@pytest.mark.parametrize("name", GENERATE + REQUEST)
def test_a_root_count_off_the_units_raises(name, monkeypatch):
    spans = generate_tree(2, 1) if name in GENERATE else request_tree(2)
    with pytest.raises(RuntimeError, match="spans for"):
        read(name, spans, stub_run(3), monkeypatch)


@pytest.mark.gpu
def test_spans_time_the_card_on_the_current_stream(card):
    # a span times the card once CUDA is initialised
    torch.zeros(1, device=card)
    side = torch.cuda.Stream()
    tracing.clear()
    tracing.enable()
    try:
        with tracing.span("default"):
            torch.cuda._sleep(2_000_000)
        with torch.cuda.stream(side):
            with tracing.span("side"):
                torch.cuda._sleep(2_000_000)
        got = {s.name: s.device_ms for s in tracing.spans()}
    finally:
        tracing.disable()
        tracing.clear()
    # two million cycles: ~1 ms at the card's clock; events recorded on
    # another stream than the sleep's would read ~0
    assert got["default"] > 0.2 and got["side"] > 0.2, got
