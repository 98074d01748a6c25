"""The port's spans and counters (``scanpaths_tpu_torch/utils/tracing.py``)
on the CPU at the tools' tiny geometry: off, a span is one shared
do-nothing context; on, an eval forward's span tree (the trunk, the
decoder's hoist and T steps of attend, cell and head) shares one root a
call; a profiler session turns the spans on and its end turns them off;
the spans' host clock lines up with the profiler's trace; the exported
serving graph holds nothing of them; the launch counters and the count
of conditioner+head compositions."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from scanpaths_tpu_torch.models.scanpath_model import ScanpathModel, \
    init_weights
from scanpaths_tpu_torch.serve import export as serve_export
from scanpaths_tpu_torch.tools import common
from scanpaths_tpu_torch.utils import tracing

GEO = common.TINY
STEP = ["decode.step.attend", "decode.step.cell", "decode.step.head"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _off():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def _model(task):
    model = ScanpathModel(task, embed=GEO["embed"], seq_len=GEO["seq_len"],
                          map_h=GEO["map_h"], map_w=GEO["map_w"],
                          backbone_layers=GEO["layers"])
    init_weights(model, 0)
    return model.eval()


def _inputs(task, n=1):
    images = common.random_images(n, GEO, "cpu")
    maps = None
    if task in ("air", "coco"):
        maps = torch.rand((n, GEO["map_h"], GEO["map_w"], 1),
                          generator=torch.Generator().manual_seed(1))
    return images, maps


@pytest.fixture(scope="module")
def osie():
    return _model("osie")


def test_off_is_one_shared_context_and_records_nothing(osie):
    assert tracing.span("trunk") is tracing.span("decode")
    with tracing.span("decode") as s:
        assert s is None
    osie(*_inputs("osie"))
    assert tracing.spans() == []


@pytest.mark.parametrize("task", ["osie", "air"])
def test_eval_forward_span_tree(task):
    model = _model(task)
    calls = 2
    tracing.enable()
    for _ in range(calls):
        with tracing.span("call"):
            model(*_inputs(task))
    tracing.disable()
    spans = tracing.spans()
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["call"] * calls
    # every span of a call carries the call's id as its root
    assert {s.root for s in spans} == {r.id for r in roots}
    for s in spans:
        if s.parent is not None:
            assert by_id[s.parent].root == s.root
        assert s.t0_ns <= s.t1_ns and s.device_ms is None

    def children(span_id):
        return [s for s in sorted(spans, key=lambda s: s.id)
                if s.parent == span_id]
    t = GEO["seq_len"]
    for root in roots:
        assert [s.name for s in children(root.id)] == ["trunk", "decode"]
        decode = children(root.id)[1]
        kids = children(decode.id)
        assert [s.name for s in kids] == ["decode.hoist"] + \
            ["decode.step"] * t
        assert [s.name for s in children(kids[0].id)] == \
            ["decode.hoist.compose"]
        for step in kids[1:]:
            assert [s.name for s in children(step.id)] == STEP
            for s in children(step.id):
                assert step.t0_ns <= s.t0_ns <= s.t1_ns <= step.t1_ns
    assert len(spans) == calls * (5 + 4 * t)


def test_a_profiler_session_turns_spans_on(osie):
    images, _ = _inputs("osie")
    with profile(activities=[ProfilerActivity.CPU]):
        osie(images)
    names = [s.name for s in tracing.spans()]
    assert names.count("trunk") == names.count("decode") == 1
    assert names.count("decode.step") == GEO["seq_len"]
    osie(images)
    assert len(tracing.spans()) == len(names)


def test_spans_share_the_profiler_clock(osie):
    """Each ``decode.step.cell`` span, shifted by the trace's start,
    holds that step's ``cell_step`` op event, to 100 us."""
    images, _ = _inputs("osie")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        osie(images)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    ops = sorted((e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if e.name == "scanpaths_tpu_torch::cell_step")
    cells = sorted(((s.t0_ns - start_ns) / 1e3, (s.t1_ns - start_ns) / 1e3)
                   for s in tracing.spans() if s.name == "decode.step.cell")
    assert len(ops) == len(cells) == GEO["seq_len"]
    slack = 100.0
    for (lo, hi), (a, b) in zip(cells, ops):
        assert lo - slack <= a <= b <= hi + slack


def _graph_nodes(model, grid, images):
    serve = serve_export.ServeModule(model, grid).eval()
    with torch.no_grad(), serve_export._SkipNoopCasts():
        program = torch.export.export(serve, (images,))
    return len(program.graph_module.graph.nodes)


def test_exported_graph_holds_no_span(monkeypatch):
    """The greedy serving graph (``serve/export.py``, one decode step to
    keep the export short) has as many nodes with the spans as with
    every span replaced by a plain null context."""
    model = ScanpathModel("osie", embed=32, seq_len=1, map_h=GEO["map_h"],
                          map_w=GEO["map_w"], backbone_layers=GEO["layers"])
    init_weights(model, 0)
    grid = common.grid_spec(dict(GEO, seq_len=1))
    images, _ = _inputs("osie")
    with_spans = _graph_nodes(model.eval(), grid, images)
    monkeypatch.setattr(tracing, "span",
                        lambda name: contextlib.nullcontext())
    assert _graph_nodes(model, grid, images) == with_spans
    assert tracing.spans() == []


def test_counters_and_launches():
    tracing.reset_counters("test.a")
    tracing.count("test.a")
    tracing.count("test.a", 4)
    assert tracing.counter("test.a") == 5
    assert tracing.counters()["test.a"] == 5
    assert tracing.counter("test.never") == 0
    tracing.reset_counters("test.a")
    assert tracing.counter("test.a") == 0
    assert set(tracing.launches()) == set(tracing.KERNELS)


@pytest.mark.parametrize("task, ids, composed", [
    ("osie", None, 1), ("air", None, 2), ("coco", [4, 4, 4], 18),
    ("coco", [0, 9, 17], 18), ("coco", [3, 11, 3], 18)])
def test_compositions_have_a_span_and_a_count(task, ids, composed):
    """An eval forward's ``decode.hoist`` holds one
    ``decode.hoist.compose``, and ``cond_head.composed`` rises by the
    conditioner entries composed with the head: 1 for OSIE, 2 for AiR,
    the whole bank of 18 for COCO whatever the target ids (all equal,
    all distinct, repeated); with spans off it does not rise."""
    model = _model(task)
    images, maps = _inputs(task, 3)
    task_ids = None if ids is None else torch.tensor(ids)
    tracing.reset_counters("cond_head.composed")
    model(images, maps, task_ids)
    assert tracing.counter("cond_head.composed") == 0
    tracing.enable()
    model(images, maps, task_ids)
    tracing.disable()
    assert tracing.counter("cond_head.composed") == composed
    spans = tracing.spans()
    hoist = [s for s in spans if s.name == "decode.hoist"]
    compose = [s for s in spans if s.name == "decode.hoist.compose"]
    assert len(hoist) == len(compose) == 1
    assert compose[0].parent == hoist[0].id
    assert hoist[0].t0_ns <= compose[0].t0_ns <= compose[0].t1_ns \
        <= hoist[0].t1_ns
