"""The decode-step split (``scanpaths_tpu_torch/tools/profile_scan.py``)
on the CPU at the tools' tiny geometry: its ``full`` variant is
``ScanpathModel._decode`` op for op (every step's outputs and the final
h and c bit for bit, float32 and bfloat16), each variant runs and
prints a finite line (no busy share off the card), and the trace check
that stands between a profile and its busy share."""

import contextlib
import io
import json
import math

import pytest
import torch

from scanpaths_tpu_torch.models import resnet
from scanpaths_tpu_torch.ops import cell as cell_ops
from scanpaths_tpu_torch.tools import common, profile_scan


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_full_variant_is_decode_bit_for_bit(monkeypatch, dtype):
    geo = dict(common.TINY)
    model = common.osie_model(geo, "cpu", dtype).eval()
    images = common.random_images(2, geo, "cpu")
    outs, h, c = profile_scan.scan(model, "full",
                                   profile_scan.hoist(model, images))

    states = []
    real = cell_ops.cell_step

    def recorded(*a):
        hn, cn = real(*a)
        states.append((hn.clone(), cn.clone()))
        return hn, cn
    monkeypatch.setattr(cell_ops, "cell_step", recorded)
    with torch.no_grad():
        x = resnet.fused_forward(model.backbone, images, dtype)
        (z, mu, sigma2, amap), = model._decode(x, None, None, False)
    assert len(outs) == len(states) == geo["seq_len"]
    for step, got in enumerate(outs):
        want = (z[:, step], mu[:, step], sigma2[:, step], amap[:, step])
        for name, g, w in zip(("z", "mu", "sigma2", "amap"), got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), (step, name)
    assert torch.equal(h, states[-1][0]) and torch.equal(c, states[-1][1])


def test_variants_print_finite_lines():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        recs = profile_scan.main(["--device", "cpu", "--tiny", "--batch",
                                  "2", "--iters", "1"])
    lines = [json.loads(l) for l in out.getvalue().splitlines()
             if l.startswith("{")]
    assert lines == recs and [r["dtype"] for r in recs] == [
        "float32", "bfloat16"]
    for rec in recs:
        assert rec["metric"] == "decode_step_split" and rec["t"] == 4
        assert set(rec["ms_per_step"]) == set(profile_scan.VARIANTS)
        assert all(math.isfinite(v) and v > 0
                   for v in rec["ms_per_step"].values())
        for k in ("signal", "head", "history"):
            assert math.isfinite(rec[f"{k}_ms_per_step"])
        assert rec["busy_share"] == dict.fromkeys(profile_scan.VARIANTS)
        assert rec["trace"] == dict.fromkeys(profile_scan.VARIANTS)
        assert rec["head_kernel_ms_per_step"] == dict.fromkeys(
            profile_scan.VARIANTS)
        assert rec["loops_per_variant"] == profile_scan.WARMUP + 1
        # the plain versions run on the CPU: no kernel launches
        assert rec["launches"] == {"cell_step": 0, "stage_apply": 0,
                                   "nw_scores_bins": 0, "cond_head": 0,
                                   "cond_compose": 0}


@pytest.mark.parametrize("case", ["whole", "lost_events", "past_span"])
def test_trace_check(case):
    """A loop's trace gives its busy share only with a cell-kernel event
    a step and its device time within the span."""
    spans = [(100.0 * i, 100.0 * i + 80.0) for i in range(16)]  # us
    cells, span_ms = 16, 1.7
    if case == "lost_events":
        cells = 7
    elif case == "past_span":
        span_ms = 1.2
    got = profile_scan.trace_problem(spans, cells, 16, span_ms)
    if case == "whole":
        assert got is None
    else:
        assert got is not None and (
            "7 cell-kernel events" in got if case == "lost_events"
            else "over a 1.200 ms span" in got)


def test_cell_variant_is_the_cell_without_signals():
    """The cell variant's zero signal inputs leave the cell's signal taps
    out: its state equals the plain step's with the taps zeroed."""
    geo = dict(common.TINY)
    model = common.osie_model(geo, "cpu").eval()
    hoisted = profile_scan.hoist(model, common.random_images(2, geo, "cpu"))
    _, h, c = profile_scan.scan(model, "cell", hoisted)
    h2 = torch.zeros_like(hoisted["visual"])
    c2 = torch.zeros_like(h2)
    kps = torch.zeros((2, 1, 9, 3 * geo["embed"]))
    maps = torch.randn(2, geo["map_h"], geo["map_w"], 1)
    with torch.no_grad():
        for _ in range(geo["seq_len"]):
            h2, c2 = cell_ops.cell_step_plain(h2, c2, hoisted["xg"], maps,
                                              kps, hoisted["kh"])
    torch.testing.assert_close(h, h2, rtol=0, atol=0)
    torch.testing.assert_close(c, c2, rtol=0, atol=0)
