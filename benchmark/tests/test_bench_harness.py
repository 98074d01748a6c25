"""The benchmark's files, its yardstick and its refusals, on the CPU:
``BENCHMARK.json`` and every file it names are found by name and keep
the contract's rules; nothing the harness loads imports JAX or the JAX
package; the roofline, FLOP, trace and statistics arithmetic gives known
answers; and a run refuses to start without a card."""

import json
import math
import pathlib
import re
import statistics
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.reference import compare
from benchmark.yardstick import flops, roofline, stats, trace

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # a full check of 24 cells fits its time
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= cells <= 24
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, cells // 4)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_metrics_keep_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] == 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    assert 1 <= len(BENCH["per_layer"]) <= 128
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        # every cell the metric lists reports the metric it moves
        for cell in m["workloads"]:
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    for cell in cells:
        got = [m for m in BENCH["end_to_end"]
               if cell in m.get("workloads", cells)]
        assert len(got) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = harness.Cell.find(cell)
    assert c.cfg["name"] == c.entry["config"]
    assert (harness.HERE / "drivers" / f"{c.mix['driver']}.py").is_file()
    assert set(c.spec["limits"]) == set(compare.NUMBERS)
    assert all(v >= 0 for v in c.spec["limits"].values())
    assert c.spec["limits"]["decode"] == 0
    assert c.spec["check_units"] >= 1
    for m in c.per_layer():
        reader = harness.HERE / "metrics" / f"{m['name']}.py"
        assert reader.is_file(), reader
        assert hasattr(harness.load_module(reader, "r"), "read")
    names = {m["name"] for m in c.end_to_end()}
    assert "setup_s" in names and len(names) >= 2
    # every file under the benchmark is named from a name's characters
    for path in harness.HERE.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_config_files_state_the_published_widths():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
        assert (cfg["height"], cfg["width"]) == (240, 320)
        assert (cfg["map_height"], cfg["map_width"]) == (30, 40)
        assert (cfg["embed"], cfg["max_length"]) == (512, 16)
        assert cfg["backbone_layers"] == [3, 4, 6, 3]
        assert cfg["dtype"] == "float32" and cfg["tf32"] is False


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for line in path.read_text().splitlines():
        m = re.match(r"\s*(?:from|import)\s+([A-Za-z_][\w.]*)", line)
        if m:
            names.add(m.group(1).split(".")[0])
    return names


def test_no_source_line_imports_jax_or_the_jax_package():
    for path in harness.HERE.rglob("*.py"):
        top = _imports(path)
        assert not top & set(harness.FORBIDDEN), path
        if "reference" in path.parts or "yardstick" in path.parts:
            assert "scanpaths_tpu_torch" not in top, path


def test_a_run_loads_no_jax():
    """Every module of the harness, the drivers and the readers, then a
    tiny run on the CPU, in a fresh process: no JAX or JAX package
    module is loaded (top-level names compared whole)."""
    code = (
        "import sys, time, torch\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from benchmark import harness\n"
        "import conftest\n"
        "for p in sorted(harness.HERE.glob('[dm]*/*.py')):\n"
        "    harness.load_module(p, p.stem.replace('.', '_'))\n"
        "out = conftest.run_tiny('osie.request', seconds=0.1)\n"
        "assert out.correct, out.numbers\n"
        "print(harness.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "scanpaths_tpu_torch_like", sys)
    assert "scanpaths_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax.numpy"]


def test_a_run_refuses_to_start_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "osie.generate",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == harness.NO_CARD
    assert "{" not in proc.stdout
    assert "CUDA card" in proc.stderr


def test_rooflines_match_the_smoke_formulas():
    import chip_smoke
    f32 = torch.float32
    for n, s in ((1, 1), (16, 1), (16, 2)):
        assert roofline.cell_bound(n, 30, 40, 512, s, "float32") == \
            chip_smoke.cell_bound(n, 30, 40, 512, s, f32)
    shapes = roofline.stage_shapes(240, 320, (3, 4, 6, 3))
    assert shapes == [(60, 80, 256, 64, 2), (60, 80, 512, 128, 3),
                      (30, 40, 1024, 256, 5)]
    for h, w, c, m, nb in shapes:
        assert roofline.stage_work(16, h, w, c, m, nb, "float32") == \
            chip_smoke.stage_work(16, h, w, c, m, nb, f32)
    assert roofline.stage_bound_ms(16, 240, 320, (3, 4, 6, 3),
                                   "float32") == pytest.approx(sum(
        chip_smoke._bound(*chip_smoke.stage_work(16, *s, f32),
                          chip_smoke.PEAK_FLOPS[f32])[0] for s in shapes))
    # the f32 cell at N = 8 is bound by its operations: 2.709 ms
    # (PERF.md's kernel table)
    ms, by = roofline.cell_bound(8, 30, 40, 512, 1, "float32")
    assert by == "operations" and ms == pytest.approx(2.709, abs=1e-3)
    assert roofline.nw_bound(100, 2, 10, 10) == chip_smoke._bound(
        1100, 4 * (2 * 20 + 6), chip_smoke.PEAK_FLOPS[f32])


def test_shares_over_the_peak_raise():
    assert roofline.share(1.0, 2.0, "k") == 50.0
    with pytest.raises(ValueError):
        roofline.share(2.0, 1.0, "k")
    assert flops.mfu_pct(67e12, 2.0) == pytest.approx(50.0)
    with pytest.raises(ValueError):
        flops.mfu_pct(67e12, 0.5)


def test_flops_extend_the_program_count_to_streams():
    from scanpaths_tpu_torch.tools import flops as tool_flops
    one = flops.flops_per_image(streams=1)
    assert one == pytest.approx(tool_flops.model_flops_per_image())
    p = flops.model_flops_parts()
    assert flops.flops_per_image(streams=2) - one == \
        pytest.approx(p["t"] * p["step_other"])
    # about 476 GFLOP an OSIE image (docs: 476 analytic GFLOP)
    assert 4.0e11 < one < 5.5e11


def _trace():
    # two units of 10 us each; kernels of 2 + 3 us (one overlapping), a
    # copy, and an annotation-free gap in the second unit
    dev = [("void cell_f32(x)", 1.0, 3.0), ("void conv_f32<9, 0>(y)", 2.0, 5.0),
           ("Memcpy DtoH", 6.0, 7.0), ("void cell_f32(x)", 12.0, 14.0)]
    spans = [("unit", 0.0, 10.0), ("trunk", 0.5, 5.5), ("unit", 10.0, 20.0),
             ("decode", 11.0, 19.0)]
    return trace.Trace(device=dev, spans=spans, units=2, window=(0.0, 20.0))


def test_trace_arithmetic_gives_known_answers():
    tr = _trace()
    assert trace.union_us([(0, 2), (1, 3), (5, 6)]) == 4
    assert tr.busy_us() == 4 + 1 + 2
    assert tr.idle_pct() == pytest.approx(100 * 13 / 20)
    assert tr.kernel_ms(("cell_f32",)) == (4e-3, 2)
    assert tr.busy_inside_ms(10.0, 20.0) == pytest.approx(2e-3)
    assert tr.problem(("cell_f32",), 2) is None
    assert "2 events" in tr.problem(("cell_f32",), 3)
    assert tr.top_ops(2) == [["void cell_f32(x)", 4e-6],
                             ["void conv_f32<9, 0>(y)", 3e-6]]
    # gaps: 0-1 (trunk), 5-6 (trunk at 5.5), 7-12 (unit at 9.5: between
    # the first unit's end and the decode's start), 14-20 (decode)
    gaps = tr.idle_gaps(10)
    assert gaps[0] == ["decode", pytest.approx(6e-6)]
    assert gaps[1] == ["unit", pytest.approx(5e-6)]
    assert sorted(g[0] for g in gaps[2:]) == ["trunk", "trunk"]
    late = trace.Trace(device=[("cell_f32", 0.0, 30.0)], spans=[],
                       units=1, window=(0.0, 20.0))
    assert "over a" in late.problem(("cell_f32",), 1)


def _outcome(tr, **counts):
    return harness.Outcome(
        attempted=1, failed=0, setup_s=1.0, window_s=1.0, e2e={},
        peak_bytes=0, numbers={}, limits={}, counts=counts,
        spans={"trunk": [1.0, 3.0], "decode": [5.0], "sample": []},
        trace=tr)


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py", "r")


def test_readers_give_known_answers():
    cell = harness.Cell.find("osie.generate")
    # 16 cell calls of 1 ms, then 4 ms of the stage kernel, in a 40 ms
    # unit at batch 1
    dev = [("void cell_f32(a)", i * 1e3, (i + 1) * 1e3) for i in range(16)]
    tr = trace.Trace(device=dev + [("void conv_f32<1, 1>(b)", 16e3, 20e3)],
                     spans=[("unit", 0.0, 4e4)], units=1, window=(0.0, 4e4))
    run = _outcome(tr, batch=1, streams=1, images=100)
    run.window_s = 10.0
    got = _reader("cell_roofline.generate").read(run, cell)
    assert got == pytest.approx(100 * roofline.cell_bound(
        1, 30, 40, 512, 1, "float32")[0] / 1.0)
    got = _reader("stage_roofline.generate").read(run, cell)
    assert got == pytest.approx(100 * roofline.stage_bound_ms(
        1, 240, 320, (3, 4, 6, 3), "float32") / 4.0)
    assert _reader("trunk_ms.generate").read(run, cell) == 2.0
    assert _reader("decode_ms.generate").read(run, cell) == 5.0
    assert _reader("sample_ms.generate").read(run, cell) is None
    assert _reader("device_idle.generate").read(run, cell) == \
        pytest.approx(50.0)
    assert _reader("mfu.generate").read(run, cell) == pytest.approx(
        100 * flops.flops_per_image() * 100 / 10.0 / 67e12)
    assert _reader("host_ms.request").read(run, cell) == pytest.approx(20.0)
    # an untraced run has nothing to read; a short trace raises
    bare = _outcome(None, batch=1, streams=1, images=1)
    assert _reader("cell_roofline.generate").read(bare, cell) is None
    short = trace.Trace(device=tr.device[:3], spans=tr.spans, units=1,
                        window=tr.window)
    with pytest.raises(RuntimeError):
        _reader("device_idle.generate").read(
            _outcome(short, batch=1, streams=1), cell)


def test_statistics_give_known_answers():
    assert stats.percentile(range(1, 101), 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile(range(1, 21), 95) == 19
    vals = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, _, q3 = statistics.quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / 3.5)
    assert math.isclose(stats.spread([2.0] * 6), 0.0)
