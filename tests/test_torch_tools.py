"""The port's measuring tools (``scanpaths_tpu_torch/tools/``) on the
CPU: the analytic FLOP model equal to ``bench.py``'s, the synthetic
corpora byte-equal to ``tools/make_synth_data.py``'s for one seed, each
tool's ``main`` at the tests' tiny geometry (``--tiny --device cpu``)
printing parseable, finite JSON lines, an out-of-memory reported as
data, the training sweep's headline, and the convergence run at its
tiny size writing the artifact's keys.  The kernels' wrappers run their
plain versions here (the tensors lie on the CPU)."""

import contextlib
import io
import json
import math
import os
from unittest import mock

import numpy as np
import pytest
import torch

import test_torch_eval_ranks
from scanpaths_tpu_torch.tools import (bench_serving, bench_steps,
                                      bench_train, convergence_run, flops,
                                      profile_bench, synth)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(fn, *args, **kw):
    """The JSON lines ``fn`` prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(*args, **kw)
    return [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{")]


def _finite(rec):
    if isinstance(rec, dict):
        return all(_finite(v) for v in rec.values())
    return not isinstance(rec, float) or math.isfinite(rec)


GEOMETRIES = [dict(), dict(h=80, w=96, t=4, embed=64),
              dict(h=240, w=320, t=16, embed=128, fuse_head=False)]


@pytest.mark.parametrize("kw", GEOMETRIES, ids=["full", "tiny", "thin"])
def test_flops_equal_bench(kw):
    import bench
    assert flops.model_flops_parts(**kw) == bench.model_flops_parts(**kw)
    assert flops.model_flops_per_image(**kw) == \
        bench.model_flops_per_image(**kw)
    assert flops.train_flops_per_image("none", **kw) == \
        bench.train_flops_per_image("none", **kw)


def test_flops_layers_peak_and_mfu():
    """A thinner trunk counts fewer block FLOPs; the H100 peaks; an MFU
    over 1.0 raises."""
    thin = flops.model_flops_parts(layers=(1, 1, 1, 1))
    full = flops.model_flops_parts()
    assert thin["blocks"] < full["blocks"]
    assert thin["hoisted"] == full["hoisted"]
    assert flops.peak_flops(torch.bfloat16) == 989e12
    assert flops.peak_flops("float32") == 67e12
    assert flops.mfu(67e12, 2.0, "float32") == 0.5
    with pytest.raises(ValueError, match="MFU"):
        flops.mfu(989e12, 0.5, torch.bfloat16)
    with pytest.raises(ValueError, match="no remat"):
        flops.train_flops_per_image("backbone")


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("name,kw", [
    ("make_osie", dict(n_images=3, n_subjects=2)),
    ("make_osie_headroom", dict(n_train=4, n_val=2)),
    ("make_osie_structured", dict(n_train=3, n_val=1, n_blobs=4))])
def test_synth_byte_equal(name, kw, tmp_path):
    import tools.make_synth_data as msd
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    getattr(msd, name)(a, np.random.default_rng(7), **kw)
    getattr(synth, name)(b, np.random.default_rng(7), **kw)
    ta, tb = _tree(a), _tree(b)
    assert ta and ta == tb


TINY = ["--device", "cpu", "--tiny"]


CASES = {
    "steps-sup": (bench_steps, ["sup", "--iters", "1", "--sup_batch", "2"],
                  ["supervised_step_images_per_sec"]),
    "steps-rl": (bench_steps, ["rl", "--iters", "1", "--rl_batch", "2"],
                 ["rl_step_images_per_sec"]),
    "steps-nw": (bench_steps, ["nw", "--iters", "1", "--pairs", "16"],
                 ["nw_scanmatch_plain_pairs_per_sec",
                  "nw_scanmatch_kernel_pairs_per_sec",
                  "nw_kernel_vs_plain_max_abs_err"]),
    "steps-pipeline": (bench_steps, ["pipeline", "--sup_batch", "4"],
                       ["input_pipeline_jpeg_images_per_sec",
                        "input_pipeline_packed_images_per_sec",
                        "input_pipeline_packed_native_images_per_sec",
                        "input_pipeline_ram_cached_images_per_sec",
                        "input_pipeline_tensorize_native_images_per_sec"]),
    "steps-eval": (bench_steps, ["eval"],
                   ["eval_sweep_host_pairs_per_sec",
                    "eval_sweep_device_pairs_per_sec"]),
    "train-sup": (bench_train, ["sup", "2", "--iters", "1"],
                  ["train_supervised_images_per_sec"]),
    "train-sup-bf16": (bench_train,
                       ["sup", "2", "--iters", "1", "--bf16_moments"],
                       ["train_supervised_images_per_sec"]),
    "train-fwd": (bench_train, ["fwd", "2", "--iters", "1"],
                  ["train_forward_only_images_per_sec"]),
    "train-mem": (bench_train, ["mem", "2"], ["train_supervised_memory"]),
    "train-rl": (bench_train, ["rl", "2", "--iters", "1"],
                 ["train_rl_images_per_sec"]),
    "train-pipeline": (bench_train, ["pipeline", "4"],
                       ["train_input_pipeline_images_per_sec"]),
    "profile": (profile_bench, ["--batch", "2", "--iters", "1"],
                ["bench_component_breakdown"]),
    "serving": (bench_serving, ["--batches", "1,2", "--iters", "2"],
                ["greedy_serving_latency"]),
}


@pytest.mark.parametrize("tool,argv,metrics", list(CASES.values()),
                         ids=list(CASES))
def test_tool_main_prints_json(tool, argv, metrics):
    recs = _lines(tool.main, argv + TINY)
    assert [r["metric"] for r in recs] == metrics
    assert all(_finite(r) for r in recs)
    for r in recs:
        for k in ("mfu", "fwd_mfu", "mfu_full_step"):
            if k in r:
                assert 0 < r[k] <= 1.0
    if "--bf16_moments" in argv:
        assert recs[0]["bf16_moments"] is True
    if tool is bench_steps and argv[0] == "nw":
        assert recs[-1]["value"] == 0.0 and recs[-1]["nan_in_same_places"]


def test_bench_serving_from_a_bundle(tmp_path):
    """A greedy OSIE bundle exported at the tiny geometry serves through
    ``--bundle`` at its batch."""
    from scanpaths_tpu_torch.serve.export import export_bundle
    from scanpaths_tpu_torch.tools import common
    geo = common.TINY
    model = common.osie_model(geo, "cpu", calibrated=True).eval()
    export_bundle(str(tmp_path), model, common.grid_spec(geo),
                  decode="greedy", batch=2, platforms=("cpu",),
                  map_h=geo["map_h"], map_w=geo["map_w"])
    (rec,) = _lines(bench_serving.main, ["--bundle", str(tmp_path),
                                         "--iters", "2", "--device", "cpu"])
    assert rec["source"] == "bundle" and list(rec)[-1] == "batch2"
    assert _finite(rec)


def test_bench_train_reports_oom_as_data():
    def oom(*a, **kw):
        raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")
    with mock.patch.dict(bench_train.SECTIONS, {"sup": oom}):
        (rec,) = _lines(bench_train.main, ["sup", "96"] + TINY)
    assert rec["oom"] is True and rec["value"] == 0.0 and rec["batch"] == 96


def test_bench_train_sweep_headline():
    """The sweep's headline from its configurations' records: the fastest
    supervised batch that ran, its bf16-moment rerun, the SCST best."""
    def run_one(section, batch, flags):
        if section == "sup" and batch == 96 and not flags:
            return {"oom": True, "value": 0.0, "batch": 96}
        value = {"sup": 10.0 + batch, "rl": 5.0 - batch / 8,
                 "fwd": 1.0, "pipeline": 500.0}[section]
        if "--bf16_moments" in flags:
            value -= 1
        return {"value": value, "batch": batch, "mfu": 0.1,
                "fwd_ms": 12.5}
    with mock.patch.object(bench_train, "_run_one", run_one):
        (head,) = _lines(bench_train.sweep, [])
    assert head["supervised_batch"] == 64
    assert head["supervised_images_per_sec"] == 74.0
    assert head["supervised_bf16_moments_images_per_sec"] == 73.0
    assert head["rl_batch"] == 4 and head["input_pipeline_saturates"]


def test_convergence_run_tiny(tmp_path):
    """The convergence tool at its tiny size on the CPU writes the JAX
    artifact's layout and its five deltas."""
    out = str(tmp_path / "CONVERGENCE_TORCH.json")
    with contextlib.redirect_stdout(io.StringIO()), \
            test_torch_eval_ranks._no_tensorboard():
        convergence_run.main(["--device", "cpu", "--tiny", "--out", out,
                              "--data_root", str(tmp_path / "data")])
    with open(out) as f:
        art = json.load(f)
    assert set(art) == {"config", "supervised", "rl", "deltas"}
    assert set(art["deltas"]) == {
        "supervised_loss_decreased", "val_metric_improved_over_training",
        "rl_improved_over_supervised_save", "rl_reward_held", "rl_val_held"}
    assert art["config"]["device"] == "cpu" and art["config"]["wall_s"] > 0
    assert len(art["supervised"]["loss_curve_epoch_means"]) == 2
    assert len(art["rl"]["reward_epoch_means"]) == 1
    assert all(isinstance(v, bool) for v in art["deltas"].values())
