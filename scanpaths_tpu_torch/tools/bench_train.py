"""Training throughput at the reference geometry (the port of
``tools/bench_train.py``): the supervised and SCST steps of the OSIE
model (seed weights, its duration head calibrated) on batches made on
the device, each step's loss read on the host inside the timed window
and summed into a printed checksum.

    python -m scanpaths_tpu_torch.tools.bench_train      # the sweep
    python -m scanpaths_tpu_torch.tools.bench_train sup <batch>
    python -m scanpaths_tpu_torch.tools.bench_train rl <batch>
    python -m scanpaths_tpu_torch.tools.bench_train fwd <batch>
    python -m scanpaths_tpu_torch.tools.bench_train mem <batch>
    python -m scanpaths_tpu_torch.tools.bench_train pipeline <batch>
        [--device cuda|cpu] [--dtype bfloat16|float32] [--bf16_moments]
        [--iters N] [--tiny]

``sup`` reports images/s, ms a step and the MFU of the analytic
training FLOPs (``tools/flops.py``); ``fwd`` the forward and loss alone
(no gradient), the forward leg of the step; ``mem`` the peak memory a
supervised step allocates on the card with Adam's moments held;
``pipeline`` the native
packed-store loader's images/s at the batch.  An out-of-memory is
reported as data (``"oom": true``).  The sweep runs each configuration
in a fresh process: the supervised batches of ``SUP_SWEEP``, the two
fastest again with ``--bf16_moments``, the forward leg and the pipeline
at the fastest batch, and the SCST batches of ``RL_SWEEP``; then one
headline line.  The port has no remat, so the JAX tool's remat axis is
left out.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import bench_steps, common, flops

SUP_SWEEP = (16, 32, 64, 96)
RL_SWEEP = (4, 8, 16, 32)
WARMUP = 2


def _state(args, geo):
    return bench_steps.train_state(geo, args.device,
                                   getattr(torch, args.dtype),
                                   args.bf16_moments)


def bench_sup(args, geo, batch):
    from ..train import steps
    state = _state(args, geo)
    b = common.supervised_batch(
        common.random_images(batch, geo, args.device), geo)
    for _ in range(WARMUP):
        common.sync(steps.supervised_step(state, b, 1.0)["loss"])
    losses, t0 = [], time.perf_counter()
    for _ in range(args.iters):
        losses.append(common.sync(
            steps.supervised_step(state, b, 1.0)["loss"]))
    dt = (time.perf_counter() - t0) / args.iters
    train_flops = flops.train_flops_per_image(**common.flop_geometry(geo))
    return common.emit({
        "metric": "train_supervised_images_per_sec", "value": batch / dt,
        "batch": batch, "dtype": args.dtype, "step_ms": dt * 1e3,
        "train_flops_per_image": train_flops,
        "mfu": flops.mfu(batch * train_flops, dt, args.dtype),
        "bf16_moments": bool(args.bf16_moments),
        "checksum": float(np.sum(losses))})


def bench_fwd(args, geo, batch):
    """The training forward and loss alone, without gradient (BN on
    batch statistics, as the step's)."""
    from ..train import steps
    state = _state(args, geo)
    b = common.supervised_batch(
        common.random_images(batch, geo, args.device), geo)

    @torch.no_grad()
    def fwd():
        return steps.supervised_loss(state.model, b, 1.0)[0]
    for _ in range(WARMUP):
        common.sync(fwd())
    vals, t0 = [], time.perf_counter()
    for _ in range(args.iters):
        vals.append(common.sync(fwd()))
    dt = (time.perf_counter() - t0) / args.iters
    fwd_flops = flops.model_flops_per_image(**common.flop_geometry(geo))
    return common.emit({
        "metric": "train_forward_only_images_per_sec", "value": batch / dt,
        "batch": batch, "dtype": args.dtype, "fwd_ms": dt * 1e3,
        "fwd_mfu": flops.mfu(batch * fwd_flops, dt, args.dtype),
        "checksum": float(np.sum(vals))})


def mem_probe(args, geo, batch):
    """The peak memory a supervised step allocates on the card with
    Adam's moments held (the second step: the first allocates them
    after its backward), null on the CPU; and the moments' size."""
    from ..train import steps
    cuda = torch.device(args.device).type == "cuda"
    state = _state(args, geo)
    b = common.supervised_batch(
        common.random_images(batch, geo, args.device), geo)
    common.sync(steps.supervised_step(state, b, 1.0)["loss"])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    common.sync(steps.supervised_step(state, b, 1.0)["loss"])
    gib = 1 << 30
    return common.emit({
        "metric": "train_supervised_memory", "batch": batch,
        "dtype": args.dtype, "bf16_moments": bool(args.bf16_moments),
        "peak_gib": torch.cuda.max_memory_allocated() / gib if cuda
        else None,
        "state_gib": sum(t.numel() * t.element_size()
                         for st in state.optimizer.state.values()
                         for t in st.values() if torch.is_tensor(t)) / gib})


def bench_rl(args, geo, batch):
    from ..train import steps
    state = _state(args, geo)
    b = common.rl_batch(common.random_images(batch, geo, args.device), geo)
    cfg = bench_steps.rl_config(geo)
    gen = torch.Generator(device=args.device).manual_seed(1)
    for _ in range(WARMUP):
        common.sync(steps.rl_step(state, b, cfg, generator=gen)["rl_loss"])
    vals, t0 = [], time.perf_counter()
    for _ in range(args.iters):
        vals.append(common.sync(
            steps.rl_step(state, b, cfg, generator=gen)["rl_loss"]))
    dt = (time.perf_counter() - t0) / args.iters
    finite = [v for v in vals if np.isfinite(v)]
    return common.emit({
        "metric": "train_rl_images_per_sec", "value": batch / dt,
        "batch": batch, "rollouts": cfg.rl_sample_number, "subjects": 15,
        "dtype": args.dtype, "step_ms": dt * 1e3,
        "checksum": float(np.sum(finite)),
        "nan_loss_frac": 1 - len(finite) / len(vals)})


def bench_pipeline(args, geo, batch):
    """The native batch assembly over the packed store of
    ``synth.make_osie``'s train split (seed 0): a warm epoch, then four
    timed."""
    from .. import native
    from ..data.datasets import DataConfig, Loader, SupervisedDataset
    from .synth import make_osie
    before = os.environ.get("SP_NATIVE")
    os.environ["SP_NATIVE"] = "1"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = os.path.join(tmp, "osie")
            make_osie(root, np.random.default_rng(0))
            cfg = DataConfig(
                img_dir=os.path.join(root, "stimuli"),
                fix_dir=os.path.join(root, "fixations"),
                action_map=(geo["map_h"], geo["map_w"]),
                resize=(geo["height"], geo["width"]),
                max_length=geo["seq_len"], cache_images=False,
                packed_cache_dir=os.path.join(tmp, "packed"))
            loader = Loader(SupervisedDataset("osie", cfg, split="train"),
                            batch_size=batch, shuffle=True)
            for _ in loader:
                pass
            n, t0 = 0, time.perf_counter()
            for _ in range(4):
                for b in loader:
                    n += len(b["images"])
            dt = time.perf_counter() - t0
    finally:
        if before is None:
            os.environ.pop("SP_NATIVE", None)
        else:
            os.environ["SP_NATIVE"] = before
    return common.emit({"metric": "train_input_pipeline_images_per_sec",
                        "value": n / dt, "batch": batch,
                        "native": native.available()})


SECTIONS = {"sup": bench_sup, "fwd": bench_fwd, "mem": mem_probe,
            "rl": bench_rl, "pipeline": bench_pipeline}
OOM_METRIC = {"sup": "train_supervised_images_per_sec",
              "rl": "train_rl_images_per_sec",
              "fwd": "train_forward_only_images_per_sec",
              "mem": "train_supervised_memory"}


def run_section(args):
    try:
        return SECTIONS[args.section](args, common.geometry(args),
                                      args.batch)
    except Exception as e:            # noqa: BLE001 - an OOM is data
        if args.section not in OOM_METRIC or not common.is_oom(e):
            raise
        return common.emit({"metric": OOM_METRIC[args.section],
                            "batch": args.batch, "dtype": args.dtype,
                            "bf16_moments": bool(args.bf16_moments),
                            "value": 0.0, "oom": True})


def _run_one(section, batch, flags):
    """One configuration in a fresh process: its last JSON line."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    argv = [section, str(batch), *flags]
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "scanpaths_tpu_torch.tools.bench_train",
             *argv], capture_output=True, text=True, timeout=1800, cwd=root)
    except subprocess.TimeoutExpired:
        common.emit({"config": argv, "error": "timeout_1800s"})
        return None
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        print(line, flush=True)
        return rec
    sys.stderr.write(proc.stderr[-1500:])
    common.emit({"config": argv, "error": "fail"})
    return None


def sweep(flags):
    sup = [r for b in SUP_SWEEP if (r := _run_one("sup", b, flags))]
    ran = [r for r in sup if not r.get("oom")]
    best = max(ran, key=lambda r: r["value"], default=None)
    top = sorted(ran, key=lambda r: -r["value"])[:2]
    bf16 = [r for t in top
            if (r := _run_one("sup", t["batch"], flags + ["--bf16_moments"]))
            and not r.get("oom")]
    best_bf16 = max(bf16, key=lambda r: r["value"], default=None)
    fwd = best and _run_one("fwd", best["batch"], flags)
    rl = [r for b in RL_SWEEP if (r := _run_one("rl", b, flags))
          and not r.get("oom")]
    best_rl = max(rl, key=lambda r: r["value"], default=None)
    pipe = best and _run_one("pipeline", best["batch"], flags)
    return common.emit({
        "metric": "train_throughput_headline",
        "supervised_images_per_sec": best and best["value"],
        "supervised_batch": best and best["batch"],
        "supervised_mfu": best and best["mfu"],
        "supervised_bf16_moments_images_per_sec":
            best_bf16 and best_bf16["value"],
        "forward_only_ms": fwd and fwd.get("fwd_ms"),
        "rl_images_per_sec": best_rl and best_rl["value"],
        "rl_batch": best_rl and best_rl["batch"],
        "input_pipeline_images_per_sec": pipe and pipe["value"],
        "input_pipeline_saturates": bool(
            pipe and best and pipe["value"] >= best["value"])})


def main(argv=None):
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("section", nargs="?", choices=tuple(SECTIONS))
    p.add_argument("batch", nargs="?", type=int, default=16)
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--bf16_moments", action="store_true")
    p.add_argument("--iters", type=int, default=8)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    common.no_tf32()
    if args.section:
        return run_section(args)
    flags = [a for a in argv if a != "--bf16_moments"]
    return sweep(flags)


if __name__ == "__main__":
    main()
