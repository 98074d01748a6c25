"""Step and kernel benchmarks at the reference shapes (the port of
``tools/bench_steps.py``): the supervised and SCST train steps, the NW
ScanMatch kernel against its plain version, the host input pipeline and
the validation sweep on the device against the host suite.

    python -m scanpaths_tpu_torch.tools.bench_steps [sup|rl|nw|pipeline|eval|all]
        [--device cuda|cpu] [--dtype bfloat16|float32] [--iters N]
        [--sup_batch 16] [--rl_batch 4] [--pairs 512] [--tiny]

Prints one JSON line per measurement.  ``all`` runs each section in a
fresh process, so that no section's memory or caches reach another's
numbers.  The steps run the OSIE model with seed weights and its
duration head calibrated (``common.calibrate_duration_head``).
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import common

SECTIONS = ("sup", "rl", "nw", "pipeline", "eval")


def train_state(geo, device, dtype, bf16_moments=False, batches=100):
    """The TrainState of the calibrated seed OSIE model with the
    benchmarks' training flags."""
    from ..train import steps
    model = common.osie_model(geo, device, dtype, calibrated=True)
    return steps.TrainState.create(model, common.train_flags(bf16_moments),
                                   batches, batches, device=device)


def bench_sup(device, geo, dtype=torch.bfloat16, batch=16, iters=3):
    """Supervised steps at ``batch``: images/s and ms a step."""
    from ..train import steps
    state = train_state(geo, device, dtype)
    b = common.supervised_batch(common.random_images(batch, geo, device),
                                geo)
    dt = common.timed(lambda: steps.supervised_step(state, b, 1.0)["loss"],
                      iters)
    return common.emit({"metric": "supervised_step_images_per_sec",
                        "value": batch / dt, "batch": batch,
                        "dtype": str(dtype)[6:], "step_ms": dt * 1e3})


def rl_config(geo, rollouts=5, length=24):
    from ..train import steps
    return steps.RLConfig(task="osie", grid=common.grid_spec(geo),
                          rl_sample_number=rollouts, max_symbols_wd=320,
                          max_symbols_wod=length)


def bench_rl(device, geo, dtype=torch.bfloat16, batch=4, iters=3,
             rollouts=5, subjects=15, length=24):
    """SCST steps at ``batch`` x ``rollouts`` against ``subjects`` GT
    scanpaths of ``length`` fixations: images/s and ms a step."""
    from ..train import steps
    state = train_state(geo, device, dtype)
    b = common.rl_batch(common.random_images(batch, geo, device), geo,
                        subjects, length)
    cfg = rl_config(geo, rollouts, length)
    gen = torch.Generator(device=device).manual_seed(1)
    dt = common.timed(
        lambda: steps.rl_step(state, b, cfg, generator=gen)["rl_loss"],
        iters)
    return common.emit({"metric": "rl_step_images_per_sec",
                        "value": batch / dt, "batch": batch,
                        "rollouts": rollouts, "subjects": subjects,
                        "dtype": str(dtype)[6:], "step_ms": dt * 1e3})


def nw_inputs(device, pairs=512, length=24, symbols=320, seed=0):
    """(spec, quantized a, lengths a, quantized b, lengths b): ``pairs``
    random scanpaths of 5-``length`` fixations against the same rolled
    by one, quantized for the w/-duration table of ``symbols``."""
    from ..metrics import torch_metrics as tm
    rng = np.random.default_rng(seed)
    spec = tm.ScanMatchSpec(temp_bin=50.0, max_symbols=symbols)
    fix = np.zeros((pairs, length, 3), np.float32)
    fix[..., 0] = rng.uniform(0, 320, (pairs, length))
    fix[..., 1] = rng.uniform(0, 240, (pairs, length))
    fix[..., 2] = rng.uniform(0.1, 0.6, (pairs, length))
    lens = rng.integers(5, length + 1, pairs).astype(np.int32)
    fa = torch.as_tensor(fix, device=device)
    la = torch.as_tensor(lens, device=device)
    sa, na = tm.quantize(spec, fa, la)
    sb, nb = tm.quantize(spec, torch.roll(fa, 1, 0), torch.roll(la, 1, 0))
    return spec, sa.contiguous(), na.contiguous(), sb.contiguous(), \
        nb.contiguous()


def bench_nw(device, iters=3, chain=20, pairs=512):
    """The NW kernel (``ops/nw.py::nw_scores_bins``) and its plain
    version on the same pairs: pairs/s and ms a call (``chain`` calls an
    iteration), and the kernel's max abs error against the plain
    version."""
    from ..ops import nw
    spec, sa, na, sb, nb = nw_inputs(device, pairs)
    args = (spec.threshold, spec.xbin, spec.ybin, sa, na, sb, nb)
    out = []
    for name, fn in (("plain", nw.nw_scores_bins_plain),
                     ("kernel", nw.nw_scores_bins)):
        def many(fn=fn):
            acc = torch.zeros((), device=device)
            for _ in range(chain):
                acc = acc + torch.nan_to_num(fn(*args)).sum()
            return acc
        dt = common.timed(many, iters) / chain
        out.append(common.emit({
            "metric": f"nw_scanmatch_{name}_pairs_per_sec",
            "value": pairs / dt, "pairs": pairs, "table": spec.max_symbols,
            "ms": dt * 1e3}))
    got = nw.nw_scores_bins(*args)
    want = nw.nw_scores_bins_plain(*args)
    same_nan = bool(torch.equal(torch.isnan(got), torch.isnan(want)))
    err = float(torch.nan_to_num(got - want).abs().max())
    out.append(common.emit({"metric": "nw_kernel_vs_plain_max_abs_err",
                            "value": err, "nan_in_same_places": same_nan}))
    return out


def bench_pipeline(geo, batch=16):
    """Host input pipeline images/s over ``synth.make_osie``'s train split
    (seed 0): JPEG decode and the packed store, each with the numpy and
    the native batch assembly, and the RAM cache; one warm epoch, one
    timed."""
    from .. import native
    from ..data.datasets import DataConfig, Loader, SupervisedDataset
    from .synth import make_osie
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "osie")
        make_osie(root, np.random.default_rng(0))
        base = dict(img_dir=os.path.join(root, "stimuli"),
                    fix_dir=os.path.join(root, "fixations"),
                    action_map=(geo["map_h"], geo["map_w"]),
                    resize=(geo["height"], geo["width"]),
                    max_length=geo["seq_len"])
        before = os.environ.get("SP_NATIVE")

        def run(name, use_native, **kw):
            os.environ["SP_NATIVE"] = "1" if use_native else "0"
            ds = SupervisedDataset("osie", DataConfig(**base, **kw),
                                   split="train")
            loader = Loader(ds, batch_size=batch, shuffle=True)
            for _ in loader:
                pass
            t0, n = time.perf_counter(), 0
            for b in loader:
                n += len(b["images"])
            dt = time.perf_counter() - t0
            out.append(common.emit({
                "metric": f"input_pipeline_{name}_images_per_sec",
                "value": n / dt, "images": n,
                "native": bool(use_native and native.available())}))
        try:
            run("jpeg", False, cache_images=False)
            packed = os.path.join(tmp, "packed")
            run("packed", False, cache_images=False, packed_cache_dir=packed)
            run("packed_native", True, cache_images=False,
                packed_cache_dir=packed)
            run("ram_cached", False, cache_images=True)
            run("tensorize_native", True, cache_images=True)
        finally:
            if before is None:
                os.environ.pop("SP_NATIVE", None)
            else:
                os.environ["SP_NATIVE"] = before
    return out


def bench_eval(device, images=32, subjects=8, reps=5):
    """The validation sweep of ``images`` predictions against
    ``subjects`` GT scanpaths each: the host suite, the device pair rows
    (``metrics/device_eval.py::pair_rows``) and the whole
    ``DeviceSweep`` with its aggregation; pairs/s and ms."""
    from ..core.grid import fix_vector, pad_fix_vectors
    from ..metrics import evaluation as heval
    from ..metrics import torch_metrics as tm
    from ..metrics.device_eval import DeviceSweep, pair_rows
    rng = np.random.default_rng(0)

    def path(n):
        return fix_vector(rng.integers(0, 40, n) * 8 + 4.0,
                          rng.integers(0, 30, n) * 8 + 4.0,
                          rng.integers(2, 12, n) * 0.05)
    gts = [[path(int(rng.integers(4, 14))) for _ in range(subjects)]
           for _ in range(images)]
    preds = [path(int(rng.integers(4, 14))) for _ in range(images)]
    t0 = time.perf_counter()
    heval.evaluation(gts, preds)
    host_dt = time.perf_counter() - t0

    spec_wd = tm.ScanMatchSpec(temp_bin=50.0, max_symbols=192)
    spec_wod = tm.ScanMatchSpec(temp_bin=0.0, max_symbols=16)
    length = 16
    gt = [pad_fix_vectors(g, length, subjects) for g in gts]
    gt_fix = torch.as_tensor(np.stack([g[0] for g in gt]), device=device)
    gt_len = torch.as_tensor(np.stack([g[1] for g in gt]), device=device)
    gt_mask = torch.as_tensor(np.stack([g[2] for g in gt]), device=device)
    pred_fix, pred_len = pad_fix_vectors(preds, length)
    pred_fix = torch.as_tensor(pred_fix, device=device)
    pred_len = torch.as_tensor(pred_len, device=device)
    args = (spec_wd, spec_wod, gt_fix, gt_len, pred_fix, pred_len)
    dev_dt = common.timed(
        lambda: torch.nan_to_num(pair_rows(*args)).sum(), reps, warmup=1)

    def sweep():
        s = DeviceSweep(spec_wd, spec_wod)
        s.add_batch(gt_fix, gt_len, gt_mask, pred_fix, pred_len)
        s.result()
    sweep()                                       # warm
    t0 = time.perf_counter()
    sweep()
    full_dt = time.perf_counter() - t0
    pairs = images * subjects
    return [common.emit({"metric": "eval_sweep_host_pairs_per_sec",
                         "value": pairs / host_dt, "ms": host_dt * 1e3}),
            common.emit({"metric": "eval_sweep_device_pairs_per_sec",
                         "value": pairs / dev_dt, "ms": dev_dt * 1e3,
                         "speedup_kernel": host_dt / dev_dt,
                         "speedup_incl_aggregation": host_dt / full_dt})]


def run_section(section, args):
    geo = common.geometry(args)
    dtype = getattr(torch, args.dtype)
    if section == "sup":
        return [bench_sup(args.device, geo, dtype, args.sup_batch,
                          args.iters)]
    if section == "rl":
        return [bench_rl(args.device, geo, dtype, args.rl_batch, args.iters)]
    if section == "nw":
        return bench_nw(args.device, args.iters, pairs=args.pairs)
    if section == "pipeline":
        return bench_pipeline(geo, args.sup_batch)
    return bench_eval(args.device)


def main(argv=None):
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("section", nargs="?", default="all",
                   choices=SECTIONS + ("all",))
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--sup_batch", type=int, default=16)
    p.add_argument("--rl_batch", type=int, default=4)
    p.add_argument("--pairs", type=int, default=512,
                   help="the NW section's scanpath pairs")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    common.no_tf32()
    if args.section != "all":
        return run_section(args.section, args)
    rest = [a for a in argv if a != "all"]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for section in SECTIONS:
        proc = subprocess.run(
            [sys.executable, "-m", "scanpaths_tpu_torch.tools.bench_steps",
             section, *rest], capture_output=True, text=True, cwd=root)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr)
        if proc.returncode:
            raise SystemExit(proc.returncode)
    return None


if __name__ == "__main__":
    main()
