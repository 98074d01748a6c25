#!/usr/bin/env python3
"""Smoke run of the PyTorch port (scanpaths_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each reporting on its own lines:

1. device: fails unless CUDA is available; prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles the port's CUDA kernels from csrc/ and prints the
   build time and the compiler's register/spill report;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the main path's shapes and a ragged small one, in float32 (TF32
   off) and bfloat16; prints the max abs error and the times, fails
   beyond the tolerance;
4. slice: serves 12 images through scanpaths_tpu_torch.cli.predict at
   full width (ResNet-50, embed 512, 240x320, T=16, batch 8, weights
   from a seed), greedy and sampled, float32 and bfloat16; checks the
   records and that every forward launched the cell kernel 16 times and
   the stage kernel 3 times; then runs one forward through the kernels
   and through the plain versions and compares them;
5. prints the kernels' JSON line, then {"ok": true, "device": ...} as
   the last line.

Any failed check raises, so the script exits non-zero and prints no
result line.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

F32_TOL = 1e-4   # atol = rtol, float32 with TF32 off
BF16_TOL = 2e-2  # atol = rtol, bfloat16 storage, float32 accumulation
IMAGES = 12
BATCH = 8
SEQ = 16


def _close(name, got, want, tol, scaled=False):
    """Max abs error of ``got`` against ``want``; raises unless every
    element is within tol + tol * |want|.  ``scaled`` measures the
    absolute part against the tensor's largest value instead
    (tol * max(1, max |want|)): inside the served forward the seed-weight
    activations reach ~100 (the layer-3 residual stream), a float32 sum
    of thousands of such terms differs by ~1e-6 of that scale between
    two summation orders, and an element that is small after
    cancellation cannot meet a bound relative to itself."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    atol = tol * max(1.0, float(want.abs().max())) if scaled else tol
    bad = err > atol + tol * want.abs()
    max_err = float(err.max())
    if not bool(torch.isfinite(got).all()) or bool(bad.any()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version "
            f"(max abs err {max_err:.3g}, tol {tol}, "
            f"{int(bad.sum())} elements out)")
    return max_err


def _time_ms(fn, iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _pair_ms(kernel_fn, plain_fn, iters):
    """Kernel and plain times in turns (plain, kernel, kernel, plain),
    after one warm-up call each."""
    kernel_fn()
    plain_fn()
    torch.cuda.synchronize()
    p1 = _time_ms(plain_fn, iters)
    k1 = _time_ms(kernel_fn, iters)
    k2 = _time_ms(kernel_fn, iters)
    p2 = _time_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _cell_inputs(n, h, w, c, s, dtype, gen):
    dev = "cuda"

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)
    return dict(h=rnd(n, h, w, c, std=0.5), c=rnd(n, h, w, c),
                xg=rnd(n, h, w, 4 * c), smaps=rnd(n, h, w, s, std=0.3),
                kps=rnd(n, s, 9, 3 * c, std=0.3),
                kh=rnd(3, 3, c, 4 * c, std=math.sqrt(1.0 / (9 * c))))


def _stage_inputs(n, h, w, c, m, nb, dtype, gen):
    dev = "cuda"

    def rnd(*shape, std=1.0, dt=dtype):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dt)
    f32 = torch.float32
    return dict(x=torch.relu(rnd(n, h, w, c)),
                w1=rnd(nb, c, m, std=math.sqrt(1.0 / c)),
                b1=rnd(nb, m, std=0.1, dt=f32),
                w2=rnd(nb, 9 * m, m, std=math.sqrt(1.0 / (9 * m))),
                b2=rnd(nb, m, std=0.1, dt=f32),
                w3=rnd(nb, m, c, std=0.5 * math.sqrt(1.0 / m)),
                b3=rnd(nb, c, std=0.1, dt=f32))


def check_kernels(cell, block):
    """Phase 3; returns {kernel: {"max_abs_err", "ms", "plain_ms"}} at
    the main path's shapes in float32."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = {}
    cell_cases = [("main S=1", (BATCH, 30, 40, 512, 1)),
                  ("main S=2", (BATCH, 30, 40, 512, 2)),
                  ("ragged", (3, 7, 9, 64, 1))]
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        dname = str(dtype).split(".")[-1]
        for label, shape in cell_cases:
            a = _cell_inputs(*shape, dtype, gen)
            c_k, c_p = a["c"].clone(), a["c"].clone()
            args = (a["xg"], a["smaps"], a["kps"], a["kh"])
            h_k, _ = cell.cell_step(a["h"], c_k, *args)
            h_p, _ = cell.cell_step_plain(a["h"], c_p, *args)
            torch.cuda.synchronize()
            err = max(_close(f"cell {label} {dname} h'", h_k, h_p, tol),
                      _close(f"cell {label} {dname} c'", c_k, c_p, tol))
            line = f"[kernels] cell {label} {shape} {dname}: max_abs_err {err:.3g}"
            if label.startswith("main"):
                c_t = a["c"].clone()
                ms, plain_ms = _pair_ms(
                    lambda: cell.cell_step(a["h"], c_t, *args),
                    lambda: cell.cell_step_plain(a["h"], c_t, *args), 5)
                line += f", {ms:.3f} ms (plain {plain_ms:.3f} ms)"
                if label == "main S=1" and dtype == torch.float32:
                    summary["cell_step"] = dict(max_abs_err=err, ms=ms,
                                                plain_ms=plain_ms)
            print(line, flush=True)

    stage_cases = [("layer1", (60, 80, 256, 64, 2, 1)),
                   ("layer2", (60, 80, 512, 128, 3, 1)),
                   ("layer3", (30, 40, 1024, 256, 5, 2)),
                   ("ragged", (7, 9, 64, 32, 2, 2))]
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        dname = str(dtype).split(".")[-1]
        total = [0.0, 0.0]
        errs = []
        for label, (h, w, c, m, nb, dil) in stage_cases:
            a = _stage_inputs(2, h, w, c, m, nb, dtype, gen)
            ws = (a["w1"], a["b1"], a["w2"], a["b2"], a["w3"], a["b3"])
            y_k = block.stage_apply(a["x"], dil, *ws)
            y_p = block.stage_apply_plain(a["x"], dil, *ws)
            torch.cuda.synchronize()
            err = _close(f"stage {label} {dname}", y_k, y_p, tol)
            errs.append(err)
            line = (f"[kernels] stage {label} N=2 {h}x{w} C={c} M={m} "
                    f"B={nb} dil={dil} {dname}: max_abs_err {err:.3g}")
            if label != "ragged":
                # timed at the served batch
                b = _stage_inputs(BATCH, h, w, c, m, nb, dtype, gen)
                wb = (b["w1"], b["b1"], b["w2"], b["b2"], b["w3"], b["b3"])
                ms, plain_ms = _pair_ms(
                    lambda: block.stage_apply(b["x"], dil, *wb),
                    lambda: block.stage_apply_plain(b["x"], dil, *wb), 5)
                total[0] += ms
                total[1] += plain_ms
                line += f", N={BATCH}: {ms:.3f} ms (plain {plain_ms:.3f} ms)"
            print(line, flush=True)
        print(f"[kernels] stage layers 1-3 N={BATCH} {dname}: "
              f"{total[0]:.3f} ms (plain {total[1]:.3f} ms)", flush=True)
        if dtype == torch.float32:
            summary["stage_apply"] = dict(max_abs_err=max(errs[:3]),
                                          ms=total[0], plain_ms=total[1])
    return summary


def _check_records(records, n_images, n_rollouts, width, height):
    if len(records) != n_images * n_rollouts:
        raise AssertionError(f"{len(records)} records, expected "
                             f"{n_images * n_rollouts}")
    for r in records:
        if set(r) != {"name", "repeat_id", "X", "Y", "T", "length"}:
            raise AssertionError(f"record keys {sorted(r)}")
        n = r["length"]
        if not (0 <= n <= SEQ and len(r["X"]) == len(r["Y"]) == len(r["T"])
                == n):
            raise AssertionError(f"record lengths {r}")
        vals = np.asarray(r["X"] + r["Y"] + r["T"], np.float64)
        if not np.isfinite(vals).all():
            raise AssertionError(f"non-finite record {r}")
        if any(not 0 <= x <= width for x in r["X"]) or \
                any(not 0 <= y <= height for y in r["Y"]) or \
                any(t < 0 for t in r["T"]):
            raise AssertionError(f"record out of range {r}")


def run_slice(cell, block, predict, tmp):
    """Phase 4; returns the launch counts of the served runs."""
    from PIL import Image
    rng = np.random.default_rng(0)
    img_dir = os.path.join(tmp, "images")
    os.makedirs(img_dir)
    for i in range(IMAGES):
        Image.fromarray(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)) \
            .save(os.path.join(img_dir, f"img_{i:02d}.png"))
    common = ["--task", "osie", "--predict_images", img_dir,
              "--batch", str(BATCH), "--embed", "512",
              "--backbone_layers", "3,4,6,3", "--height", "240",
              "--width", "320", "--map_height", "30", "--map_width", "40",
              "--max_length", str(SEQ), "--seed", "0", "--device", "cuda"]
    runs = [("greedy", "false"), ("sample", "false"), ("greedy", "true"),
            ("sample", "true")]
    forwards = -(-IMAGES // BATCH)
    cell.cell_launches = 0
    block.block_launches = 0
    for decode, half in runs:
        c0, b0 = cell.cell_launches, block.block_launches
        t0 = time.perf_counter()
        records = predict.main(common + [
            "--decode", decode, "--num_samples", "10",
            "--half_precision", half,
            "--predict_out", os.path.join(tmp, f"{decode}_{half}.json")])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        _check_records(records, IMAGES, 10 if decode == "sample" else 1,
                       320, 240)
        dc, db = cell.cell_launches - c0, block.block_launches - b0
        if dc != SEQ * forwards or db != 3 * forwards:
            raise AssertionError(
                f"{decode} half={half}: {forwards} forwards launched the "
                f"cell kernel {dc} times and the stage kernel {db} times "
                f"(expected {SEQ * forwards} and {3 * forwards})")
        print(f"[slice] predict --decode {decode} --half_precision {half}: "
              f"{len(records)} records from {IMAGES} images, {forwards} "
              f"forwards, cell launches {dc}, stage launches {db}, "
              f"{secs:.2f} s wall (model build and image load included)",
              flush=True)
    return {"cell_step": cell.cell_launches,
            "stage_apply": block.block_launches}


# Input scale of the whole-output comparison.  The seed-weight network
# at full width is saturated on unit-scale inputs (|h| grows by one per
# decode step), and there the 16-step recurrence roughly triples a
# float-reassociation difference each step: the kernel and plain
# forwards then end ~0.5 apart in the probabilities although every
# kernel call agrees with its plain version to ~1e-6 (measured on an
# H100).  At a tenth of the scale the network is not saturated and the
# whole outputs are comparable at the float32 tolerance.
COMPARE_SCALE = 0.1


def compare_forward(cell, block, predictor_mod):
    """Full-width forwards through the kernels and the plain versions on
    the same weights and images: every kernel call of the served
    forward checked against its plain version on the same inputs, the
    whole outputs compared at COMPARE_SCALE, and both forwards timed."""
    from scanpaths_tpu.core.config import parse_opt
    images = np.random.default_rng(1).standard_normal(
        (BATCH, 240, 320, 3)).astype(np.float32)

    def plain():
        return (mock.patch.object(cell, "cell_step", cell.cell_step_plain),
                mock.patch.object(block, "stage_apply",
                                  block.stage_apply_plain))

    for half, tol in (("false", F32_TOL), ("true", BF16_TOL)):
        args = parse_opt(["--task", "osie", "--seed", "0",
                          "--half_precision", half])
        pred = predictor_mod.Predictor(args, "cuda")
        errs = {"cell_step": [], "stage_apply": []}
        cell_k, stage_k = cell.cell_step, block.stage_apply

        def checked_cell(h, c, *a):
            c_p = c.clone()
            h_k, c_k = cell_k(h, c, *a)
            h_p, c_p = cell.cell_step_plain(h, c_p, *a)
            errs["cell_step"].append(max(
                _close("cell in forward", h_k, h_p, tol, scaled=True),
                _close("cell in forward", c_k, c_p, tol, scaled=True)))
            return h_k, c_k

        def checked_stage(x, dil, *w):
            y_k = stage_k(x, dil, *w)
            errs["stage_apply"].append(_close(
                "stage in forward", y_k, block.stage_apply_plain(x, dil, *w),
                tol, scaled=True))
            return y_k

        with mock.patch.object(cell, "cell_step", checked_cell), \
                mock.patch.object(block, "stage_apply", checked_stage):
            pred.forward(images)
        torch.cuda.synchronize()
        print(f"[slice] forward half={half}: each kernel call checked "
              f"against its plain version on the same inputs: "
              + ", ".join(f"{k} {len(v)} calls, max abs err {max(v):.3g}"
                          for k, v in errs.items()), flush=True)

        def kern(x=images):
            return pred.forward(x)

        def ref(x=images):
            p1, p2 = plain()
            with p1, p2:
                return pred.forward(x)
        out_k, out_p = kern(), ref()
        for k in out_k:
            if not bool(torch.isfinite(out_k[k]).all()):
                raise AssertionError(f"forward output {k} not finite")
        unit = {k: float((out_k[k] - out_p[k]).abs().max()) for k in out_k}
        scaled = COMPARE_SCALE * images
        out_k, out_p = kern(scaled), ref(scaled)
        torch.cuda.synchronize()
        if half == "false":
            for k in out_k:
                _close(f"forward {k} at scale {COMPARE_SCALE}", out_k[k],
                       out_p[k], F32_TOL, scaled=True)
        ms, plain_ms = _pair_ms(kern, ref, 3)
        print(f"[slice] forward N={BATCH} 240x320 T={SEQ} half={half}: "
              f"{ms:.2f} ms with kernels, {plain_ms:.2f} ms plain; "
              f"outputs max abs err at input scale {COMPARE_SCALE}"
              + (" (checked)" if half == "false" else "") + ": "
              + ", ".join(f"{k} {float((out_k[k] - out_p[k]).abs().max()):.3g}"
                          for k in out_k)
              + "; at unit scale (saturated, not checked): "
              + ", ".join(f"{k} {v:.3g}" for k, v in unit.items()),
              flush=True)
        del pred


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from scanpaths_tpu_torch.cli import predict
    from scanpaths_tpu_torch.ops import _build, block, cell
    from scanpaths_tpu_torch.serve import predictor

    t0 = time.perf_counter()
    _build.library()
    log = _build.library_path().with_suffix(".log")
    print(f"[build] {_build.library_path().name} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}", flush=True)

    summary = check_kernels(cell, block)
    with tempfile.TemporaryDirectory() as tmp:
        launches = run_slice(cell, block, predict, tmp)
    compare_forward(cell, block, predictor)

    sources = {"cell_step": ("scanpaths_tpu_torch/csrc/cell.cu",
                             "scanpaths_tpu/ops/pallas_cell.py:218"),
               "stage_apply": ("scanpaths_tpu_torch/csrc/block.cu",
                               "scanpaths_tpu/ops/pallas_block.py:197")}
    kernels = [dict(name=name, route="cuda", source=sources[name][0],
                    replaces=sources[name][1], launches=launches[name],
                    **summary[name]) for name in ("cell_step", "stage_apply")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
