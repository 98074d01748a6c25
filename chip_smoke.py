#!/usr/bin/env python3
"""Smoke run of the PyTorch port (scanpaths_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each reporting on its own lines and with its wall time:

1. device: fails unless CUDA is available; prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles the port's CUDA kernels from csrc/ and prints the
   build time and the compiler's register/spill report;
3. data: writes a synthetic OSIE test split from a seed (32 images of
   800x600, 15 subjects each, 3-20 fixations of 100-800 ms) and a
   reference-layout checkpoint_best.pth of seed weights;
4. kernels: each kernel against its plain PyTorch version on the card,
   at the main path's shapes and at edge ones (pixel counts off the
   128-pixel tile, column counts off the tile widths, dilation 2, two
   signal streams): the cell and stage kernels in float32 (TF32 off) and
   bfloat16 within a tolerance, the NW kernel exactly (max abs error 0,
   NaN in the same places) at every shape the test driver launches it
   (the human baseline, 3600 pairs, and a pair_rows batch, 240 pairs,
   each for both ScanMatch tables) and at ragged ones (out-of-table
   symbols among them); prints the max abs error, the times (for NW
   also the kernel's device time, the wrapper's host time and the NW ms
   per test run), the least time the card could take, the achieved
   TFLOP/s and share of that bound, each launch's tiles and waves over
   the SMs, and beside the cell, as a yardstick the port never calls,
   cuDNN's gate conv alone;
5. serving slice: serves 12 images through scanpaths_tpu_torch.cli.predict
   at full width (ResNet-50, embed 512, 240x320, T=16, batch 8, weights
   from a seed), greedy and sampled, float32 and bfloat16; checks the
   records and that every forward launched the cell kernel 16 times and
   the stage kernel 3 times; then runs one forward through the kernels
   and through the plain versions, compares and times them (in float32
   also each cell call of both against the plain version in float64),
   and splits one forward's device time with torch.profiler;
6. test slice: runs scanpaths_tpu_torch.cli.test --device_eval true at
   full width (batch 16, 10 repeats) over the synthetic split in
   float32 and bfloat16; checks the prediction records and the launch
   counts (per forward 16 cell and 3 stage launches; 2 NW launches per
   human-baseline batch and per repeat of a batch); then holds the
   float32 device sweep to the host suite on the first batch's human
   baseline and first two repeats (rtol 2e-4, atol 2e-5; the rollouts'
   durations capped on both sides, see compare_with_host);
7. prints the kernels' JSON line, then {"ok": true, "device": ...} as
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
HOST_RTOL, HOST_ATOL = 2e-4, 2e-5  # device sweep vs host suite
IMAGES = 12
BATCH = 8
SEQ = 16
TEST_IMAGES, TEST_SUBJECTS, TEST_BATCH, REPEATS = 32, 15, 16, 10
PRED_DURATION_CAP = 0.8  # s, the split's longest fixation; 16 x 16 symbols

# Published H100 SXM peaks (dense): float32 on the CUDA cores, bf16 on
# the tensor cores, HBM bandwidth.  A kernel's bound is the larger of
# its operations over the peak for their type and its bytes (each input
# read once, each output written once) over the bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
# float operations per NW DP cell: 2 subs, 2 muls, add, sqrt, sub (the
# substitution score), the diag add, and 3 maxes (cand, running max,
# combine)
NW_OPS_PER_CELL = 11


def _bound(flops, nbytes, peak):
    """(bound_ms, bound_by) of a call."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), \
        ("operations" if t_ops >= t_bytes else "bytes")


def cell_bound(n, h, w, c, s, dtype):
    """The cell step: the 3x3 C->4C gate conv, the signal taps, the xg
    add and the state update, over h, c, xg, smaps, kps, kh in and h', c'
    out."""
    p = n * h * w
    flops = 2 * p * (9 * c * 4 * c + 9 * s * 3 * c) + 4 * p * c + 4 * p * c
    elems = 2 * p * c + 4 * p * c + p * s + n * s * 27 * c + 36 * c * c \
        + 2 * p * c
    return _bound(flops, elems * dtype.itemsize, PEAK_FLOPS[dtype])


def stage_work(n, h, w, c, m, nb, dtype):
    """(operations, bytes) of one stage of nb bottleneck blocks: three
    products each (1x1 C->M, 3x3 M->M, 1x1 M->C) over x and the folded
    weights in, y out."""
    p = n * h * w
    per_block = c * m + 9 * m * m + m * c
    flops = 2 * p * nb * per_block
    nbytes = dtype.itemsize * (2 * p * c + nb * per_block) \
        + 4 * nb * (2 * m + c)
    return flops, nbytes


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


def _pair_ms(kernel_fn, plain_fn, iters, plain_iters=None):
    """Kernel and plain times in turns (plain, kernel, kernel, plain),
    after one warm-up call each; ``iters`` launches a side for the
    kernel, ``plain_iters`` (default ``iters``) for the plain version."""
    plain_iters = plain_iters or iters
    kernel_fn()
    plain_fn()
    torch.cuda.synchronize()
    p1 = _time_ms(plain_fn, plain_iters)
    k1 = _time_ms(kernel_fn, iters)
    k2 = _time_ms(kernel_fn, iters)
    p2 = _time_ms(plain_fn, plain_iters)
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


def _rate(flops, ms, bound_ms):
    """TFLOP/s achieved and the share of the bound reached."""
    return f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of bound"


def _waves(label, grid, sms):
    """A launch's tiles and its waves over the card's SMs."""
    gx, gy, per_sm = grid
    tiles = gx * gy
    return (f"{label} {tiles} tiles ({gx} x {gy}), {per_sm} per SM, "
            f"{tiles / (sms * per_sm):.2f} waves")


def check_kernels(cell, block):
    """The cell and stage kernels; returns {kernel: {"max_abs_err", "ms",
    "plain_ms", "bound_ms", "bound_by", "bf16_..."}} at the main path's
    shapes (float32 keys unprefixed, bfloat16 ones prefixed)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    summary = {"cell_step": {}, "stage_apply": {}}
    # pixel counts off the 128-pixel tile (ragged ones), both stream
    # counts, and C % 64 != 0 (the narrower bf16 gate tile)
    cell_cases = [("main S=1", (BATCH, 30, 40, 512, 1)),
                  ("main S=2", (BATCH, 30, 40, 512, 2)),
                  ("ragged", (3, 7, 9, 64, 1)),
                  ("ragged S=2 C=96", (3, 5, 11, 96, 2))]
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        dname = str(dtype).split(".")[-1]
        pre = "" if dtype == torch.float32 else "bf16_"
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
                bound_ms, bound_by = cell_bound(*shape, dtype)
                n, h, w, c, _ = shape
                flops = 2 * n * h * w * 9 * c * 4 * c
                line += (f", {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
                         f"{bound_ms:.3f} ms by {bound_by}; gate conv "
                         f"{_rate(flops, ms, bound_ms)}); "
                         + _waves("grid", cell.cell_grid(n, h, w, c, dtype),
                                  sms))
                if label == "main S=1":
                    summary["cell_step"].update({
                        pre + "max_abs_err": err, pre + "ms": ms,
                        pre + "plain_ms": plain_ms, pre + "bound_ms": bound_ms,
                        pre + "bound_by": bound_by})
            print(line, flush=True)

        # yardstick, not called by the port: cuDNN's gate conv alone at
        # the cell's main shape, channels-last
        n, h, w, c, _ = cell_cases[0][1]
        x = torch.randn((n, c, h, w), generator=gen, device="cuda").to(
            dtype).contiguous(memory_format=torch.channels_last)
        k = (torch.randn((4 * c, c, 3, 3), generator=gen, device="cuda")
             / math.sqrt(9 * c)).to(dtype).contiguous(
                 memory_format=torch.channels_last)
        conv_ms, _ = _pair_ms(lambda: F.conv2d(x, k, padding=1),
                              lambda: F.conv2d(x, k, padding=1), 5)
        print(f"[kernels] yardstick: cuDNN gate conv alone (F.conv2d "
              f"{n}x{c}x{h}x{w} -> {4 * c}, 3x3, channels-last, {dname}"
              f"{', TF32 off' if dtype == torch.float32 else ''}): "
              f"{conv_ms:.3f} ms", flush=True)

    # column counts off every tile width (96, 32) with dilation 1 and 2,
    # pixel counts off the 128-pixel tile
    stage_cases = [("layer1", (60, 80, 256, 64, 2, 1)),
                   ("layer2", (60, 80, 512, 128, 3, 1)),
                   ("layer3", (30, 40, 1024, 256, 5, 2)),
                   ("ragged", (7, 9, 64, 32, 2, 2)),
                   ("edge C=96", (9, 13, 96, 32, 2, 1)),
                   ("edge C=96 dil=2", (11, 10, 96, 32, 2, 2))]
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        dname = str(dtype).split(".")[-1]
        pre = "" if dtype == torch.float32 else "bf16_"
        total = [0.0, 0.0, 0.0, 0.0]       # ms, plain ms, flops, bytes
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
            if label.startswith("layer"):
                # timed at the served batch
                b = _stage_inputs(BATCH, h, w, c, m, nb, dtype, gen)
                wb = (b["w1"], b["b1"], b["w2"], b["b2"], b["w3"], b["b3"])
                ms, plain_ms = _pair_ms(
                    lambda: block.stage_apply(b["x"], dil, *wb),
                    lambda: block.stage_apply_plain(b["x"], dil, *wb), 5)
                flops, nbytes = stage_work(BATCH, h, w, c, m, nb, dtype)
                for i, v in enumerate((ms, plain_ms, flops, nbytes)):
                    total[i] += v
                bound_ms, _ = _bound(flops, nbytes, PEAK_FLOPS[dtype])
                g = block.stage_grid(BATCH, h, w, c, m, dtype)
                line += (f", N={BATCH}: {ms:.3f} ms (plain {plain_ms:.3f} ms; "
                         f"{_rate(flops, ms, bound_ms)}); "
                         + "; ".join(_waves(p, g[3 * i:3 * i + 3], sms)
                                     for i, p in enumerate(
                                         ("reduce", "3x3", "expand"))))
            print(line, flush=True)
        bound_ms, bound_by = _bound(total[2], total[3], PEAK_FLOPS[dtype])
        print(f"[kernels] stage layers 1-3 N={BATCH} {dname}: "
              f"{total[0]:.3f} ms (plain {total[1]:.3f} ms, bound "
              f"{bound_ms:.3f} ms by {bound_by}, {total[2] / 1e9:.1f} GFLOP; "
              f"{_rate(total[2], total[0], bound_ms)})", flush=True)
        summary["stage_apply"].update({
            pre + "max_abs_err": max(errs), pre + "ms": total[0],
            pre + "plain_ms": total[1], pre + "bound_ms": bound_ms,
            pre + "bound_by": bound_by})
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
    """The serving slice; returns the launch counts of the served
    runs."""
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


def profile_forward(fn, label):
    """One call of fn() under torch.profiler after a warm-up: the device
    busy time (the kernels' and copies' sum on the one stream), the span
    between CUDA events around the call, the idle share, the cell
    kernel's share of the busy time, and the five largest kernels.  The
    profiler adds host time, so the span is longer than an unprofiled
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    span = start.elapsed_time(end)
    times = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        times[evt.key] = times.get(evt.key, 0.0) + us / 1e3
    busy = sum(times.values())
    if busy == 0.0:
        print(f"[profile] forward {label}: the trace holds no device time",
              flush=True)
        return
    cell_ms = sum(v for k, v in times.items() if "cell_" in k)
    top = sorted(times.items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile] forward {label}: device busy {busy:.2f} ms of a "
          f"{span:.2f} ms span ({100 * (1 - busy / span):.1f}% idle); cell "
          f"kernel {cell_ms:.2f} ms ({100 * cell_ms / busy:.1f}% of busy); "
          "largest: " + "; ".join(f"{k[:60]} {v:.2f} ms "
                                  f"({100 * v / busy:.1f}%)" for k, v in top),
          flush=True)


def compare_forward(cell, block, predictor_mod):
    """Full-width forwards through the kernels and the plain versions on
    the same weights and images: every kernel call of the served
    forward checked against its plain version on the same inputs, the
    whole outputs compared at COMPARE_SCALE, and both forwards timed."""
    from scanpaths_tpu_torch.core.config import parse_opt
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
        # float32 only: the kernel's and the plain version's errors against
        # the plain version in float64 on the same inputs, per call
        f64_errs = {"kernel": [], "plain": []}
        cell_k, stage_k = cell.cell_step, block.stage_apply

        def checked_cell(h, c, *a):
            c_p = c.clone()
            c_d = c.double() if half == "false" else None
            h_k, c_k = cell_k(h, c, *a)
            h_p, c_p = cell.cell_step_plain(h, c_p, *a)
            errs["cell_step"].append(max(
                _close("cell in forward", h_k, h_p, tol, scaled=True),
                _close("cell in forward", c_k, c_p, tol, scaled=True)))
            if c_d is not None:
                h_d, c_d = cell.cell_step_plain(h.double(), c_d,
                                                *(t.double() for t in a))
                for side, (hh, cc) in (("kernel", (h_k, c_k)),
                                       ("plain", (h_p, c_p))):
                    f64_errs[side].append(max(
                        float((hh.double() - h_d).abs().max()),
                        float((cc.double() - c_d).abs().max())))
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
        if half == "false":
            print("[slice] forward half=false: cell_step max abs err against "
                  "its plain version in float64, calls 1 and 16 (largest): "
                  + ", ".join(f"{side} {v[0]:.3g} and {v[-1]:.3g} "
                              f"({max(v):.3g})" for side, v in f64_errs.items())
                  + " (plain = cuDNN's float32 conv without TF32)",
                  flush=True)

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
        profile_forward(kern, f"N={BATCH} half={half}")
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


def write_test_split(tmp):
    """A synthetic OSIE test split and a reference-layout checkpoint of
    seed weights, all from seed 0.  Returns the test CLI's flags."""
    from PIL import Image

    from scanpaths_tpu_torch.models import port
    from scanpaths_tpu_torch.models.scanpath_model import (ScanpathModel,
                                                           init_weights)
    rng = np.random.default_rng(0)
    img_dir = os.path.join(tmp, "osie", "stimuli")
    fix_dir = os.path.join(tmp, "osie", "fixations")
    run_dir = os.path.join(tmp, "run")
    for d in (img_dir, fix_dir, os.path.join(run_dir, "checkpoints")):
        os.makedirs(d)
    recs = []
    for i in range(TEST_IMAGES):
        name = f"{1001 + i}.jpg"
        Image.fromarray(rng.integers(0, 256, (600, 800, 3), dtype=np.uint8)) \
            .save(os.path.join(img_dir, name))
        for subject in range(TEST_SUBJECTS):
            n = int(rng.integers(3, 21))
            recs.append({"name": name, "subject": subject,
                         "X": rng.uniform(0, 800, n).tolist(),
                         "Y": rng.uniform(0, 600, n).tolist(),
                         "T": rng.uniform(100, 800, n).tolist(),
                         "length": n})
    with open(os.path.join(fix_dir, "osie_fixations_test.json"), "w") as f:
        json.dump(recs, f)
    model = ScanpathModel("osie")              # full width, float32
    init_weights(model, 0)
    torch.save(port.to_reference_state_dict(model.state_dict(),
                                            model.map_h, model.map_w),
               os.path.join(run_dir, "checkpoints", "checkpoint_best.pth"))
    return ["--task", "osie", "--img_dir", img_dir, "--fix_dir", fix_dir,
            "--evaluation_dir", run_dir, "--batch", str(TEST_BATCH),
            "--eval_repeat_num", str(REPEATS), "--seed", "0",
            "--device_eval", "true", "--device", "cuda"]


def _first_batch(argv):
    """The test split's first batch and the device sweep's specs, as the
    test CLI builds them."""
    import argparse

    from scanpaths_tpu_torch.core.config import parse_opt
    from scanpaths_tpu_torch.data.datasets import EvaluationDataset, Loader
    from scanpaths_tpu_torch.train import trainer
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device")
    args = parse_opt(pre.parse_known_args(argv)[1])
    ds = EvaluationDataset("osie", trainer.data_config(args), split="test")
    batch = next(iter(Loader(ds, batch_size=args.batch)))
    return batch, trainer.eval_specs(ds, trainer.grid_spec(args))


def _exact(name, got, want):
    """Raises unless got == want bit for bit with NaN in the same
    places; returns the max abs error (0.0)."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        raise AssertionError(f"{name}: NaN in other places than the plain "
                             "version's")
    err = float((got[~nan] - want[~nan]).abs().max()) if bool((~nan).any()) \
        else 0.0
    if err != 0.0:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version (max abs err {err:.3g})")
    return err


def _device_and_host_ms(fn, kernel, iters):
    """(device ms, host ms) per call of fn over ``iters`` calls each:
    the mean time of the kernels whose name holds ``kernel`` in a
    torch.profiler trace (None if the trace holds none), and, in a run
    without the profiler, the host clock over the calls before the
    closing synchronize (the enqueue cost).  A call takes at least the
    larger of the two."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and kernel in evt.key:
            t = getattr(evt, "self_device_time_total", None)
            us += evt.self_cuda_time_total if t is None else t
            n += evt.count
    return (us / n / 1e3 if n else None), 1e3 * host


def seeded_rollouts(n):
    """A rollout batch of the test driver's shape from seed 2: n
    scanpaths of 1-SEQ fixations on the 320x240 frame, durations of
    0.1-2 s capped at PRED_DURATION_CAP (as compare_with_host caps the
    seed model's), so most fill 8 symbols of the w/-duration table."""
    rng = np.random.default_rng(2)
    fix = np.stack([rng.uniform(0, 320, (n, SEQ)),
                    rng.uniform(0, 240, (n, SEQ)),
                    np.minimum(rng.uniform(0.1, 2.0, (n, SEQ)),
                               PRED_DURATION_CAP)], -1).astype(np.float32)
    return (torch.as_tensor(fix, device="cuda"),
            torch.as_tensor(rng.integers(1, SEQ + 1, n), dtype=torch.int32,
                            device="cuda"))


def nw_shapes(tm, batch, specs):
    """Every NW launch shape of one test-driver run, from the split's
    first batch: [(label, launches per run, spec, (fix_a, len_a, fix_b,
    len_b))].  Per spec, the human baseline (every ordered subject pair,
    ``device_eval.human_rows``) runs once per batch and ``pair_rows``
    (GT subjects against a rollout batch) once per repeat per batch."""
    gt_fix = torch.as_tensor(batch["gt_fix"], device="cuda")
    gt_len = torch.as_tensor(batch["gt_len"], device="cuda")
    n, s, length = gt_fix.shape[:3]
    pairs = (n, s, s, length, 3)
    human = (gt_fix[:, :, None].expand(pairs).reshape(-1, length, 3),
             gt_len[:, :, None].expand(n, s, s).reshape(-1),
             gt_fix[:, None].expand(pairs).reshape(-1, length, 3),
             gt_len[:, None].expand(n, s, s).reshape(-1))
    pred_fix, pred_len = seeded_rollouts(n)
    rows = (gt_fix.reshape(n * s, length, 3), gt_len.reshape(n * s),
            torch.repeat_interleave(pred_fix, s, dim=0),
            torch.repeat_interleave(pred_len, s, dim=0))
    forwards = -(-TEST_IMAGES // TEST_BATCH)
    return [(f"{part} {label}", runs, spec, pairs)
            for part, runs, pairs in (("human baseline", forwards, human),
                                      ("pair_rows", REPEATS * forwards, rows))
            for label, spec in zip(("w/ duration", "w/o duration"), specs)]


def check_nw(nw, tm, batch, specs):
    """The NW kernel against its plain version, exactly, and timed at
    every shape the test driver launches it (``nw_shapes``), then on
    ragged cases.  Prints the NW ms per test run (the launches of one
    run times their ms, summed over shapes).  Returns the summary at the
    human baseline's w/-duration shape, with the per-run ms added."""
    summary, per_run = None, 0.0
    for label, runs, spec, pairs in nw_shapes(tm, batch, specs):
        sa, na = tm.quantize(spec, *pairs[:2])
        sb, nb = tm.quantize(spec, *pairs[2:])
        args = (spec.threshold, spec.xbin, spec.ybin, sa.contiguous(),
                na.contiguous(), sb.contiguous(), nb.contiguous())
        got = nw.nw_scores_bins(*args)
        want = nw.nw_scores_bins_plain(*args)
        torch.cuda.synchronize()
        err = _exact(f"nw {label}", got, want)
        ms, plain_ms = _pair_ms(lambda: nw.nw_scores_bins(*args),
                                lambda: nw.nw_scores_bins_plain(*args), 200, 3)
        per_run += runs * ms
        dev_ms, host_ms = _device_and_host_ms(
            lambda: nw.nw_scores_bins(*args), "nw_kernel", 200)
        b, ta = sa.shape
        tb = sb.shape[1]
        cells = int((na.clamp(0, ta).long() * nb.clamp(0, tb).long()).sum())
        bound_ms, bound_by = _bound(NW_OPS_PER_CELL * cells,
                                    4 * (b * (ta + tb) + 3 * b),
                                    PEAK_FLOPS[torch.float32])
        print(f"[kernels] nw {label} B={b} Ta={ta} Tb={tb}: max_abs_err "
              f"{err}, NaN {int(torch.isnan(got).sum())}, {ms:.4f} ms a "
              f"call (kernel on the device "
              + ("not in the trace" if dev_ms is None else f"{dev_ms:.4f} ms")
              + f", host {host_ms:.4f} ms; plain {plain_ms:.3f} ms, bound "
              f"{bound_ms:.5f} ms by "
              f"{bound_by}, {100 * bound_ms / ms:.1f}% of bound: {cells} DP "
              f"cells; the longest row chain is {int(na.max())} rows); "
              f"{runs} launches per test run", flush=True)
        if summary is None:
            summary = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
    print(f"[kernels] nw ms per test run: {per_run:.4f} ms", flush=True)
    summary["ms_per_test_run"] = per_run

    gen = torch.Generator(device="cuda").manual_seed(1)
    # ragged lengths and widths; the pair_rows batch size; a w/o-duration
    # width; symbols at and beyond the 16 x 12 bins (and negative ones),
    # at each of the kernel's widths; 40 x 30 bins, whose scores are not
    # tabled
    for bins, b, ta, tb, lo, hi in (
            ((16, 12), 64, 37, 300, 0, 192), ((16, 12), 48, 5, 1000, 0, 192),
            ((16, 12), 40, 256, 256, 0, 192), ((16, 12), 240, 256, 256, 0, 192),
            ((16, 12), 300, 20, 20, 0, 192), ((16, 12), 96, 40, 33, 150, 260),
            ((16, 12), 64, 20, 20, -2 ** 31, 2 ** 31 - 1),
            ((16, 12), 32, 10, 700, -5, 400), ((40, 30), 64, 50, 90, 0, 1200)):
        def ints(lo, hi, *shape):
            return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                                 dtype=torch.int64).to(torch.int32)
        sa, sb = ints(lo, hi, b, ta), ints(lo, hi, b, tb)
        na, nb = ints(0, ta + 1, b), ints(0, tb + 1, b)
        na[:4], nb[2:6] = 0, 0          # empty, one-sided and both empty
        na[6:9], nb[7:10] = ta, tb      # lengths at the bound
        na[10], nb[11] = -3, tb + 5     # clamped lengths
        args = (3.5, *bins, sa, na, sb, nb)
        got = nw.nw_scores_bins(*args)
        want = nw.nw_scores_bins_plain(*args)
        torch.cuda.synchronize()
        label = (f"{bins[0]}x{bins[1]} bins B={b} Ta={ta} Tb={tb} symbols "
                 f"in [{lo}, {hi})")
        err = _exact(f"nw ragged {label}", got, want)
        print(f"[kernels] nw ragged {label}: max_abs_err {err}, NaN "
              f"{int(torch.isnan(got).sum())} (plain "
              f"{int(torch.isnan(want).sum())})", flush=True)
    return summary


def _tree_close(name, want, got, skip=()):
    """Raises unless two metric trees agree within the host bound; keys
    in ``skip`` are not compared.  Returns the max abs difference."""
    worst = 0.0
    for k in want:
        if k in skip:
            continue
        if isinstance(want[k], dict):
            worst = max(worst, _tree_close(f"{name}/{k}", want[k], got[k],
                                           skip))
            continue
        w, g = float(want[k]), float(got[k])
        if math.isnan(w) and math.isnan(g):
            continue
        if not abs(g - w) <= HOST_ATOL + HOST_RTOL * abs(w):
            raise AssertionError(f"{name}/{k}: device {g} vs host {w}")
        worst = max(worst, abs(g - w))
    return worst


def compare_with_host(device_eval, heval, batch, specs, captured):
    """The float32 device sweep against the host suite on the first
    batch's human baseline and its first two repeats.

    The seed-weight model samples LogNormal durations of up to hours,
    which the host ScanMatch expands into millions of symbols (it ran a
    96 GiB machine out of memory) and the device sweep truncates at its
    table by design.  So both sides get the captured rollouts with their
    durations capped at PRED_DURATION_CAP: every rollout then fits the
    w/-duration table and all nine columns compare."""
    from scanpaths_tpu_torch.core.grid import fix_vector
    t0 = time.perf_counter()
    want = heval.human_evaluation([batch])[:2]
    got = device_eval.human_evaluation_device([batch], *specs,
                                              device="cuda")[:2]
    err_h = max(_tree_close(f"human {part}", w, g)
                for part, w, g in zip(("metrics", "stds"), want, got))
    sweep = device_eval.DeviceSweep(*specs)
    gts, preds, capped = [], [], 0
    for gt_fix, gt_len, gt_mask, pred_fix, pred_len in captured:
        valid = torch.arange(pred_fix.shape[1], device=pred_fix.device) \
            < pred_len[:, None]
        capped += int(((pred_fix[..., 2] > PRED_DURATION_CAP) & valid).sum())
        pred_fix = pred_fix.clone()
        pred_fix[..., 2].clamp_(max=PRED_DURATION_CAP)
        sweep.add_batch(gt_fix, gt_len, gt_mask, pred_fix, pred_len)
        gts.extend(batch["fix_vectors"])
        fix, lens = pred_fix.cpu().numpy(), pred_len.cpu().numpy()
        preds.extend(fix_vector(fix[i, :n, 0], fix[i, :n, 1], fix[i, :n, 2])
                     for i, n in enumerate(lens))
    if sweep.overflow["count"]:
        raise AssertionError(f"capped rollouts overflow the w/-duration "
                             f"table: {sweep.overflow}")
    want = heval.evaluation(gts, preds)[:2]
    got = sweep.result()
    err_p = max(_tree_close(f"repeats {part}", w, g)
                for part, w, g in zip(("metrics", "stds"), want, got))
    print(f"[test] float32 device sweep vs host suite, first batch: human "
          f"baseline ({len(batch['img_names'])} images, "
          f"{sum(len(v) * (len(v) - 1) for v in batch['fix_vectors'])} "
          f"pairs) max abs diff {err_h:.3g}; repeats 1-2 ({len(preds)} "
          f"rollouts, {capped} fixations capped at {PRED_DURATION_CAP} s) "
          f"max abs diff {err_p:.3g}; rtol {HOST_RTOL}, atol {HOST_ATOL}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _check_tree(metrics):
    """The metric tree of a test run: ScanMatch in [0, 1], STDE in
    [0, 1], SED >= 0, all finite; MultiMatch in [0, 1] or NaN (NaN when
    every rollout has fewer than 3 fixations)."""
    for group, lo, hi, nan_ok in (("MultiMatch", 0, 1, True),
                                  ("ScanMatch", 0, 1, False)):
        for k, v in metrics[group].items():
            if not (lo <= v <= hi or (nan_ok and math.isnan(v))):
                raise AssertionError(f"{group}/{k} = {v}")
    vame = metrics["VAME"]
    if not all(math.isfinite(vame[k]) for k in vame) or \
            not (0 <= vame["STDE"] <= 1 and vame["SED"] >= 0):
        raise AssertionError(f"VAME {vame}")


def run_test_slice(cell, block, nw, test_cli, device_eval, heval, argv,
                   batch, specs):
    """The test CLI with the device sweep at full width, float32 and
    bfloat16; returns the launch counts of both runs.  ``batch`` and
    ``specs`` are the split's first batch and the sweep's specs."""
    print(f"[test] split: {TEST_IMAGES} images x {TEST_SUBJECTS} subjects, "
          f"w/-duration table {specs[0].max_symbols} symbols, w/o-duration "
          f"table {specs[1].max_symbols}", flush=True)
    forwards = -(-TEST_IMAGES // TEST_BATCH)
    want = {"cell_step": SEQ * forwards, "stage_apply": 3 * forwards,
            "nw_scores_bins": 2 * forwards + 2 * REPEATS * forwards}
    totals = dict.fromkeys(want, 0)
    real_add = device_eval.DeviceSweep.add_batch
    real_human = test_cli.human_evaluation_device
    for half in ("false", "true"):
        captured, sweep_secs = [], [0.0]

        def add_batch(self, *a):
            if len(captured) < 2:
                captured.append([x.detach().clone() for x in a])
            t = time.perf_counter()
            real_add(self, *a)
            sweep_secs[0] += time.perf_counter() - t

        def human(*a, **kw):
            t = time.perf_counter()
            out = real_human(*a, **kw)
            sweep_secs[0] += time.perf_counter() - t
            return out

        cell.cell_launches = block.block_launches = nw.nw_launches = 0
        t0 = time.perf_counter()
        with mock.patch.object(device_eval.DeviceSweep, "add_batch",
                               add_batch), \
                mock.patch.object(test_cli, "human_evaluation_device",
                                  human):
            metrics = test_cli.main(argv + ["--half_precision", half])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {"cell_step": cell.cell_launches,
               "stage_apply": block.block_launches,
               "nw_scores_bins": nw.nw_launches}
        if got != want:
            raise AssertionError(f"test --half_precision {half}: launches "
                                 f"{got}, expected {want}")
        for k, v in got.items():
            totals[k] += v
        run_dir = argv[argv.index("--evaluation_dir") + 1]
        with open(os.path.join(run_dir, "test_predicts.json")) as f:
            records = json.load(f)
        _check_records(records, TEST_IMAGES, REPEATS, 320, 240)
        _check_tree(metrics)
        print(f"[test] test --device_eval true --half_precision {half}: "
              f"{len(records)} records, launches {got}, {secs:.2f} s wall, "
              f"device sweep {sweep_secs[0]:.2f} s "
              f"({100 * sweep_secs[0] / secs:.1f}%)", flush=True)
        if half == "false":
            compare_with_host(device_eval, heval, batch, specs, captured)
    return totals


def print_ptxas(log):
    """One line per compiled kernel from ptxas -v: its name with template
    arguments, registers, spills and shared memory."""
    import re
    name, spill = None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"(cell_f32|cell_bf16|conv_f32|conv_bf16|nw_kernel)"
                          r"((?:I?Li-?\d+E)*)", m.group(1))
            name = m.group(1) if not k else k.group(1) + (
                "<" + ",".join(re.findall(r"Li(-?\d+)E", k.group(2))) + ">"
                if k.group(2) else "")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            print(f"[build] {name}: {line.split(':', 1)[1].strip()}; {spill}",
                  flush=True)
            name = None


def _phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s wall",
          flush=True)


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
    from scanpaths_tpu_torch.cli import test as test_cli
    from scanpaths_tpu_torch.metrics import device_eval
    from scanpaths_tpu_torch.metrics import evaluation as heval
    from scanpaths_tpu_torch.metrics import torch_metrics as tm
    from scanpaths_tpu_torch.ops import _build, block, cell, nw
    from scanpaths_tpu_torch.serve import predictor

    t0 = time.perf_counter()
    _build.library()
    log = _build.library_path().with_suffix(".log")
    print(f"[build] {_build.library_path().name} built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if log.exists():
        print_ptxas(log.read_text())

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        test_argv = write_test_split(tmp)
        batch, specs = _first_batch(test_argv)
        _phase("data", t0)

        t0 = time.perf_counter()
        summary = check_kernels(cell, block)
        summary["nw_scores_bins"] = check_nw(nw, tm, batch, specs)
        _phase("kernels", t0)

        t0 = time.perf_counter()
        launches = run_slice(cell, block, predict, tmp)
        compare_forward(cell, block, predictor)
        _phase("serving slice", t0)

        t0 = time.perf_counter()
        test_launches = run_test_slice(cell, block, nw, test_cli,
                                       device_eval, heval, test_argv,
                                       batch, specs)
        _phase("test slice", t0)
    launches["nw_scores_bins"] = 0
    for k, v in test_launches.items():
        launches[k] += v

    sources = {"cell_step": ("scanpaths_tpu_torch/csrc/cell.cu",
                             "scanpaths_tpu/ops/pallas_cell.py:218"),
               "stage_apply": ("scanpaths_tpu_torch/csrc/block.cu",
                               "scanpaths_tpu/ops/pallas_block.py:197"),
               "nw_scores_bins": ("scanpaths_tpu_torch/csrc/nw.cu",
                                  "scanpaths_tpu/ops/pallas_nw.py:111")}
    # no single PyTorch call computes any of the three functions (a
    # fused ConvLSTM step, a stage of bottleneck blocks, an NW alignment)
    kernels = [dict(name=name, route="cuda", source=sources[name][0],
                    replaces=sources[name][1], launches=launches[name],
                    library_ms=None, **summary[name]) for name in sources]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
