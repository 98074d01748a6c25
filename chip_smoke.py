#!/usr/bin/env python3
"""Smoke run of the PyTorch port (scanpaths_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each reporting on its own lines and with its wall time:

1. device: fails unless CUDA is available; prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles the port's CUDA kernels from csrc/ and prints the
   build time and the compiler's register/spill report;
3. data: writes, from a seed, a synthetic evaluation split for each task
   at its dataset's frame, with a reference-layout checkpoint_best.pth
   of seed weights: OSIE (test split, 32 images of 800x600, 15 subjects
   each), AiR (test split, 32 questions on images of 300-700 x 400-900,
   an attention map each, 15 subjects with right and wrong answers; the
   AiR frame range, subject count and answer mix are assumptions, see
   TEST_SUBJECTS) and
   COCO-Search18 (validation split, 32 trials of 320x512 over four
   target categories, 10 subjects each, detector boxes above and below
   the 0.8 threshold); 3-20 fixations of 100-800 ms a subject; the same
   records also form each task's train split;
4. kernels: each kernel against its plain PyTorch version on the card,
   at the main path's shapes and at edge ones (pixel counts off the
   128-pixel tile, column counts off the tile widths, dilation 2, two
   signal streams): the cell and stage kernels in float32 (TF32 off) and
   bfloat16 within a tolerance, the NW kernel exactly (max abs error 0,
   NaN in the same places) at every shape each task's test driver
   launches it (its human baseline and a pair_rows batch, each for both
   ScanMatch tables) and at ragged ones (out-of-table symbols among
   them); prints the max abs error, the times (for NW also the kernel's
   device time, the wrapper's host time and the NW ms per test run of
   each task), the least time the card could take, the achieved TFLOP/s
   and share of that bound, each launch's tiles and waves over the SMs,
   and beside the cell, as a yardstick the port never calls, cuDNN's
   gate conv alone;
5. serving slice, for each task: serves 12 images through
   scanpaths_tpu_torch.cli.predict at full width (ResNet-50, embed 512,
   240x320, T=16, batch 8, weights from a seed), greedy and sampled,
   float32 and bfloat16 (AiR with seeded attention maps, COCO with three
   target categories, so three bank heads share a batch); checks the
   records (every value finite, but for COCO's sampled durations whose
   exponent, recomputed in float64 from the sampler's mu, sigma2 and
   normal draw, lies past float32's range; so in phase 6) and that
   every forward launched the cell kernel 16 times
   (with two signal streams for AiR, one otherwise) and the stage
   kernel 3 times; then runs one forward through the kernels and
   through the plain versions, compares and times them (in float32 also
   each cell call of both against the plain version in float64), and
   splits one forward's device time with torch.profiler;
6. test slice, for each task: runs scanpaths_tpu_torch.cli.test
   --device_eval true at full width (batch 16, 10 repeats, both streams
   for AiR) over the task's split in float32 and bfloat16; checks the
   prediction records and the launch counts (per forward 16 cell and 3
   stage launches; 2 NW launches per human-baseline batch and per repeat
   of a batch and stream); then holds the float32 device sweep to the
   host suite on the first batch's human baseline and first two repeats
   of each stream (rtol 2e-4, atol 2e-5; the rollouts' durations capped
   on both sides, see compare_with_host);
7. training, for each task, at full width in float32 from seed weights
   (the duration head's last conv scaled by 0.01, see _train_model):
   three supervised steps at batch 16 on one batch of the train split
   (the loss must fall), three SCST steps at batch 4 with 5 rollouts
   (per stream for AiR), each with its ScanMatch reward grids on the NW
   kernel; for OSIE also two supervised steps in bfloat16 compute with
   float32 parameters; then profiles one more step of each kind.
   Checks that the cell and stage wrappers refuse a gradient on the
   card, every loss and metric finite, the launch
   counts (no cell or stage launch; 2 NW launches per SCST step and
   stream), every NW call of the SCST steps against the plain NW
   exactly, and one OSIE supervised step at batch 2 on the card against
   the same step on the CPU (loss and gradient norm, rtol 1e-3).  Prints
   the step times, images/s, the reward grids' share of the SCST step
   and the NW time inside it, NW ms a call at the reward's shapes, and
   the peak memory allocated per phase;
8. the trainer, for each task: writes a train split of 32 images and a
   validation split of 16 others (phase 3's frames and subject counts,
   seed 0) and runs scanpaths_tpu_torch.cli.train at full width
   (--batch 16, 5 rollouts, 10 repeats) with --epoch 2 --start_rl_epoch
   1 --device_eval true: a human baseline, one supervised epoch and one
   SCST epoch, each followed by a validation with the device sweep and a
   checkpoint write (the seed duration head scaled by 0.01, as in
   phase 7; see trainer_probes).  Checks the run's artifacts (tests/test_e2e.py's contract,
   .pth for .msgpack), every scalar finite (a validation's MultiMatch
   columns may be NaN, as in phase 6), the steps and the record, the
   launch counts (no cell or stage launch in a training step; 16 cell
   and 3 stage launches per validation forward; NW 2 per SCST step and
   stream, 2 per human-baseline batch, 2 per sweep batch, repeat and
   stream), every NW call of the SCST steps against the plain NW
   exactly; then runs cli.test on the run (it must read the run's own
   checkpoint_best.pth) and, for OSIE, resumes the run for a third
   epoch (the record's iteration, Adam's step count and every lr scalar
   go on; the lr scalar is the lr the optimizer applied, so the resumed
   steps are held to the --epoch 3 schedule).  Prints per epoch the steps/s and images/s, the wait for host
   batches, the device's idle share over the epoch's last 3 steps
   (torch.profiler) and the peak memory; per validation its wall and the
   sweep's share; per checkpoint write its ms and MB;
9. the joint trainer: writes a joint data root in
   tools/make_synth_data.py's layout (16 train and 16 validation images
   a task, phase 3's frames and subject counts, seed 0) and runs
   scanpaths_tpu_torch.cli.train --task joint at full width (one trunk,
   three heads; --batch 16, 5 rollouts, 10 repeats) with --epoch 2
   --start_rl_epoch 1 --device_eval true: a human baseline per task, one
   supervised and one SCST epoch round-robin over the tasks, each
   followed by a validation of every head with the device sweep and a
   checkpoint write (every head's duration conv scaled by 0.01, as in
   phase 8).  Checks the artifacts, hparams.json's task, the record (its
   iteration the sum of the tasks' steps), every scalar finite (a
   validation's MultiMatch columns may be NaN), each task's tags, the
   current metric against the harmonic mean of the per-task ScanMatch
   harmonic means recomputed from the scalars, the round-robin step
   order read from the scalars' steps, one trunk (no head holds one),
   the launch counts (no cell or stage launch in a training step; per
   validation forward 16 cell, S = 2 for AiR, and 3 stage launches; NW 2
   per SCST step and stream, 2 per human-baseline batch, 2 per sweep
   batch, repeat and stream), every SCST NW call against the plain NW
   exactly, and every cell and stage call of the trained model's AiR
   eval forward against its plain version; then runs cli.test on each
   head of the run (it must read the joint checkpoint_best.pth) and
   cli.predict on its COCO head (12 images, three target categories,
   phase 5's record checks).  Prints per epoch and task the steps,
   images/s, the wait for host batches, the idle share over the task's
   last 3 steps and the peak memory; per validation and task its wall
   and the sweep's share; per checkpoint write its ms and MB;
10. prints the kernels' JSON line, then {"ok": true, "device": ...} as
   the last line.

Any failed check raises, so the script exits non-zero and prints no
result line.
"""

from __future__ import annotations

import contextlib
import io
import itertools
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
TASKS = ("osie", "air", "coco")
TEST_IMAGES, TEST_BATCH, REPEATS = 32, 16, 10
# subjects a split's image: OSIE's 15 observers and COCO-Search18's 10
# a trial are the datasets' counts.  AiR's 15 (9 right answers, 3 wrong,
# 3 failed, so every answer bucket fills) and its 300-700 x 400-900
# frames (tools/make_synth_data.py's range) are assumptions: no source
# for AiR-D's participant count, answer mix or frame sizes is at hand.
TEST_SUBJECTS = {"osie": 15, "air": 15, "coco": 10}
# COCO categories: of the served images, in turn, and of the split's trials
SERVE_TARGETS = ("cup", "tv", "car")
SPLIT_TARGETS = ("bottle", "chair", "laptop", "sink")
PRED_DURATION_CAP = 0.8  # s, the split's longest fixation; 16 x 16 symbols
# the training phase: steps of each kind per task, and the batch and
# relative tolerance of the card-against-CPU supervised step
TRAIN_STEPS = 3
PARITY_BATCH, PARITY_RTOL = 2, 1e-3

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
    shapes (float32 keys unprefixed, bfloat16 ones prefixed; the cell's
    two-stream shape, AiR's, also prefixed "s2_")."""
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
                # S=1 (OSIE, COCO) unprefixed, S=2 (AiR) under "s2_"
                sp = pre + ("" if label == "main S=1" else "s2_")
                summary["cell_step"].update({
                    sp + "max_abs_err": err, sp + "ms": ms,
                    sp + "plain_ms": plain_ms, sp + "bound_ms": bound_ms,
                    sp + "bound_by": bound_by})
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


def _check_records(records, n_images, n_rollouts, width, height,
                   extra=None, overflow=0):
    """Prediction records: the reference schema (``extra`` names the
    test driver's AiR/COCO fields, whose records name the image
    ``img_names``), lengths, finite positions in the frame, durations
    >= 0 and finite except for exactly ``overflow`` +inf ones (the count
    ``overflowed_durations`` justified)."""
    if len(records) != n_images * n_rollouts:
        raise AssertionError(f"{len(records)} records, expected "
                             f"{n_images * n_rollouts}")
    keys = {"repeat_id", "X", "Y", "T", "length"} | (
        {"img_names", *extra} if extra else {"name"})
    inf = 0
    for r in records:
        if set(r) != keys:
            raise AssertionError(f"record keys {sorted(r)}")
        n = r["length"]
        if not (0 <= n <= SEQ and len(r["X"]) == len(r["Y"]) == len(r["T"])
                == n):
            raise AssertionError(f"record lengths {r}")
        xy = np.asarray(r["X"] + r["Y"], np.float64)
        dur = np.asarray(r["T"], np.float64)
        if not np.isfinite(xy).all() or np.isnan(dur).any():
            raise AssertionError(f"non-finite record {r}")
        if any(not 0 <= x <= width for x in r["X"]) or \
                any(not 0 <= y <= height for y in r["Y"]) or \
                bool((dur < 0).any()):
            raise AssertionError(f"record out of range {r}")
        inf += int(np.isinf(dur).sum())
    if inf != overflow:
        raise AssertionError(f"{inf} durations of the records are +inf, "
                             f"{overflow} overflow float32 in the sampler")


LOG_F32_MAX = math.log(torch.finfo(torch.float32).max)


@contextlib.contextmanager
def capture_durations():
    """Records each call of the sampler's random_sample_from_noise: the
    sampled durations, their exponent normal * sigma2 + mu recomputed in
    float64 from the same mu, sigma2 and normal draw, and the duration
    mask, on the host."""
    from scanpaths_tpu_torch.ops import sampling
    real, calls = sampling.random_sample_from_noise, []

    def sample(probs, mu, sigma2, grid, gumbel, normal):
        out = real(probs, mu, sigma2, grid, gumbel, normal)
        calls.append((out.durations.float().cpu(),
                      (normal.double() * sigma2.double()
                       + mu.double()).cpu(),
                      out.duration_mask.bool().cpu()))
        return out
    with mock.patch.object(sampling, "random_sample_from_noise", sample):
        yield calls


def overflowed_durations(calls, reals, task, ms_in_float32):
    """The durations of the written records that overflow float32, from
    ``capture_durations``'s calls (``reals``: each call's images that get
    records, the rest pad the batch).  A record's duration is d * 1000 ms,
    in float32 (``ms_in_float32``, cli/predict.py) or float64
    (cli/test.py).  Only COCO's seed model has a LogNormal scale that
    reaches float32's range; OSIE and AiR must have none.  Each overflow
    must be one the float64 exponent, plus log(1000) where the ms are
    float32, puts past float32's range; raises otherwise."""
    if len(calls) != len(reals):
        raise AssertionError(f"{len(calls)} sampler calls, expected "
                             f"{len(reals)}")
    count = 0
    for (dur, expo, valid), real in zip(calls, reals):
        valid = valid[:, :real]
        dur, expo = dur[:, :real][valid], expo[:, :real][valid]
        if ms_in_float32:
            inf, expo = torch.isinf(dur * 1000.0), expo + math.log(1000.0)
        else:
            inf = torch.isinf(dur)
        if bool(inf.any()) and task != "coco":
            raise AssertionError(f"{task}: {int(inf.sum())} sampled "
                                 "durations overflow float32")
        short = expo[inf] <= LOG_F32_MAX - 1e-3 * expo[inf].abs().clamp(
            min=1.0)
        if bool(short.any()):
            raise AssertionError(
                f"{task}: a sampled duration overflows float32 at exponent "
                f"{float(expo[inf][short].min()):.4g} (float32's range ends "
                f"at {LOG_F32_MAX:.4g})")
        count += int(inf.sum())
    return count


def _counting_streams(cell):
    """A stand-in for cell.cell_step that calls it and records each
    call's signal-stream count (the launch count stays the wrapper's)."""
    real, streams = cell.cell_step, []

    def step(h, c, xg, smaps, *a):
        streams.append(smaps.shape[-1])
        return real(h, c, xg, smaps, *a)
    return step, streams


def serving_inputs(tmp, task):
    """The CLI flags of a task's conditioning inputs for the served
    images: seeded attention maps (AiR) or a target category per image
    (COCO, SERVE_TARGETS in turn, so a batch holds three bank heads)."""
    if task == "air":
        rng = np.random.default_rng(3)
        paths = []
        for i in range(IMAGES):
            paths.append(os.path.join(tmp, f"att_{i:02d}.npy"))
            np.save(paths[-1], rng.uniform(0.05, 1.0, (24, 32)).astype(
                np.float32))
        return ["--predict_att", ",".join(paths)]
    if task == "coco":
        return ["--target_category", ",".join(
            SERVE_TARGETS[i % len(SERVE_TARGETS)] for i in range(IMAGES))]
    return []


def serving_images(tmp):
    """The IMAGES served images (640x480, seed 0), written once under
    ``tmp``; returns their dir."""
    from PIL import Image
    img_dir = os.path.join(tmp, "images")
    if not os.path.isdir(img_dir):
        rng = np.random.default_rng(0)
        os.makedirs(img_dir)
        for i in range(IMAGES):
            Image.fromarray(rng.integers(0, 256, (480, 640, 3),
                                         dtype=np.uint8)) \
                .save(os.path.join(img_dir, f"img_{i:02d}.png"))
    return img_dir


def run_slice(cell, block, predict, tmp, task):
    """The serving slice of one task; returns the launch counts of the
    served runs."""
    img_dir = serving_images(tmp)
    common = ["--task", task, "--predict_images", img_dir,
              "--batch", str(BATCH), "--embed", "512",
              "--backbone_layers", "3,4,6,3", "--height", "240",
              "--width", "320", "--map_height", "30", "--map_width", "40",
              "--max_length", str(SEQ), "--seed", "0", "--device", "cuda"] \
        + serving_inputs(tmp, task)
    runs = [("greedy", "false"), ("sample", "false"), ("greedy", "true"),
            ("sample", "true")]
    forwards = -(-IMAGES // BATCH)
    want_s = 2 if task == "air" else 1
    totals = {"cell_step": 0, "stage_apply": 0}
    for decode, half in runs:
        step, streams = _counting_streams(cell)
        cell.cell_launches = block.block_launches = 0
        t0 = time.perf_counter()
        with mock.patch.object(cell, "cell_step", step), \
                capture_durations() as calls:
            records = predict.main(common + [
                "--decode", decode, "--num_samples", "10",
                "--half_precision", half,
                "--predict_out", os.path.join(tmp, f"{decode}_{half}.json")])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        dc, db = cell.cell_launches, block.block_launches
        inf = overflowed_durations(
            calls, [min(BATCH, IMAGES - lo) for lo in range(0, IMAGES, BATCH)]
            if decode == "sample" else [], task, True)
        _check_records(records, IMAGES, 10 if decode == "sample" else 1,
                       320, 240, overflow=inf)
        if dc != SEQ * forwards or db != 3 * forwards or \
                set(streams) != {want_s}:
            raise AssertionError(
                f"{task} {decode} half={half}: {forwards} forwards launched "
                f"the cell kernel {dc} times (streams {sorted(set(streams))})"
                f" and the stage kernel {db} times (expected "
                f"{SEQ * forwards} with S={want_s} and {3 * forwards})")
        totals["cell_step"] += dc
        totals["stage_apply"] += db
        print(f"[slice] {task} predict --decode {decode} --half_precision "
              f"{half}: {len(records)} records from {IMAGES} images, "
              f"{forwards} forwards, cell launches {dc} (S={want_s}), stage "
              f"launches {db}, {secs:.2f} s wall (model build and image "
              f"load included); {inf} sampled durations overflow float32 "
              "(each past float32's range by its float64 exponent)",
              flush=True)
    return totals


# Input scale of the whole-output comparison.  The seed-weight network
# at full width is saturated on unit-scale inputs (|h| grows by one per
# decode step), and there the 16-step recurrence roughly triples a
# float-reassociation difference each step: the kernel and plain
# forwards then end ~0.5 apart in the probabilities although every
# kernel call agrees with its plain version to ~1e-6 (measured on an
# H100).  At a tenth of the scale the network is not saturated and the
# whole outputs are comparable at the float32 tolerance.
COMPARE_SCALE = 0.1


def _union_ms(spans):
    """The time (ms) covered by a list of (start, end) intervals in us."""
    busy, reach = 0.0, -math.inf
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, reach)) / 1e3
        reach = max(reach, hi)
    return busy


def _device_events(prof):
    """A finished torch.profiler's device events: (summed ms by kernel
    name, the (start, end) us intervals of each stream)."""
    from torch.autograd import DeviceType
    times, streams = {}, {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.time_range.end - evt.time_range.start
        times[evt.name] = times.get(evt.name, 0.0) + us / 1e3
        streams.setdefault(getattr(evt, "device_resource_id", None), []) \
            .append((evt.time_range.start, evt.time_range.end))
    return times, streams


def profile_call(fn, label):
    """One call of fn() under torch.profiler after a warm-up: the device
    busy time (the union of the kernels' and copies' intervals), the span
    between CUDA events around the call, the idle share, the cell
    kernel's share of the busy time, and the five largest kernels by
    summed time, as shares of the busy time (as in earlier records).
    Where the summed kernel time exceeds the busy time, kernels overlap:
    the line then gives each stream's kernels (the trace's stream ids),
    the overlap inside one stream and the overlap across streams.  The
    profiler adds host time, so the span is longer than an unprofiled
    call."""
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
    times, streams = _device_events(prof)
    busy = _union_ms([iv for ivs in streams.values() for iv in ivs])
    total = sum(times.values())
    if total == 0.0:
        print(f"[profile] {label}: the trace holds no device time",
              flush=True)
        return
    per_stream = {sid: _union_ms(ivs) for sid, ivs in streams.items()}
    inside = total - sum(per_stream.values())
    across = sum(per_stream.values()) - busy
    cell_ms = sum(v for k, v in times.items() if "cell_" in k)
    top = sorted(times.items(), key=lambda kv: -kv[1])[:5]
    print(f"[profile] {label}: device busy {busy:.2f} ms of a "
          f"{span:.2f} ms span ({100 * (1 - busy / span):.1f}% idle); kernel "
          f"time summed {total:.2f} ms on {len(streams)} stream(s) ("
          + ", ".join(f"id {sid}: {len(streams[sid])} events, "
                      f"{per_stream[sid]:.2f} ms covered"
                      for sid in sorted(streams, key=str))
          + f"), overlap {inside:.2f} ms inside a stream and {across:.2f} ms "
          f"across streams; cell kernel {cell_ms:.2f} ms "
          f"({100 * cell_ms / busy:.1f}% of busy); largest: "
          + "; ".join(f"{k[:60]} {v:.2f} ms ({100 * v / busy:.1f}%)"
                      for k, v in top), flush=True)


def forward_inputs(task):
    """A full-width batch for compare_forward: seeded images, attention
    maps in [0, 1] (AiR, COCO) and task ids (COCO, SERVE_TARGETS in
    turn), as numpy arrays."""
    from scanpaths_tpu_torch.data.datasets import COCO_OBJECT_NAMES
    rng = np.random.default_rng(1)
    images = rng.standard_normal((BATCH, 240, 320, 3)).astype(np.float32)
    maps = tids = None
    if task != "osie":
        maps = rng.uniform(0, 1, (BATCH, 30, 40, 1)).astype(np.float32)
    if task == "coco":
        tids = np.asarray([COCO_OBJECT_NAMES.index(
            SERVE_TARGETS[i % len(SERVE_TARGETS)]) for i in range(BATCH)],
            np.int32)
    return images, maps, tids


def compare_forward(cell, block, predictor_mod, task):
    """Full-width forwards of one task through the kernels and the plain
    versions on the same weights and inputs: every kernel call of the
    served forward checked against its plain version on the same inputs,
    the whole outputs (every key, both AiR streams) compared at
    COMPARE_SCALE, and both forwards timed and profiled."""
    from scanpaths_tpu_torch.core.config import parse_opt
    images, maps, tids = forward_inputs(task)

    def plain():
        return (mock.patch.object(cell, "cell_step", cell.cell_step_plain),
                mock.patch.object(block, "stage_apply",
                                  block.stage_apply_plain))

    for half, tol in (("false", F32_TOL), ("true", BF16_TOL)):
        args = parse_opt(["--task", task, "--seed", "0",
                          "--half_precision", half])
        pred = predictor_mod.Predictor(args, "cuda")
        errs = {"cell_step": [], "stage_apply": []}
        streams = []
        # float32 only: the kernel's and the plain version's errors against
        # the plain version in float64 on the same inputs, per call
        f64_errs = {"kernel": [], "plain": []}
        cell_k, stage_k = cell.cell_step, block.stage_apply

        def checked_cell(h, c, *a):
            streams.append(a[1].shape[-1])
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
            pred.forward(images, maps, tids)
        torch.cuda.synchronize()
        if len(errs["cell_step"]) != SEQ or len(errs["stage_apply"]) != 3:
            raise AssertionError(f"{task} forward: {len(errs['cell_step'])} "
                                 f"cell and {len(errs['stage_apply'])} stage "
                                 "calls")
        print(f"[slice] {task} forward half={half}: each kernel call checked "
              f"against its plain version on the same inputs: "
              + ", ".join(f"{k} {len(v)} calls, max abs err {max(v):.3g}"
                          for k, v in errs.items())
              + f"; signal streams of the cell calls: {streams}", flush=True)
        if half == "false":
            print(f"[slice] {task} forward half=false: cell_step max abs err "
                  "against its plain version in float64, calls 1 and 16 "
                  "(largest): "
                  + ", ".join(f"{side} {v[0]:.3g} and {v[-1]:.3g} "
                              f"({max(v):.3g})" for side, v in f64_errs.items())
                  + " (plain = cuDNN's float32 conv without TF32)",
                  flush=True)

        def kern(x=images):
            return pred.forward(x, maps, tids)

        def ref(x=images):
            p1, p2 = plain()
            with p1, p2:
                return pred.forward(x, maps, tids)
        out_k, out_p = kern(), ref()
        for k in out_k:
            if not bool(torch.isfinite(out_k[k]).all()):
                raise AssertionError(f"{task} forward output {k} not finite")
        unit = {k: float((out_k[k] - out_p[k]).abs().max()) for k in out_k}
        scaled = COMPARE_SCALE * images
        out_k, out_p = kern(scaled), ref(scaled)
        torch.cuda.synchronize()
        if half == "false":
            for k in out_k:
                _close(f"{task} forward {k} at scale {COMPARE_SCALE}",
                       out_k[k], out_p[k], F32_TOL, scaled=True)
        ms, plain_ms = _pair_ms(kern, ref, 3)
        profile_call(kern, f"forward {task} N={BATCH} half={half}")
        print(f"[slice] {task} forward N={BATCH} 240x320 T={SEQ} half={half}: "
              f"{ms:.2f} ms with kernels, {plain_ms:.2f} ms plain; "
              f"outputs max abs err at input scale {COMPARE_SCALE}"
              + (" (checked)" if half == "false" else "") + ": "
              + ", ".join(f"{k} {float((out_k[k] - out_p[k]).abs().max()):.3g}"
                          for k in out_k)
              + "; at unit scale (saturated, not checked): "
              + ", ".join(f"{k} {v:.3g}" for k, v in unit.items()),
              flush=True)
        del pred


def _fixations(rng, w, h):
    """One subject's scanpath on a w x h frame: 3-20 fixations of
    100-800 ms."""
    n = int(rng.integers(3, 21))
    return (n, rng.uniform(0, w, n).tolist(), rng.uniform(0, h, n).tolist(),
            rng.uniform(100, 800, n))


def _write_records(task, rng, img_dir, att_dir, n=None, first=0):
    """A split's records (and images, attention maps, detector boxes) of
    one task at its dataset's frame, for the ``n`` (TEST_IMAGES) images
    numbered from ``first``; returns (records, detector)."""
    from PIL import Image

    from scanpaths_tpu_torch.data.datasets import COCO_OBJECT_NAMES

    def image(path, h, w):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)) \
            .save(path)
    recs, dets = [], []
    for i in range(first, first + (n or TEST_IMAGES)):
        if task == "osie":
            h, w, name = 600, 800, f"{1001 + i}.jpg"
            image(os.path.join(img_dir, name), h, w)
        elif task == "air":
            h, w = int(rng.integers(300, 701)), int(rng.integers(400, 901))
            name, qid = f"air_{i:03d}.jpg", f"q{i:05d}"
            answer = ("yes", "no")[i % 2]
            image(os.path.join(img_dir, name), h, w)
            np.save(os.path.join(att_dir, qid + ".npy"),
                    rng.uniform(0.05, 1.0, (h // 20, w // 20)).astype(
                        np.float32))
        else:
            h, w, name = 320, 512, f"{i:012d}.jpg"
            cat = SPLIT_TARGETS[i % len(SPLIT_TARGETS)]
            other = COCO_OBJECT_NAMES[(COCO_OBJECT_NAMES.index(cat) + 1) % 18]
            os.makedirs(os.path.join(img_dir, cat), exist_ok=True)
            image(os.path.join(img_dir, cat, name), h, w)
            # the target's boxes above and below the threshold, and
            # another category's box above it
            for category, score in ((cat, 0.95), (cat, 0.5), (other, 0.9)):
                x0, y0 = rng.uniform(0, w - 120), rng.uniform(0, h - 100)
                dets.append({"image_id": name.split(".")[0],
                             "category": category, "score": score,
                             "bbox": [x0, y0, x0 + rng.uniform(40, 120),
                                      y0 + rng.uniform(30, 100)]})
        for subject in range(TEST_SUBJECTS[task]):
            n, xs, ys, dur = _fixations(rng, w, h)
            rec = {"X": xs, "Y": ys, "length": n}
            if task == "osie":
                rec.update(name=name, subject=subject, T=dur.tolist())
            elif task == "coco":
                rec.update(name=name, task=cat, subject=subject,
                           T=dur.tolist())
            else:
                start = np.concatenate([[0.0], np.cumsum(dur)[:-1]])
                # 9 right answers, 3 wrong and 3 failed a question (an
                # assumed mix, see TEST_SUBJECTS)
                given = (answer if subject % 5 < 3 else
                         "faild" if subject % 5 == 4 else
                         ("no", "yes")[i % 2])
                rec.update(image_id=name, question_id=qid, height=h,
                           width=w, T_start=start.tolist(),
                           T_end=(start + dur).tolist(), answer=answer,
                           subject_answer=given)
            recs.append(rec)
    return recs, dets


def _split_file(task, split):
    return {"osie": f"osie_fixations_{split}.json",
            "air": f"AiR_fixations_{split}.json",
            "coco": f"coco_search18_fixations_TP_{split}_split1.json"}[task]


def _task_dirs(root):
    """(images, fixations, maps) dirs under ``root``, created."""
    dirs = [os.path.join(root, d) for d in ("images", "fixations", "maps")]
    for d in dirs:
        os.makedirs(d)
    return dirs


def write_test_split(tmp, task):
    """A synthetic evaluation split of one task and a reference-layout
    checkpoint of full-width seed weights, all from seed 0 (module
    docstring, phase 3).  Returns the test CLI's flags."""
    from scanpaths_tpu_torch.models import port
    from scanpaths_tpu_torch.models.scanpath_model import (ScanpathModel,
                                                           init_weights)
    rng = np.random.default_rng(0)
    root = os.path.join(tmp, task)
    img_dir, fix_dir, att_dir = _task_dirs(root)
    run_dir = os.path.join(root, "run")
    os.makedirs(os.path.join(run_dir, "checkpoints"))
    recs, dets = _write_records(task, rng, img_dir, att_dir)
    # the same records serve as the train split (phase 7)
    for split in ("train", "validation" if task == "coco" else "test"):
        with open(os.path.join(fix_dir, _split_file(task, split)), "w") as f:
            json.dump(recs, f)
    if task == "coco":
        with open(os.path.join(att_dir, "coco_search18_detector.json"),
                  "w") as f:
            json.dump(dets, f)
    model = ScanpathModel(task)                # full width, float32
    init_weights(model, 0)
    torch.save(port.to_reference_state_dict(model.state_dict(), task,
                                            model.map_h, model.map_w),
               os.path.join(run_dir, "checkpoints", "checkpoint_best.pth"))
    del model
    maps = {"air": ["--att_dir", att_dir], "coco": ["--detector_dir", att_dir]}
    return ["--task", task, "--img_dir", img_dir, "--fix_dir", fix_dir,
            "--evaluation_dir", run_dir, "--batch", str(TEST_BATCH),
            "--eval_repeat_num", str(REPEATS), "--seed", "0",
            "--device_eval", "true", "--device", "cuda"] + maps.get(task, [])


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
    split = "validation" if args.task == "coco" else "test"
    ds = EvaluationDataset(args.task, trainer.data_config(args), split=split)
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


def nw_shapes(tm, batch, specs, task):
    """Every NW launch shape of one test-driver run of ``task``, from the
    split's first batch: [(label, launches per run, spec, (fix_a, len_a,
    fix_b, len_b))].  Per spec, the human baseline (every ordered subject
    pair, ``device_eval.human_rows``) runs once per batch and
    ``pair_rows`` (GT subjects against a rollout batch) once per repeat
    per batch per stream (AiR decodes two)."""
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
    streams = 2 if task == "air" else 1
    return [(f"{part} {label}", runs, spec, pairs)
            for part, runs, pairs in (
                ("human baseline", forwards, human),
                ("pair_rows", REPEATS * forwards * streams, rows))
            for label, spec in zip(("w/ duration", "w/o duration"), specs)]


def nw_call_stats(nw, args, iters=200):
    """One NW call ``nw.nw_scores_bins(*args)`` timed: {"ms" (CUDA events
    over ``iters`` calls, in turns with the plain version), "plain_ms",
    "bound_ms", "bound_by", "shape", "text" (the printed account: the
    kernel's device time in a profiler trace, the wrapper's host time,
    the bound and the DP cells)}."""
    ms, plain_ms = _pair_ms(lambda: nw.nw_scores_bins(*args),
                            lambda: nw.nw_scores_bins_plain(*args), iters, 3)
    dev_ms, host_ms = _device_and_host_ms(lambda: nw.nw_scores_bins(*args),
                                          "nw_kernel", iters)
    sa, na, sb, nb = args[3:]
    b, ta = sa.shape
    tb = sb.shape[1]
    cells = int((na.clamp(0, ta).long() * nb.clamp(0, tb).long()).sum())
    bound_ms, bound_by = _bound(NW_OPS_PER_CELL * cells,
                                4 * (b * (ta + tb) + 3 * b),
                                PEAK_FLOPS[torch.float32])
    text = (f"{ms:.4f} ms a call (kernel on the device "
            + ("not in the trace" if dev_ms is None else f"{dev_ms:.4f} ms")
            + f", host {host_ms:.4f} ms; plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.5f} ms by {bound_by}, {100 * bound_ms / ms:.1f}% "
            f"of bound: {cells} DP cells; the longest row chain is "
            f"{int(na.max())} rows)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, shape=f"B={b} Ta={ta} Tb={tb}", text=text)


def check_nw(nw, tm, firsts):
    """The NW kernel against its plain version, exactly, and timed at
    every shape each task's test driver launches it (``nw_shapes``;
    ``firsts`` maps a task to its split's first batch and specs), then
    on ragged cases.  Prints each task's NW ms per test run (the
    launches of one run times their ms, summed over shapes).  Returns
    the summary at OSIE's human-baseline w/-duration shape, with each
    task's per-run ms added."""
    summary = None
    for task, (batch, specs) in firsts.items():
        per_run, launches = 0.0, 0
        for label, runs, spec, pairs in nw_shapes(tm, batch, specs, task):
            sa, na = tm.quantize(spec, *pairs[:2])
            sb, nb = tm.quantize(spec, *pairs[2:])
            args = (spec.threshold, spec.xbin, spec.ybin, sa.contiguous(),
                    na.contiguous(), sb.contiguous(), nb.contiguous())
            got = nw.nw_scores_bins(*args)
            want = nw.nw_scores_bins_plain(*args)
            torch.cuda.synchronize()
            err = _exact(f"nw {task} {label}", got, want)
            st = nw_call_stats(nw, args)
            per_run += runs * st["ms"]
            launches += runs
            print(f"[kernels] nw {task} {label} {st['shape']}: max_abs_err "
                  f"{err}, NaN {int(torch.isnan(got).sum())}, {st['text']}; "
                  f"{runs} launches per test run", flush=True)
            if summary is None:
                summary = dict(max_abs_err=err, **{
                    k: st[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by")})
        print(f"[kernels] nw {task} ms per test run: {per_run:.4f} ms over "
              f"{launches} launches", flush=True)
        summary[f"{task}_ms_per_test_run"] = per_run

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


def compare_with_host(device_eval, heval, batch, specs, captured, task):
    """The float32 device sweep against the host suite on the first
    batch's human baseline and its first two repeats of each stream:
    ``captured`` holds those sweep calls' arguments (AiR's with the
    subjects' answer flags and the stream's; bucketed on both sides).

    The seed-weight model samples LogNormal durations of up to hours,
    which the host ScanMatch expands into millions of symbols (it ran a
    96 GiB machine out of memory) and the device sweep truncates at its
    table by design.  So both sides get the captured rollouts with their
    durations capped at PRED_DURATION_CAP: every rollout then fits the
    w/-duration table and all nine columns compare."""
    from scanpaths_tpu_torch.core.grid import fix_vector
    t0 = time.perf_counter()
    want = heval.human_evaluation([batch], task=task)[:2]
    got = device_eval.human_evaluation_device([batch], *specs, task=task,
                                              device="cuda")[:2]
    err_h = max(_tree_close(f"{task} human {part}", w, g)
                for part, w, g in zip(("metrics", "stds"), want, got))
    sweep = device_eval.DeviceSweep(*specs)
    gts, preds, perfs, allocs, capped = [], [], [], [], 0
    for gt_fix, gt_len, gt_mask, pred_fix, pred_len, *air in captured:
        valid = torch.arange(pred_fix.shape[1], device=pred_fix.device) \
            < pred_len[:, None]
        capped += int(((pred_fix[..., 2] > PRED_DURATION_CAP) & valid).sum())
        pred_fix = pred_fix.clone()
        pred_fix[..., 2].clamp_(max=PRED_DURATION_CAP)
        args = (gt_fix, gt_len, gt_mask, pred_fix, pred_len)
        if air:
            sweep.add_batch_air(*args, *air)
            perfs.extend(air[0])
            allocs.extend([air[1]] * len(air[0]))
        else:
            sweep.add_batch(*args)
        gts.extend(batch["fix_vectors"])
        fix, lens = pred_fix.cpu().numpy(), pred_len.cpu().numpy()
        preds.extend(fix_vector(fix[i, :n, 0], fix[i, :n, 1], fix[i, :n, 2])
                     for i, n in enumerate(lens))
    if sweep.overflow["count"]:
        raise AssertionError(f"capped rollouts overflow the w/-duration "
                             f"table: {sweep.overflow}")
    want = (heval.evaluation_performance_related(gts, preds, perfs, allocs)
            if task == "air" else heval.evaluation(gts, preds))[:2]
    got = sweep.result()
    err_p = max(_tree_close(f"{task} repeats {part}", w, g)
                for part, w, g in zip(("metrics", "stds"), want, got))
    print(f"[test] {task} float32 device sweep vs host suite, first batch: "
          f"human baseline ({len(batch['img_names'])} images, "
          f"{sum(len(v) * (len(v) - 1) for v in batch['fix_vectors'])} "
          f"pairs) max abs diff {err_h:.3g}; repeats 1-2 of "
          f"{len(captured) // 2} stream(s) ({len(preds)} rollouts, {capped} "
          f"fixations capped at {PRED_DURATION_CAP} s) max abs diff "
          f"{err_p:.3g}; rtol {HOST_RTOL}, atol {HOST_ATOL}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def _check_tree(metrics):
    """The metric tree of a test run (each answer bucket of AiR's):
    ScanMatch in [0, 1], STDE in [0, 1], SED >= 0, all finite; MultiMatch
    in [0, 1] or NaN (NaN when every rollout has fewer than 3
    fixations)."""
    if "all" in metrics:
        for bucket in metrics.values():
            _check_tree(bucket)
        return
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
    """The test CLI of one task with the device sweep at full width,
    float32 and bfloat16; returns the launch counts of both runs.
    ``batch`` and ``specs`` are the split's first batch and the sweep's
    specs."""
    task = argv[argv.index("--task") + 1]
    streams = 2 if task == "air" else 1
    print(f"[test] {task} split: {TEST_IMAGES} images x "
          f"{TEST_SUBJECTS[task]} subjects, w/-duration table "
          f"{specs[0].max_symbols} symbols, w/o-duration table "
          f"{specs[1].max_symbols}", flush=True)
    forwards = -(-TEST_IMAGES // TEST_BATCH)
    want = {"cell_step": SEQ * forwards, "stage_apply": 3 * forwards,
            "nw_scores_bins": 2 * forwards
            + 2 * REPEATS * forwards * streams}
    totals = dict.fromkeys(want, 0)
    real_add = device_eval.DeviceSweep.add_batch
    real_add_air = device_eval.DeviceSweep.add_batch_air
    from scanpaths_tpu_torch.train import trainer as tr
    real_human = tr.human_evaluation_device
    for half in ("false", "true"):
        captured, sweep_secs = [], [0.0]

        def timed(real):
            def add(self, *a):
                # the first batch's first two repeats of each stream
                if len([c for c in captured if c[6:] == list(a[6:])]) < 2:
                    captured.append([x.detach().clone()
                                     if torch.is_tensor(x) else x
                                     for x in a])
                t = time.perf_counter()
                real(self, *a)
                sweep_secs[0] += time.perf_counter() - t
            return add

        def human(*a, **kw):
            t = time.perf_counter()
            out = real_human(*a, **kw)
            sweep_secs[0] += time.perf_counter() - t
            return out

        cell.cell_launches = block.block_launches = nw.nw_launches = 0
        t0 = time.perf_counter()
        # the CLI's logger echoes its metric trees (log_test.txt keeps
        # them); they stay off the console, which keeps this script's
        # own lines
        with mock.patch.object(device_eval.DeviceSweep, "add_batch",
                               timed(real_add)), \
                mock.patch.object(device_eval.DeviceSweep, "add_batch_air",
                                  timed(real_add_air)), \
                mock.patch.object(tr, "human_evaluation_device", human), \
                capture_durations() as calls, \
                contextlib.redirect_stdout(io.StringIO()):
            metrics = test_cli.main(argv + ["--half_precision", half])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = {"cell_step": cell.cell_launches,
               "stage_apply": block.block_launches,
               "nw_scores_bins": nw.nw_launches}
        if got != want:
            raise AssertionError(f"{task} test --half_precision {half}: "
                                 f"launches {got}, expected {want}")
        for k, v in got.items():
            totals[k] += v
        run_dir = argv[argv.index("--evaluation_dir") + 1]
        out = "validation" if task == "coco" else "test"
        with open(os.path.join(run_dir, f"{out}_predicts.json")) as f:
            records = json.load(f)
        extra = {"air": ("qid", "performance"), "coco": ("task",)}
        inf = overflowed_durations(
            calls, [min(TEST_BATCH, TEST_IMAGES - lo)
                    for lo in range(0, TEST_IMAGES, TEST_BATCH)
                    for _ in range(streams)], task, False)
        _check_records(records, TEST_IMAGES, REPEATS * streams, 320, 240,
                       extra.get(task), inf)
        _check_tree(metrics)
        print(f"[test] {task} test --device_eval true --half_precision "
              f"{half}: {len(records)} records in {out}_predicts.json "
              f"({inf} sampled durations overflow float32), "
              f"launches {got}, {secs:.2f} s wall, device sweep "
              f"{sweep_secs[0]:.2f} s ({100 * sweep_secs[0] / secs:.1f}%)",
              flush=True)
        if half == "false":
            compare_with_host(device_eval, heval, batch, specs, captured,
                              task)
    return totals


# ---------------------------------------------------------------------------
# phase 7: training
# ---------------------------------------------------------------------------

def _train_args(argv):
    """The flags of a task's training run: the test split's (geometry,
    --batch 16, --seed 0) with the training defaults of core/config.py
    (lr 1e-4, clip 12.5, rl_sample_number 5, warmup 1 of 10 epochs, RL
    from epoch 5)."""
    import argparse

    from scanpaths_tpu_torch.core.config import parse_opt
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device")
    return parse_opt(pre.parse_known_args(argv)[1])


def _train_model(args, dtype=torch.float32):
    """A full-width model of the run's task from seed 0, on the CPU, with
    two convs scaled.  The duration head's last conv by 0.01, as the JAX
    package's own SCST test does
    (tests/test_train.py::test_rl_step_improves_reward): the seed head's
    LogNormal scale overflows float32 in the sampler, and an infinite
    rollout duration has no log-density.  sal_conv (weight and bias) by
    COMPARE_SCALE, which scales the decoder's visual features: at unit
    scale the seed decoder saturates (|h| grows by one a step) and two
    summation orders end far apart (check_train_parity compares two).  A
    train-mode BN undoes an input scale, so the features are scaled, not
    the images."""
    from scanpaths_tpu_torch.models.scanpath_model import (ScanpathModel,
                                                           init_weights)
    layers = tuple(int(v) for v in str(args.backbone_layers).split(","))
    model = ScanpathModel(args.task, embed=args.embed,
                          seq_len=args.max_length, map_h=args.map_height,
                          map_w=args.map_width, backbone_layers=layers,
                          dtype=dtype)
    init_weights(model, args.seed)
    with torch.no_grad():
        model.head.drt_layer_2.weight.mul_(0.01)
        model.sal_conv.weight.mul_(COMPARE_SCALE)
        model.sal_conv.bias.mul_(COMPARE_SCALE)
    return model


@contextlib.contextmanager
def _timed_calls(module, name, calls, keep_args=False):
    """Wraps ``module.name``: each call is bracketed by CUDA events and
    recorded in ``calls`` as (start, end, args cloned or None, result
    cloned or None)."""
    real = getattr(module, name)

    def call(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kw)
        end.record()
        calls.append((start, end,
                      [a.clone() if torch.is_tensor(a) else a for a in args]
                      if keep_args else None,
                      out.clone() if keep_args else None))
        return out
    with mock.patch.object(module, name, call):
        yield calls


def _event_ms(calls):
    return sum(start.elapsed_time(end) for start, end, *_ in calls)


def _finite(task, label, metrics):
    values = {k: float(v) for k, v in metrics.items()}
    bad = {k: v for k, v in values.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"{task} {label}: non-finite metrics {bad}")
    return values


def _mib(nbytes):
    return nbytes / 2 ** 20


def check_grad_refusal(cell, block):
    """The cell and stage kernels define no backward: on the card, under
    grad mode, each wrapper raises for any input that requires grad,
    before it launches anything."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = (("cell_step", cell.cell_step,
              _cell_inputs(1, 4, 5, 64, 1, torch.float32, gen)),
             ("stage_apply", lambda **kw: block.stage_apply(dil=1, **kw),
              _stage_inputs(1, 4, 5, 64, 32, 1, torch.float32, gen)))
    for name, fn, args in cases:
        for k in args:
            kw = dict(args, **{k: args[k].clone().requires_grad_(True)})
            try:
                fn(**kw)
            except RuntimeError as e:
                if f"{name} has no backward" in str(e):
                    continue
                raise
            raise AssertionError(f"{name} ran under grad mode with {k} "
                                 "requiring grad")
    print("[train] cell_step and stage_apply raise on the card under grad "
          "mode for each input that requires grad", flush=True)


def run_train_slice(cell, block, nw, argv):
    """The training phase of one task at full width on the card: three
    supervised steps at --batch on one batch of the synthetic train split
    (SupervisedDataset), then three SCST steps at --batch / 4 with
    --rl_sample_number rollouts (EvaluationDataset batches, as the JAX
    trainer feeds them), and for OSIE two bfloat16 supervised steps.  The
    kernels' launch counts are zeroed before the steps and read after
    them: the supervised steps launch none (the cell and stage kernels
    have no backward), each SCST step launches the NW kernel twice per
    stream (its ScanMatch reward grids w/ and w/o duration).  Then one
    more step of each kind is profiled, every NW call of the timed SCST
    steps is held to the plain NW on the same inputs exactly, and timed
    at its shape.  Returns (the launch counts, the NW ms per SCST step,
    the first supervised batch)."""
    from scanpaths_tpu_torch.data.datasets import (EvaluationDataset, Loader,
                                                   SupervisedDataset)
    from scanpaths_tpu_torch.train import steps, trainer
    args = _train_args(argv)
    task = args.task
    cfg = trainer.data_config(args)
    sup_loader = Loader(SupervisedDataset(task, cfg, "train"),
                        batch_size=args.batch, shuffle=True, seed=args.seed,
                        drop_last=True)
    rl_loader = Loader(EvaluationDataset(task, cfg, "train"),
                       batch_size=max(args.batch // 4, 1), shuffle=True,
                       seed=args.seed + 1, drop_last=True)
    rl_cfg = trainer.rl_config(args, rl_loader.dataset)
    # the first steps of a run, as the trainer takes them: the warmup
    # multiplier is 0 at step 0 (a step moves nothing), then rises by
    # 1 / len(sup_loader) a step.  From fresh moments at the full lr, two
    # sign-like Adam steps along one gradient overshoot the repeated
    # batch (the loss went 7.67, 7.50, 14.39 in a run on an H100).
    start = 1
    sup_batch = next(iter(sup_loader))
    rl_batches = list(itertools.islice(rl_loader, TRAIN_STEPS))
    streams = 2 if task == "air" else 1
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    cell.cell_launches = block.block_launches = nw.nw_launches = 0
    torch.cuda.reset_peak_memory_stats()
    state = steps.TrainState.create(_train_model(args), args,
                                    len(sup_loader), len(rl_loader),
                                    step=start, device="cuda")
    db = steps.device_batch(sup_batch, "cuda", for_rl=False)
    sup_ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = _finite(task, "supervised step",
                    steps.supervised_step(state, db, args.lambda_1))
        sup_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(m)
    sup_peak = torch.cuda.max_memory_allocated()
    n_sup, n_rl = args.batch, max(args.batch // 4, 1)
    steady = sum(sup_ms[1:]) / (len(sup_ms) - 1)
    print(f"[train] {task} supervised step, batch {n_sup}, float32: "
          + ", ".join(f"{v:.1f}" for v in sup_ms)
          + f" ms (steps 2-{TRAIN_STEPS}: {steady:.1f} ms, "
          f"{1e3 * n_sup / steady:.1f} images/s); loss "
          + ", ".join(f"{m['loss']:.4f} ({m['loss_actions']:.4f} + "
                      f"{m['loss_duration']:.4f})" for m in losses)
          + " (actions + duration) on the repeated batch; grad norm "
          + ", ".join(f"{m['grad_norm']:.4g}" for m in losses)
          + f"; peak allocated {_mib(sup_peak):.0f} MiB", flush=True)
    if not losses[-1]["loss"] < losses[0]["loss"]:
        raise AssertionError(f"{task}: the supervised loss did not fall on a "
                             f"repeated batch: {[m['loss'] for m in losses]}")

    torch.cuda.reset_peak_memory_stats()
    rl_ms, reward_ms, nw_ms, rl_metrics, nw_calls = [], [], [], [], []
    for b in rl_batches:
        rdb = steps.device_batch(b, "cuda", for_rl=True)
        grids, calls = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _timed_calls(steps, "_pair_grids", grids), \
                _timed_calls(steps, "_gtpairs_cd_target", grids), \
                _timed_calls(nw, "nw_scores_bins", calls, keep_args=True):
            m = steps.rl_step(state, rdb, rl_cfg, generator=gen)
            rl_metrics.append(_finite(task, "SCST step", m))
        rl_ms.append(1e3 * (time.perf_counter() - t0))
        reward_ms.append(_event_ms(grids))
        nw_ms.append(_event_ms(calls))
        nw_calls.append(calls)
    rl_peak = torch.cuda.max_memory_allocated()

    bf16 = None
    if task == "osie":
        # the bf16 step (the first call of a dtype autotunes cuDNN: a
        # second step gives its steady time)
        torch.cuda.reset_peak_memory_stats()
        model = _train_model(args, torch.bfloat16)
        half = steps.TrainState.create(model, args, len(sup_loader),
                                       len(rl_loader), step=start,
                                       device="cuda")
        before = model.sal_conv.weight.detach().clone()
        bf16 = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = _finite(task, "bf16 supervised step",
                        steps.supervised_step(half, db, args.lambda_1))
            bf16.append((1e3 * (time.perf_counter() - t0), m))
        bf16_peak = torch.cuda.max_memory_allocated()
        if not all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
                   for p in model.parameters()) or \
                torch.equal(model.sal_conv.weight, before):
            raise AssertionError("osie bf16 supervised step: the float32 "
                                 "parameters did not move or are not finite")
        del half, model
    got = {"cell_step": cell.cell_launches,
           "stage_apply": block.block_launches,
           "nw_scores_bins": nw.nw_launches}
    want = {"cell_step": 0, "stage_apply": 0,
            "nw_scores_bins": TRAIN_STEPS * streams * 2
            + (TRAIN_STEPS * 2 if rl_cfg.apply_cd else 0)}
    if got != want:
        raise AssertionError(f"{task} training: launches {got}, expected "
                             f"{want}")
    # where a step's time goes (each after one more warm step)
    profile_call(lambda: steps.supervised_step(state, db, args.lambda_1),
                 f"{task} supervised step, batch {args.batch}, float32")
    rdb = steps.device_batch(rl_batches[-1], "cuda", for_rl=True)
    profile_call(lambda: steps.rl_step(state, rdb, rl_cfg, generator=gen),
                 f"{task} SCST step, batch {max(args.batch // 4, 1)}, "
                 "float32")
    del state
    torch.cuda.empty_cache()

    steady_rl = sum(rl_ms[1:]) / (len(rl_ms) - 1)
    print(f"[train] {task} SCST step, batch {n_rl} x "
          f"{rl_cfg.rl_sample_number} rollouts"
          + (" per stream" if streams == 2 else "") + ", float32: "
          + ", ".join(f"{v:.1f}" for v in rl_ms)
          + f" ms (steps 2-{TRAIN_STEPS}: {steady_rl:.1f} ms, "
          f"{1e3 * n_rl / steady_rl:.2f} images/s); reward grids "
          + ", ".join(f"{v:.1f}" for v in reward_ms)
          + " ms (" + ", ".join(f"{100 * r / s:.1f}%"
                                for r, s in zip(reward_ms, rl_ms))
          + " of the step), NW inside them "
          + ", ".join(f"{v:.3f}" for v in nw_ms)
          + f" ms over {len(nw_calls[0])} launches a step; rl_loss "
          + ", ".join(f"{m['rl_loss']:.4g}" for m in rl_metrics)
          + "; " + ", ".join(f"{k} {v:.4g}" for k, v in rl_metrics[-1].items()
                             if k not in ("rl_loss",))
          + f"; peak allocated {_mib(rl_peak):.0f} MiB", flush=True)
    if bf16:
        print(f"[train] {task} supervised step, batch {n_sup}, bfloat16 "
              "compute with float32 parameters, first call and second: "
              + ", ".join(f"{ms:.1f}" for ms, _ in bf16) + " ms; loss "
              + ", ".join(f"{m['loss']:.4f}" for _, m in bf16)
              + ", grad norm " + ", ".join(f"{m['grad_norm']:.4g}"
                                           for _, m in bf16)
              + f"; peak allocated {_mib(bf16_peak):.0f} MiB", flush=True)

    # every NW call of the SCST steps against the plain NW, exactly
    for i, calls in enumerate(nw_calls):
        for j, (_, _, a, out) in enumerate(calls):
            _exact(f"{task} SCST step {i + 1} NW call {j + 1}", out,
                   nw.nw_scores_bins_plain(*a))
    torch.cuda.synchronize()
    per_step = 0.0
    for j, (_, _, a, _) in enumerate(nw_calls[-1]):
        # the reward grids run w/ duration, then w/o, for each stream
        label = ("good ", "poor ")[j // 2] if streams == 2 else ""
        label += ("w/ duration", "w/o duration")[j % 2] if j < 2 * streams \
            else "CD target"
        st = nw_call_stats(nw, a)
        per_step += st["ms"]
        print(f"[train] nw {task} SCST reward {label} {st['shape']}: "
              f"{st['text']}", flush=True)
    print(f"[train] {task} SCST reward grids of {TRAIN_STEPS} steps: "
          f"{sum(len(c) for c in nw_calls)} NW calls held to the plain NW "
          f"exactly (max abs err 0, NaN in the same places); NW "
          f"{per_step:.4f} ms a step at these shapes", flush=True)
    return got, per_step, sup_batch


def check_train_parity(argv, batch):
    """One supervised step at batch PARITY_BATCH, full width, on the card
    and on the CPU from the same weights (_train_model's) and the same
    samples: the loss, its two terms and the global gradient norm within
    PARITY_RTOL."""
    from scanpaths_tpu_torch.train import steps
    args = _train_args(argv)
    small = {k: v[:PARITY_BATCH] for k, v in batch.items()
             if k in steps.SUPERVISED_KEYS}
    got = {}
    for dev in ("cpu", "cuda"):
        state = steps.TrainState.create(_train_model(args), args, 1, 1,
                                        step=1, device=dev)
        t0 = time.perf_counter()
        m = steps.supervised_step(state, steps.device_batch(small, dev,
                                                            for_rl=False),
                                  args.lambda_1)
        got[dev] = (_finite(args.task, f"supervised step on {dev}", m),
                    time.perf_counter() - t0)
        del state
    (cpu, cpu_s), (gpu, gpu_s) = got["cpu"], got["cuda"]
    rel = {k: abs(gpu[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu}
    print(f"[train] {args.task} supervised step at batch {PARITY_BATCH}, "
          f"card against CPU: "
          + ", ".join(f"{k} {gpu[k]:.6g} vs {cpu[k]:.6g} (rel {rel[k]:.2g})"
                      for k in cpu)
          + f"; rtol {PARITY_RTOL}; CPU step {cpu_s:.1f} s, card step "
          f"{gpu_s:.2f} s (first call)", flush=True)
    bad = {k: v for k, v in rel.items() if not v <= PARITY_RTOL}
    if bad:
        raise AssertionError(f"supervised step card vs CPU: {bad}")


# ---------------------------------------------------------------------------
# phase 8: the trainer
# ---------------------------------------------------------------------------

# phase 8's splits: train and validation images per task (the validation
# split is also OSIE's and AiR's test split; COCO's test driver reads its
# validation split), and the steps of each epoch profiled
TRAINER_IMAGES, VALIDATION_IMAGES = 32, 16
PROFILE_STEPS = 3


def write_trainer_split(tmp, task):
    """Phase 8's data for one task, from seed 0: a train split of
    TRAINER_IMAGES images and a validation split of VALIDATION_IMAGES
    others, at phase 3's frames and subject counts.  Returns the train
    CLI's flags (full width, --batch 16, --eval_repeat_num 10, one
    supervised and one SCST epoch, the device sweep)."""
    rng = np.random.default_rng(0)
    root = os.path.join(tmp, "trainer", task)
    img_dir, fix_dir, att_dir = _task_dirs(root)
    train, dets = _write_records(task, rng, img_dir, att_dir, TRAINER_IMAGES)
    val, val_dets = _write_records(task, rng, img_dir, att_dir,
                                   VALIDATION_IMAGES, first=TRAINER_IMAGES)
    splits = {"train": train, "validation": val}
    if task != "coco":
        splits["test"] = val
    for split, recs in splits.items():
        with open(os.path.join(fix_dir, _split_file(task, split)), "w") as f:
            json.dump(recs, f)
    if task == "coco":
        with open(os.path.join(att_dir, "coco_search18_detector.json"),
                  "w") as f:
            json.dump(dets + val_dets, f)
    maps = {"air": ["--att_dir", att_dir], "coco": ["--detector_dir", att_dir]}
    return ["--task", task, "--img_dir", img_dir, "--fix_dir", fix_dir,
            "--log_root", os.path.join(root, "logs"),
            "--batch", str(TEST_BATCH), "--eval_repeat_num", str(REPEATS),
            "--seed", "0", "--epoch", "2", "--start_rl_epoch", "1",
            "--warmup_epoch", "1", "--device_eval", "true",
            "--device", "cuda"] + maps.get(task, [])


def _launches(cell, block, nw):
    return {"cell_step": cell.cell_launches,
            "stage_apply": block.block_launches,
            "nw_scores_bins": nw.nw_launches}


def _minus(a, b):
    return {k: a[k] - b[k] for k in a}


def _expect(label, got, want):
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


@contextlib.contextmanager
def trainer_probes(cell, block, nw, tr, device_eval, ck):
    """Wraps the port's Trainer for phase 8 and yields the list of its
    records, one dict per training epoch, validation, human baseline and
    checkpoint write: the launch counts of each (zeroed at its start,
    read at its end), the epoch's stats (``Trainer.epoch_stats``), its
    peak memory, the NW calls of an SCST epoch (their inputs and outputs
    cloned), a torch.profiler window over the epoch's last PROFILE_STEPS
    steps (device busy and span), the wall times of each validation and
    of the device sweep inside it, and each checkpoint write's ms and
    file sizes.  The seed duration head's last conv is scaled by 0.01
    for every task, as _train_model does for phase 7: COCO's seed
    LogNormal scale overflows float32 in the SCST sampler (ROADMAP C7),
    and from OSIE's seed head the SCST epochs can drive sigma2 = exp(t)
    to float32 zero, where the reference's duration log-density is
    NaN."""
    from torch.profiler import ProfilerActivity, profile
    records = []
    real = {name: getattr(tr.Trainer, name) for name in
            ("train_epoch", "_maybe_profile", "validation_device",
             "human_baseline")}
    real_init, real_step = tr.init_weights, ck.CheckpointManager.step
    real_add = device_eval.DeviceSweep.add_batch
    real_add_air = device_eval.DeviceSweep.add_batch_air
    sweep = [0.0]
    window = {}

    def init_weights(model, seed):
        real_init(model, seed)
        with torch.no_grad():
            model.head.drt_layer_2.weight.mul_(0.01)

    def train_epoch(self, iteration, epoch):
        rl = epoch >= self.args.start_rl_epoch
        loader = self.train_rl_loader if rl else self.train_loader
        window.update(first=iteration, n=len(loader), stamps=[], prof=None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before, calls = _launches(cell, block, nw), []
        with (_timed_calls(nw, "nw_scores_bins", calls, keep_args=True)
              if rl else contextlib.nullcontext()):
            out = real["train_epoch"](self, iteration, epoch)
        stamps = window["stamps"]
        free = len(stamps) - PROFILE_STEPS    # the steps before the window
        # the trace is read after the epoch, outside its timing
        _, streams = _device_events(window["done"])
        busy = _union_ms([iv for ivs in streams.values() for iv in ivs])
        records.append(dict(
            kind="epoch", rl=rl, stats=dict(self.epoch_stats),
            launches=_minus(_launches(cell, block, nw), before),
            peak=torch.cuda.max_memory_allocated(), nw_calls=calls,
            busy=busy, span=window["span"],
            free_rate=(free - 1) / (stamps[free - 1] - stamps[0])
            if free > 1 else float("nan")))
        return out

    def maybe_profile(self, iteration):
        k = iteration - window["first"]         # 1-based step of the epoch
        window["stamps"].append(time.perf_counter())
        if k == max(window["n"] - PROFILE_STEPS, 1) and \
                window["prof"] is None:
            torch.cuda.synchronize()
            window["prof"] = profile(activities=[ProfilerActivity.CUDA])
            window["prof"].start()
            window["start"] = torch.cuda.Event(enable_timing=True)
            window["start"].record()
        if k == window["n"] and window["prof"] is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            torch.cuda.synchronize()
            window["prof"].stop()
            window["span"] = window["start"].elapsed_time(end)
            window["done"], window["prof"] = window["prof"], None

    def timed(real_fn):
        def add(*a):
            t = time.perf_counter()
            real_fn(*a)
            sweep[0] += time.perf_counter() - t
        return add

    def validation_device(self, iteration):
        torch.cuda.synchronize()
        before, sweep[0], t0 = (_launches(cell, block, nw), 0.0,
                                time.perf_counter())
        out = real["validation_device"](self, iteration)
        torch.cuda.synchronize()
        records.append(dict(kind="validation", wall=time.perf_counter() - t0,
                            sweep=sweep[0],
                            launches=_minus(_launches(cell, block, nw),
                                            before)))
        return out

    def human_baseline(self):
        before, t0 = _launches(cell, block, nw), time.perf_counter()
        out = real["human_baseline"](self)
        records.append(dict(kind="human", wall=time.perf_counter() - t0,
                            launches=_minus(_launches(cell, block, nw),
                                            before)))
        return out

    def checkpoint_step(self, metric, model_state, opt_state=None):
        torch.cuda.synchronize()
        best = self.get_best_metric()
        t0 = time.perf_counter()
        real_step(self, metric, model_state, opt_state)
        ms = 1e3 * (time.perf_counter() - t0)
        wrote_best = not best or (metric >= best)
        records.append(dict(
            kind="checkpoint", ms=ms, mb=os.path.getsize(self.path) / 1e6,
            best_mb=os.path.getsize(self.best_path) / 1e6
            if wrote_best else None))
    with mock.patch.object(tr.Trainer, "train_epoch", train_epoch), \
            mock.patch.object(tr.Trainer, "_maybe_profile", maybe_profile), \
            mock.patch.object(tr.Trainer, "validation_device",
                              validation_device), \
            mock.patch.object(tr.Trainer, "human_baseline", human_baseline), \
            mock.patch.object(tr, "init_weights", init_weights), \
            mock.patch.object(ck.CheckpointManager, "step", checkpoint_step), \
            mock.patch.object(device_eval.DeviceSweep, "add_batch",
                              timed(real_add)), \
            mock.patch.object(device_eval.DeviceSweep, "add_batch_air",
                              timed(real_add_air)):
        yield records


def _run_dir(log_root):
    runs = [d for d in os.listdir(log_root)
            if d.startswith("log_") and not d.endswith("_supervised_save")]
    if len(runs) != 1:
        raise AssertionError(f"{log_root}: run dirs {runs}")
    return os.path.join(log_root, runs[0])


def _scalars(log_dir):
    """{tag: {step: [values]}} of a run's scalars.jsonl."""
    out = {}
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            out.setdefault(r["tag"], {}).setdefault(r["step"], []).append(
                r["value"])
    return out


def check_run(task, log_dir):
    """A training run's artifacts (tests/test_e2e.py::test_artifact_contract
    with .pth for .msgpack) and its scalars: every value finite, but for a
    validation's MultiMatch columns, which are NaN when every rollout has
    fewer than 3 fixations (as _check_tree allows).  Returns the record
    and the scalars."""
    for name in ("hparams.json", "log_train.txt", "history_record.json",
                 "scalars.jsonl", "checkpoints/checkpoint.pth",
                 "checkpoints/checkpoint_best.pth"):
        if not os.path.exists(os.path.join(log_dir, name)):
            raise AssertionError(f"{task} run: no {name}")
    if not os.path.exists(os.path.join(log_dir + "_supervised_save",
                                       "checkpoints", "checkpoint.pth")):
        raise AssertionError(f"{task} run: no supervised_save copy")
    with open(os.path.join(log_dir, "history_record.json")) as f:
        record = json.load(f)
    scalars = _scalars(log_dir)
    bad = {(tag, step): v for tag, steps in scalars.items()
           for step, vals in steps.items() for v in vals
           if not math.isfinite(v)
           and not (tag.startswith("metrics/") and "MultiMatch" in tag
                    and math.isnan(v))}
    if bad:
        raise AssertionError(f"{task} run: non-finite scalars {bad}")
    # the SCST step's own tags: AiR's group rewards, the others' reward
    # and overflow (and OSIE's 11 metrics_for_reward/* columns)
    rl_tags = {"air": ("reward_same_hmean", "reward_diff_hmean"),
               "osie": ("reward_overflow_frac", "metrics_for_reward/vector",
                        "metrics_for_reward/STDE best"),
               "coco": ("reward_overflow_frac", "reward_wd")}[task]
    for tag in ("loss/loss", "learning_rate", "current metric",
                "perf/steps_per_sec", "perf/images_per_sec", "rl_loss",
                "metrics/wd_overflow_frac") + rl_tags:
        if tag not in scalars:
            raise AssertionError(f"{task} run: no {tag} scalar")
    return record, scalars


def print_trainer_records(task, label, records, rollouts, nw):
    """One line per epoch, validation, human baseline and checkpoint
    write of a run; holds each SCST NW call to the plain NW exactly.
    Returns the NW calls checked."""
    checked = 0
    for rec in records:
        n = rec["launches"] if "launches" in rec else None
        if rec["kind"] == "epoch":
            st = rec["stats"]
            phase = "SCST" if rec["rl"] else "supervised"
            rate, free = st["steps_per_sec"], rec["free_rate"]
            per = st["images_per_step"]
            wait = st["input_wait_seconds"]
            busy, span = rec["busy"], rec["span"]
            print(f"[trainer] {task} {label} epoch {st['epoch']} ({phase}, "
                  f"{per} images a step"
                  + (f" x {rollouts} rollouts" if rec["rl"] else "")
                  + f"): {st['steps']} steps in {st['seconds']:.2f} s; "
                  f"{free:.3f} steps/s, {free * per:.2f} images/s over "
                  f"steps 2-{st['steps'] - PROFILE_STEPS} (the trainer's "
                  f"own steady rate, the profiled steps included: {rate:.3f}"
                  f" steps/s, {rate * per:.2f} images/s); waited "
                  f"{wait:.3f} s for host batches "
                  f"({100 * wait / st['seconds']:.2f}% of the epoch); "
                  f"device idle "
                  f"{100 * (1 - busy / span):.1f}% over the last "
                  f"{PROFILE_STEPS} steps (torch.profiler: busy "
                  f"{busy:.1f} ms of {span:.1f} ms); peak allocated "
                  f"{_mib(rec['peak']):.0f} MiB; launches {n}", flush=True)
            for i, (_, _, a, out) in enumerate(rec["nw_calls"]):
                _exact(f"{task} {label} SCST NW call {i + 1}", out,
                       nw.nw_scores_bins_plain(*a))
            checked += len(rec["nw_calls"])
        elif rec["kind"] == "validation":
            print(f"[trainer] {task} {label} validation (device sweep): "
                  f"{rec['wall']:.2f} s wall, device sweep {rec['sweep']:.2f}"
                  f" s ({100 * rec['sweep'] / rec['wall']:.1f}%); launches "
                  f"{n}", flush=True)
        elif rec["kind"] == "human":
            print(f"[trainer] {task} {label} human baseline (device): "
                  f"{rec['wall']:.2f} s wall; launches {n}", flush=True)
        else:
            best = (f", checkpoint_best.pth {rec['best_mb']:.1f} MB"
                    if rec["best_mb"] is not None else
                    ", checkpoint_best.pth not rewritten")
            print(f"[trainer] {task} {label} checkpoint write: "
                  f"{rec['ms']:.1f} ms (checkpoint.pth {rec['mb']:.1f} MB"
                  f"{best})", flush=True)
    return checked


def check_trainer_launches(task, label, records, n_streams, repeats,
                           val_forwards, rl_steps, apply_cd):
    """No cell or stage launch in a training step; 16 cell and 3 stage
    launches per validation forward; NW: 2 per SCST step and stream (2
    more per step for AiR's CD term), 2 per human-baseline batch, 2 per
    sweep batch, repeat and stream."""
    for i, rec in enumerate(records):
        where = f"{task} {label} {rec['kind']} {i}"
        if rec["kind"] == "epoch":
            nw_want = (2 * n_streams + 2 * apply_cd) * rec["stats"]["steps"] \
                if rec["rl"] else 0
            if rec["rl"] and rec["stats"]["steps"] != rl_steps:
                raise AssertionError(f"{where}: {rec['stats']['steps']} "
                                     f"SCST steps, expected {rl_steps}")
            _expect(where, rec["launches"], {"cell_step": 0, "stage_apply": 0,
                                             "nw_scores_bins": nw_want})
        elif rec["kind"] == "validation":
            _expect(where, rec["launches"], {
                "cell_step": SEQ * val_forwards,
                "stage_apply": 3 * val_forwards,
                "nw_scores_bins": 2 * repeats * val_forwards * n_streams})
        elif rec["kind"] == "human":
            _expect(where, rec["launches"], {
                "cell_step": 0, "stage_apply": 0,
                "nw_scores_bins": 2 * val_forwards})


def run_trainer_slice(cell, block, nw, argv):
    """Phase 8 for one task: cli/train.py at full width on the card (one
    supervised epoch, then one SCST epoch, each followed by a validation
    with the device sweep), its artifacts, scalars and launch counts,
    every NW call of its SCST steps against the plain NW, then
    cli/test.py on the run (it must read the run's own
    checkpoint_best.pth), and for OSIE a resumed third epoch (the record's
    iteration, Adam's step count and the lr scalar go on).  Returns the
    kernels' launches of the phase."""
    import shutil

    from scanpaths_tpu_torch.cli import test as test_cli
    from scanpaths_tpu_torch.cli import train as train_cli
    from scanpaths_tpu_torch.metrics import device_eval
    from scanpaths_tpu_torch.serve import predictor
    from scanpaths_tpu_torch.train import trainer as tr
    from scanpaths_tpu_torch.train.schedule import lr_multiplier
    from scanpaths_tpu_torch.utils import checkpointing as ck
    task = argv[argv.index("--task") + 1]
    streams = 2 if task == "air" else 1
    args = _train_args(argv)
    sup_steps = TRAINER_IMAGES * TEST_SUBJECTS[task] // args.batch
    rl_steps = TRAINER_IMAGES // max(args.batch // 4, 1)
    val_forwards = -(-VALIDATION_IMAGES // args.batch)
    log_root = argv[argv.index("--log_root") + 1]
    total = dict.fromkeys(("cell_step", "stage_apply", "nw_scores_bins"), 0)

    def run(label, run_argv):
        t0 = time.perf_counter()
        with trainer_probes(cell, block, nw, tr, device_eval, ck) as recs, \
                contextlib.redirect_stdout(io.StringIO()):
            before = _launches(cell, block, nw)
            best = train_cli.main(run_argv)
            got = _minus(_launches(cell, block, nw), before)
        secs = time.perf_counter() - t0
        for k in total:
            total[k] += got[k]
        check_trainer_launches(task, label, recs, streams,
                               args.eval_repeat_num, val_forwards, rl_steps,
                               args.apply_consistency_divergence)
        checked = print_trainer_records(task, label, recs,
                                        args.rl_sample_number, nw)
        epochs = [r for r in recs if r["kind"] == "epoch"]
        print(f"[trainer] {task} {label}: {len(epochs)} epoch(s) in "
              f"{secs:.1f} s wall (the whole cli/train.py call: data, model, "
              f"human baseline, epochs, validations, checkpoints); best "
              f"metric {best:.4f}; launches {got}; {checked} SCST NW calls "
              f"held to the plain NW exactly (max abs err 0, NaN in the "
              f"same places)", flush=True)
        return recs

    recs = run("run", argv)
    if [r["stats"]["steps"] for r in recs if r["kind"] == "epoch"] != \
            [sup_steps, rl_steps]:
        raise AssertionError(f"{task}: epochs of {recs} steps")
    log_dir = _run_dir(log_root)
    record, scalars = check_run(task, log_dir)
    if (record["epoch"], record["iteration"]) != \
            (1, sup_steps + rl_steps - 1):
        raise AssertionError(f"{task} record {record}")

    # the test driver on the run's own checkpoint_best.pth
    opened = []
    real_path = predictor.checkpoint_path

    def checkpoint_path(evaluation_dir):
        opened.append(real_path(evaluation_dir))
        return opened[-1]
    test_argv = [a for a in argv] + ["--evaluation_dir", log_dir]
    before = _launches(cell, block, nw)
    t0 = time.perf_counter()
    with mock.patch.object(predictor, "checkpoint_path", checkpoint_path), \
            contextlib.redirect_stdout(io.StringIO()):
        metrics = test_cli.main(test_argv)
    torch.cuda.synchronize()
    got = _minus(_launches(cell, block, nw), before)
    for k in total:
        total[k] += got[k]
    want_path = os.path.join(log_dir, "checkpoints", "checkpoint_best.pth")
    if opened != [want_path]:
        raise AssertionError(f"{task} test driver read {opened}, expected "
                             f"{want_path}")
    _check_tree(metrics)
    _expect(f"{task} test on the run", got, {
        "cell_step": SEQ * val_forwards, "stage_apply": 3 * val_forwards,
        "nw_scores_bins": 2 * val_forwards
        + 2 * REPEATS * val_forwards * streams})
    out = "validation" if task == "coco" else "test"
    with open(os.path.join(log_dir, f"{out}_predicts.json")) as f:
        n_records = len(json.load(f))
    if n_records != VALIDATION_IMAGES * REPEATS * streams:
        raise AssertionError(f"{task} test on the run: {n_records} records")
    print(f"[trainer] {task} cli/test.py --evaluation_dir <the run>: read "
          f"its checkpoint_best.pth, {n_records} records, "
          f"{time.perf_counter() - t0:.2f} s wall, launches {got}",
          flush=True)

    if task == "osie":
        # resume: a third epoch (SCST) from the record and checkpoint.pth
        step0 = tr.adam_step(ck.restore_checkpoint(
            os.path.join(log_dir, "checkpoints"))["optimizer"])
        if step0 != record["iteration"] + 1:
            raise AssertionError(f"checkpoint at Adam step {step0}, record "
                                 f"{record}")
        resume_argv = argv + ["--resume_dir", log_dir, "--epoch", "3"]
        run("resume", resume_argv)
        record2, scalars2 = check_run(task, log_dir)
        step1 = tr.adam_step(ck.restore_checkpoint(
            os.path.join(log_dir, "checkpoints"))["optimizer"])
        want = (2, record["iteration"] + rl_steps)
        if (record2["epoch"], record2["iteration"]) != want or \
                step1 != step0 + rl_steps:
            raise AssertionError(f"resume: record {record2}, Adam step "
                                 f"{step1}, expected {want} and "
                                 f"{step0 + rl_steps}")
        rargs = _train_args(resume_argv)
        lr = scalars2["learning_rate"]
        if sorted(lr) != list(range(record2["iteration"] + 1)):
            raise AssertionError(f"resume: lr scalars at {sorted(lr)}")
        for it, vals in lr.items():
            want = rargs.lr * lr_multiplier(
                it, sup_steps, rl_steps, rargs.warmup_epoch,
                rargs.start_rl_epoch, rargs.epoch if it > record["iteration"]
                else args.epoch, rargs.rl_lr_initial_decay)
            if vals != [want]:
                raise AssertionError(f"resume: lr at {it} {vals}, "
                                     f"expected {want}")
        first = record["iteration"] + 1
        old_lr = args.lr * lr_multiplier(
            first, sup_steps, rl_steps, args.warmup_epoch,
            args.start_rl_epoch, args.epoch, args.rl_lr_initial_decay)
        print(f"[trainer] osie resume --epoch 3: went on from iteration "
              f"{record['iteration']} and Adam step {step0} to iteration "
              f"{record2['iteration']} and step {step1}; every learning_rate "
              f"scalar (the lr the optimizer applied) written once, equal "
              f"to lr * lr_multiplier of its run's schedule; first resumed "
              f"step at lr {lr[first][0]} (the --epoch 2 schedule gave "
              f"{old_lr})", flush=True)
    shutil.rmtree(os.path.dirname(log_root))
    torch.cuda.empty_cache()
    return total


JOINT_IMAGES = 16        # train and validation images a task
# the joint data root's dirs per task: images, fixations, maps
JOINT_LAYOUT = {"osie": ("stimuli", "fixations", None),
                "air": ("stimuli", "fixations", "attention"),
                "coco": ("images", "fixations", "detectors")}


def _joint_dirs(root, task):
    return [os.path.join(root, task, d) if d else None
            for d in JOINT_LAYOUT[task]]


def write_joint_root(tmp):
    """Phase 9's data from seed 0: a joint data root in
    tools/make_synth_data.py's layout, for each task JOINT_IMAGES train
    and JOINT_IMAGES validation images at phase 3's frames and subject
    counts (OSIE's and AiR's validation records also form their test
    split).  Returns the train CLI's flags (full width, --batch 16,
    --eval_repeat_num 10, one supervised and one SCST epoch, the device
    sweep)."""
    rng = np.random.default_rng(0)
    root = os.path.join(tmp, "joint")
    for task in TASKS:
        img_dir, fix_dir, att_dir = _joint_dirs(root, task)
        for d in (img_dir, fix_dir, att_dir):
            if d:
                os.makedirs(d)
        train, dets = _write_records(task, rng, img_dir, att_dir,
                                     JOINT_IMAGES)
        val, val_dets = _write_records(task, rng, img_dir, att_dir,
                                       JOINT_IMAGES, first=JOINT_IMAGES)
        splits = {"train": train, "validation": val}
        if task != "coco":
            splits["test"] = val
        for split, recs in splits.items():
            with open(os.path.join(fix_dir, _split_file(task, split)),
                      "w") as f:
                json.dump(recs, f)
        if task == "coco":
            with open(os.path.join(att_dir, "coco_search18_detector.json"),
                      "w") as f:
                json.dump(dets + val_dets, f)
    return ["--task", "joint", "--joint_data_root", root,
            "--log_root", os.path.join(root, "logs"),
            "--batch", str(TEST_BATCH), "--eval_repeat_num", str(REPEATS),
            "--seed", "0", "--epoch", "2", "--start_rl_epoch", "1",
            "--warmup_epoch", "1", "--device_eval", "true",
            "--device", "cuda"]


def joint_head_flags(root, task):
    """cli/test.py's data flags for one task of the joint data root."""
    img_dir, fix_dir, att_dir = _joint_dirs(root, task)
    maps = {"air": ["--att_dir", att_dir],
            "coco": ["--detector_dir", att_dir]}
    return ["--task", task, "--img_dir", img_dir, "--fix_dir",
            fix_dir] + maps.get(task, [])


@contextlib.contextmanager
def joint_probes(cell, block, nw, jt, steps, device_eval, ck):
    """Wraps the port's JointTrainer for phase 9 and yields (records, the
    trainer): one record per training step, epoch, task validation, task
    human baseline and checkpoint write.  A step record holds its task,
    kind, launch counts, its wall to the end of its device work, its span
    between CUDA events, its peak memory and its NW calls (SCST; inputs
    and outputs cloned); for each task's last PROFILE_STEPS steps of an
    epoch, a torch.profiler window of its own (CUDA activity; one trace
    over several SCST steps, ~12 thousand kernels each, lost records on
    the card), read after the epoch for the step's device busy time.  An epoch record holds
    the trainer's epoch_stats; a validation record its wall, the device
    sweep's share and launches.  Every head's duration conv is scaled by
    0.01, as phase 8 scales the single-task head (trainer_probes)."""
    from torch.profiler import ProfilerActivity, profile
    records, trainer = [], {}
    real_init, real_fit = jt.init_weights, jt.JointTrainer.fit
    real_epoch = jt.JointTrainer.train_epoch
    real_steps = {"sup": steps.supervised_step, "rl": steps.rl_step}
    real_eval = jt.TaskContext.evaluate
    real_human = jt.TaskContext.human_metrics
    real_ckpt = ck.CheckpointManager.step
    real_add = device_eval.DeviceSweep.add_batch
    real_add_air = device_eval.DeviceSweep.add_batch_air
    sweep = [0.0]
    epoch = {}

    def init_weights(model, seed):
        real_init(model, seed)
        with torch.no_grad():
            for task in TASKS:
                model.task_head(task).head.drt_layer_2.weight.mul_(0.01)

    def fit(self):
        trainer["trainer"] = self
        return real_fit(self)

    def train_epoch(self, iteration, ep):
        rl = ep >= self.args.start_rl_epoch
        epoch.update(seen=dict.fromkeys(TASKS, 0), n={
            t: len(c.train_rl_loader if rl else c.train_loader)
            for t, c in self.tasks.items()})
        out = real_epoch(self, iteration, ep)
        # the traces are read after the epoch, outside its timing
        for rec in records:
            prof = rec.pop("prof", None)
            if prof is not None:
                _, streams = _device_events(prof)
                rec["busy"] = _union_ms([iv for ivs in streams.values()
                                         for iv in ivs])
        records.append(dict(kind="epoch", rl=rl, epoch=ep,
                            stats={t: dict(s) for t, s in
                                   self.epoch_stats.items()}))
        return out

    def step_probe(kind):
        real = real_steps[kind]

        def step(state, *a, **kw):
            task = state.model.task
            epoch["seen"][task] += 1
            profiled = epoch["seen"][task] > epoch["n"][task] - PROFILE_STEPS
            before, calls, prof = _launches(cell, block, nw), [], None
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if profiled:
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.start()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            with (_timed_calls(nw, "nw_scores_bins", calls, keep_args=True)
                  if kind == "rl" else contextlib.nullcontext()):
                out = real(state, *a, **kw)
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rec = dict(kind="step", task=task, rl=kind == "rl",
                       launches=_minus(_launches(cell, block, nw), before),
                       wall=wall, span=start.elapsed_time(end),
                       peak=torch.cuda.max_memory_allocated(),
                       nw_calls=calls, profiled=profiled)
            if prof is not None:
                prof.stop()
                rec["prof"] = prof
            records.append(rec)
            return out
        return step

    def timed(real_fn):
        def add(*a):
            t = time.perf_counter()
            real_fn(*a)
            sweep[0] += time.perf_counter() - t
        return add

    def evaluate(self, loader, device_eval_, iteration=0, record=None):
        torch.cuda.synchronize()
        before, sweep[0], t0 = (_launches(cell, block, nw), 0.0,
                                time.perf_counter())
        out = real_eval(self, loader, device_eval_, iteration, record)
        torch.cuda.synchronize()
        records.append(dict(kind="validation", task=self.task,
                            wall=time.perf_counter() - t0, sweep=sweep[0],
                            forwards=len(loader),
                            launches=_minus(_launches(cell, block, nw),
                                            before)))
        return out

    def human_metrics(self, loader, device_eval_):
        before, t0 = _launches(cell, block, nw), time.perf_counter()
        out = real_human(self, loader, device_eval_)
        torch.cuda.synchronize()
        records.append(dict(kind="human", task=self.task, forwards=len(loader),
                            wall=time.perf_counter() - t0,
                            launches=_minus(_launches(cell, block, nw),
                                            before)))
        return out

    def checkpoint_step(self, metric, model_state, opt_state=None):
        torch.cuda.synchronize()
        best = self.get_best_metric()
        t0 = time.perf_counter()
        real_ckpt(self, metric, model_state, opt_state)
        ms = 1e3 * (time.perf_counter() - t0)
        wrote_best = not best or (metric >= best)
        records.append(dict(
            kind="checkpoint", ms=ms, mb=os.path.getsize(self.path) / 1e6,
            best_mb=os.path.getsize(self.best_path) / 1e6
            if wrote_best else None))
    with mock.patch.object(jt, "init_weights", init_weights), \
            mock.patch.object(jt.JointTrainer, "fit", fit), \
            mock.patch.object(jt.JointTrainer, "train_epoch", train_epoch), \
            mock.patch.object(steps, "supervised_step", step_probe("sup")), \
            mock.patch.object(steps, "rl_step", step_probe("rl")), \
            mock.patch.object(jt.TaskContext, "evaluate", evaluate), \
            mock.patch.object(jt.TaskContext, "human_metrics",
                              human_metrics), \
            mock.patch.object(ck.CheckpointManager, "step", checkpoint_step), \
            mock.patch.object(device_eval.DeviceSweep, "add_batch",
                              timed(real_add)), \
            mock.patch.object(device_eval.DeviceSweep, "add_batch_air",
                              timed(real_add_air)):
        yield records, trainer


def check_joint_run(log_dir, order, tasks):
    """The joint run's artifacts, its record, its scalars (every one
    finite, but a validation's MultiMatch columns, which may be NaN as in
    phase 6; each task's tags, learning_rate and current metric), the
    round-robin step order read from the scalars' steps against
    ``order`` (the expected (task, SCST) of each iteration), and each
    validation's current metric against the harmonic mean of the three
    per-task ScanMatch harmonic means recomputed from the logged
    scalars.  Returns the record."""
    for name in ("hparams.json", "log_train.txt", "history_record.json",
                 "scalars.jsonl", "checkpoints/checkpoint.pth",
                 "checkpoints/checkpoint_best.pth"):
        if not os.path.exists(os.path.join(log_dir, name)):
            raise AssertionError(f"joint run: no {name}")
    if not os.path.exists(os.path.join(log_dir + "_supervised_save",
                                       "checkpoints", "checkpoint.pth")):
        raise AssertionError("joint run: no supervised_save copy")
    with open(os.path.join(log_dir, "hparams.json")) as f:
        if json.load(f)["task"] != "joint":
            raise AssertionError("joint run: hparams.json is not joint's")
    with open(os.path.join(log_dir, "history_record.json")) as f:
        record = json.load(f)
    if (record["epoch"], record["iteration"]) != (1, len(order) - 1):
        raise AssertionError(f"joint record {record}, expected epoch 1 and "
                             f"iteration {len(order) - 1}")
    scalars = _scalars(log_dir)
    bad = {(tag, step): v for tag, steps in scalars.items()
           for step, vals in steps.items() for v in vals
           if not math.isfinite(v)
           and not ("/metrics/" in tag and "MultiMatch" in tag
                    and math.isnan(v))}
    if bad:
        raise AssertionError(f"joint run: non-finite scalars {bad}")
    need = ["learning_rate", "current metric"]
    for t in tasks:
        group = "all-" if t == "air" else ""
        need += [f"{t}/loss/loss", f"{t}/rl_loss",
                 f"{t}/metrics/{group}ScanMatch-w/o duration",
                 f"{t}/metrics/wd_overflow_frac"]
    for tag in need:
        if tag not in scalars:
            raise AssertionError(f"joint run: no {tag} scalar")
    got = []
    for it in range(len(order)):
        got += [(t, rl) for t in tasks for rl, tag in
                ((False, f"{t}/loss/loss"), (True, f"{t}/rl_loss"))
                if it in scalars[tag]]
    if got != order:
        raise AssertionError(f"joint step order {got}, expected {order}")

    def hmean(vals):
        return len(vals) / sum(1.0 / v for v in vals)
    for step, (value,) in scalars["current metric"].items():
        per_task = []
        for t in tasks:
            groups = ("right_answer-", "wrong_answer-") if t == "air" \
                else ("",)
            per_task.append(hmean([
                scalars[f"{t}/metrics/{g}ScanMatch-{col}"][step][0]
                for g in groups for col in ("w/o duration",
                                            "with duration")]))
        if not math.isclose(value, hmean(per_task), rel_tol=1e-9):
            raise AssertionError(f"joint current metric {value} at {step}, "
                                 f"recomputed {hmean(per_task)}")
    return record, scalars


def check_joint_records(records, nw, repeats):
    """The launch counts of the phase's training steps (no cell or stage
    launch; NW 2 per SCST step and stream), validations (16 cell and 3
    stage launches per forward, NW 2 per sweep batch, repeat and stream)
    and human baselines (NW 2 per batch), and every NW call of the SCST
    steps against the plain NW exactly.  Returns the NW calls checked."""
    checked = 0
    for i, rec in enumerate(records):
        where = f"joint {rec['kind']} {i} ({rec.get('task')})"
        streams = 2 if rec.get("task") == "air" else 1
        if rec["kind"] == "step":
            _expect(where, rec["launches"], {
                "cell_step": 0, "stage_apply": 0,
                "nw_scores_bins": 2 * streams if rec["rl"] else 0})
            for j, (_, _, a, out) in enumerate(rec["nw_calls"]):
                _exact(f"{where} SCST NW call {j + 1}", out,
                       nw.nw_scores_bins_plain(*a))
            checked += len(rec["nw_calls"])
        elif rec["kind"] == "validation":
            fw = rec["forwards"]
            _expect(where, rec["launches"], {
                "cell_step": SEQ * fw, "stage_apply": 3 * fw,
                "nw_scores_bins": 2 * repeats * fw * streams})
        elif rec["kind"] == "human":
            _expect(where, rec["launches"], {
                "cell_step": 0, "stage_apply": 0,
                "nw_scores_bins": 2 * rec["forwards"]})
    return checked


def print_joint_records(records, rollouts):
    """Per epoch and task: steps, the steady images/s (steps 2 to the
    last unprofiled one, each step timed to the end of its device work),
    the trainer's own rate, the wait for host batches, the device's idle
    share over the task's last PROFILE_STEPS steps, the peak memory and
    each step's wall;
    per validation and task its wall and the sweep's share; per human
    baseline and checkpoint write its wall (and MB)."""
    steps_by = {}
    for rec in records:
        if rec["kind"] == "step":
            steps_by.setdefault((rec["rl"], rec["task"]), []).append(rec)
        elif rec["kind"] == "epoch":
            phase = "SCST" if rec["rl"] else "supervised"
            for task, st in rec["stats"].items():
                srecs = steps_by.pop((rec["rl"], task))
                # the steady rate leaves out the first step, and the
                # profiled ones where two or more others remain
                free = [r for r in srecs[1:] if not r["profiled"]]
                which = "unprofiled"
                if len(free) < 2:
                    free, which = srecs[1:], "the profiled ones included"
                prof = [r for r in srecs if r["profiled"]]
                per = st["images_per_step"]
                rate = len(free) / sum(r["wall"] for r in free)
                busy = sum(r["busy"] for r in prof)
                span = sum(r["span"] for r in prof)
                own = st["steps"] / st["seconds"] if st["seconds"] else 0.0
                print(f"[joint] epoch {rec['epoch']} ({phase}) {task}: "
                      f"{st['steps']} steps of {per} images"
                      + (f" x {rollouts} rollouts" if rec["rl"] else "")
                      + f"; {rate:.3f} steps/s, {rate * per:.2f} images/s "
                      f"over {len(free)} of its steps from the second "
                      f"({which}; the trainer's own rate over all "
                      f"its steps, the profiled ones included: {own:.3f} "
                      f"steps/s); waited {st['input_wait_seconds']:.3f} s "
                      f"for host batches; device idle "
                      f"{100 * (1 - busy / span):.1f}% over its last "
                      f"{len(prof)} steps (torch.profiler: busy {busy:.1f} "
                      f"ms of {span:.1f} ms); peak allocated in its steps "
                      f"{_mib(max(r['peak'] for r in srecs)):.0f} MiB; "
                      f"step walls (ms, * profiled) "
                      + " ".join(f"{1e3 * r['wall']:.0f}"
                                 + "*" * r["profiled"] for r in srecs),
                      flush=True)
        elif rec["kind"] == "validation":
            print(f"[joint] validation (device sweep) {rec['task']}: "
                  f"{rec['wall']:.2f} s wall, device sweep "
                  f"{rec['sweep']:.2f} s "
                  f"({100 * rec['sweep'] / rec['wall']:.1f}%); launches "
                  f"{rec['launches']}", flush=True)
        elif rec["kind"] == "human":
            print(f"[joint] human baseline (device) {rec['task']}: "
                  f"{rec['wall']:.2f} s wall; launches {rec['launches']}",
                  flush=True)
        elif rec["kind"] == "checkpoint":
            best = (f", checkpoint_best.pth {rec['best_mb']:.1f} MB"
                    if rec["best_mb"] is not None else
                    ", checkpoint_best.pth not rewritten")
            print(f"[joint] checkpoint write: {rec['ms']:.1f} ms "
                  f"(checkpoint.pth {rec['mb']:.1f} MB{best})", flush=True)


def check_joint_model(cell, block, trainer):
    """One trunk: the joint model holds a trunk and its three heads none;
    then one eval forward of the trained model on the first AiR
    validation batch, every cell call (S = 2) and stage call held to its
    plain version on the same inputs (phase 4's float32 tolerance): the
    kernels read the weights the training steps changed in place."""
    model = trainer.model
    names = [n for n, _ in model.named_parameters()]
    if any(model.task_head(t).backbone is not None for t in TASKS) or \
            any("backbone" in n.split(".", 1)[1] for n in names
                if not n.startswith("backbone.")):
        raise AssertionError("a joint head holds a trunk")
    count = {p: sum(v.numel() for n, v in model.named_parameters()
                    if n.startswith(p + "."))
             for p in ("backbone",) + TASKS}
    errs = {"cell_step": [], "stage_apply": []}
    streams = []
    cell_k, stage_k = cell.cell_step, block.stage_apply

    def checked_cell(h, c, *a):
        streams.append(a[1].shape[-1])
        c_p = c.clone()
        h_k, c_k = cell_k(h, c, *a)
        h_p, c_p = cell.cell_step_plain(h, c_p, *a)
        errs["cell_step"].append(max(
            _close("joint cell after training", h_k, h_p, F32_TOL,
                   scaled=True),
            _close("joint cell after training", c_k, c_p, F32_TOL,
                   scaled=True)))
        return h_k, c_k

    def checked_stage(x, dil, *w):
        y_k = stage_k(x, dil, *w)
        errs["stage_apply"].append(_close(
            "joint stage after training", y_k,
            block.stage_apply_plain(x, dil, *w), F32_TOL, scaled=True))
        return y_k
    ctx = trainer.tasks["air"]
    batch = next(iter(ctx.validation_loader))
    with mock.patch.object(cell, "cell_step", checked_cell), \
            mock.patch.object(block, "stage_apply", checked_stage):
        ctx.forward(batch)
    torch.cuda.synchronize()
    if len(errs["cell_step"]) != SEQ or len(errs["stage_apply"]) != 3 or \
            set(streams) != {2}:
        raise AssertionError(f"joint forward after training: "
                             f"{len(errs['cell_step'])} cell calls (streams "
                             f"{set(streams)}), {len(errs['stage_apply'])} "
                             "stage calls")
    print(f"[joint] one trunk: {sum(count.values())} parameters, trunk "
          f"{count['backbone']}, heads "
          + ", ".join(f"{t} {count[t]}" for t in TASKS)
          + "; no head holds a trunk.  The trained model's AiR eval forward,"
          " each kernel call against its plain version on the same inputs: "
          + ", ".join(f"{k} {len(v)} calls, max abs err {max(v):.3g}"
                      for k, v in errs.items()), flush=True)


def run_joint_slice(cell, block, nw, tmp):
    """Phase 9: cli/train.py --task joint at full width on the card (one
    supervised and one SCST epoch round-robin over the three tasks, each
    followed by a validation of every head with the device sweep), its
    artifacts, scalars, step order and launch counts, every NW call of
    its SCST steps against the plain NW, one trunk and the trained
    kernels against their plain versions, then cli/test.py on each head
    of the run and cli/predict.py on its COCO head.  Returns the
    kernels' launches of the phase."""
    import shutil

    from scanpaths_tpu_torch.cli import predict
    from scanpaths_tpu_torch.cli import test as test_cli
    from scanpaths_tpu_torch.cli import train as train_cli
    from scanpaths_tpu_torch.metrics import device_eval
    from scanpaths_tpu_torch.serve import predictor
    from scanpaths_tpu_torch.train import joint as jt
    from scanpaths_tpu_torch.train import steps
    from scanpaths_tpu_torch.utils import checkpointing as ck
    argv = write_joint_root(tmp)
    root = argv[argv.index("--joint_data_root") + 1]
    log_root = argv[argv.index("--log_root") + 1]
    args = _train_args(argv)
    t0 = time.perf_counter()
    with joint_probes(cell, block, nw, jt, steps, device_eval, ck) as (
            records, held), contextlib.redirect_stdout(io.StringIO()):
        before = _launches(cell, block, nw)
        best = train_cli.main(argv)
        total = _minus(_launches(cell, block, nw), before)
    secs = time.perf_counter() - t0
    trainer = held.pop("trainer")
    checked = check_joint_records(records, nw, args.eval_repeat_num)
    print_joint_records(records, args.rl_sample_number)
    n = {rl: {t: len(c.train_rl_loader if rl else c.train_loader)
              for t, c in trainer.tasks.items()} for rl in (False, True)}
    order = [(t, rl) for rl in (False, True)
             for t, _ in jt.round_robin({t: range(k)
                                         for t, k in n[rl].items()})]
    log_dir = trainer.log_dir
    check_joint_run(log_dir, order, TASKS)
    print(f"[joint] cli/train.py --task joint: {len(order)} steps "
          f"round-robin (supervised {n[False]}, SCST {n[True]}) in the "
          f"order the scalars show; {secs:.1f} s wall (data, model, human "
          f"baselines, epochs, validations, checkpoints); best joint metric "
          f"{best:.4f} (the harmonic mean of the per-task ScanMatch "
          f"harmonic means, recomputed from the scalars); launches {total}; "
          f"{checked} SCST NW calls held to the plain NW exactly",
          flush=True)
    check_joint_model(cell, block, trainer)
    del trainer
    torch.cuda.empty_cache()

    # the test driver on each head of the run
    opened = []
    real_path = predictor.checkpoint_path

    def checkpoint_path(evaluation_dir):
        opened.append(real_path(evaluation_dir))
        return opened[-1]
    want_path = os.path.join(log_dir, "checkpoints", "checkpoint_best.pth")
    fw = -(-JOINT_IMAGES // args.batch)
    for task in TASKS:
        streams = 2 if task == "air" else 1
        before, t0 = _launches(cell, block, nw), time.perf_counter()
        with mock.patch.object(predictor, "checkpoint_path",
                               checkpoint_path), \
                contextlib.redirect_stdout(io.StringIO()):
            metrics = test_cli.main(joint_head_flags(root, task) + [
                "--evaluation_dir", log_dir, "--batch", str(args.batch),
                "--eval_repeat_num", str(REPEATS), "--seed", "0",
                "--device_eval", "true", "--device", "cuda"])
        torch.cuda.synchronize()
        got = _minus(_launches(cell, block, nw), before)
        if opened[-1:] != [want_path]:
            raise AssertionError(f"{task} test on the joint run read "
                                 f"{opened}, expected {want_path}")
        _check_tree(metrics)
        _expect(f"{task} test on the joint run", got, {
            "cell_step": SEQ * fw, "stage_apply": 3 * fw,
            "nw_scores_bins": 2 * fw + 2 * REPEATS * fw * streams})
        out = "validation" if task == "coco" else "test"
        with open(os.path.join(log_dir, f"{out}_predicts.json")) as f:
            n_records = len(json.load(f))
        if n_records != JOINT_IMAGES * REPEATS * streams:
            raise AssertionError(f"{task} test on the joint run: "
                                 f"{n_records} records")
        for k in total:
            total[k] += got[k]
        print(f"[joint] cli/test.py --task {task} --evaluation_dir <the "
              f"joint run>: read its checkpoint_best.pth, {n_records} "
              f"records, {time.perf_counter() - t0:.2f} s wall, launches "
              f"{got}", flush=True)

    # serving the run's COCO head
    img_dir = serving_images(tmp)
    cell.cell_launches = block.block_launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(predictor, "checkpoint_path", checkpoint_path), \
            capture_durations() as calls:
        records = predict.main([
            "--task", "coco", "--predict_images", img_dir,
            "--evaluation_dir", log_dir, "--batch", str(BATCH),
            "--decode", "sample", "--num_samples", "10", "--seed", "0",
            "--device", "cuda", "--predict_out",
            os.path.join(tmp, "joint_coco.json")]
            + serving_inputs(tmp, "coco"))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    forwards = -(-IMAGES // BATCH)
    if opened[-1:] != [want_path]:
        raise AssertionError(f"predict on the joint run read {opened[-1:]}")
    inf = overflowed_durations(
        calls, [min(BATCH, IMAGES - lo) for lo in range(0, IMAGES, BATCH)],
        "coco", True)
    _check_records(records, IMAGES, 10, 320, 240, overflow=inf)
    got = {"cell_step": cell.cell_launches, "stage_apply": block.block_launches}
    _expect("predict on the joint run", got, {
        "cell_step": SEQ * forwards, "stage_apply": 3 * forwards})
    for k in got:
        total[k] += got[k]
    print(f"[joint] cli/predict.py --task coco --evaluation_dir <the joint "
          f"run>: {len(records)} records from {IMAGES} images with targets "
          f"{SERVE_TARGETS}, {secs:.2f} s wall, launches {got}; {inf} "
          "sampled durations overflow float32", flush=True)
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return total


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

    launches = {"cell_step": 0, "stage_apply": 0, "nw_scores_bins": 0}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        test_argv = {task: write_test_split(tmp, task) for task in TASKS}
        firsts = {task: _first_batch(argv) for task, argv in test_argv.items()}
        _phase("data", t0)

        t0 = time.perf_counter()
        summary = check_kernels(cell, block)
        summary["nw_scores_bins"] = check_nw(nw, tm, firsts)
        _phase("kernels", t0)

        for task in TASKS:
            t0 = time.perf_counter()
            add(run_slice(cell, block, predict, tmp, task))
            compare_forward(cell, block, predictor, task)
            _phase(f"serving slice {task}", t0)

        for task in TASKS:
            t0 = time.perf_counter()
            add(run_test_slice(cell, block, nw, test_cli, device_eval, heval,
                               test_argv[task], *firsts[task]))
            _phase(f"test slice {task}", t0)

        check_grad_refusal(cell, block)
        for task in TASKS:
            t0 = time.perf_counter()
            counts, per_step, sup_batch = run_train_slice(cell, block, nw,
                                                          test_argv[task])
            add(counts)
            summary["nw_scores_bins"][f"{task}_ms_per_rl_step"] = per_step
            if task == "osie":
                check_train_parity(test_argv[task], sup_batch)
            _phase(f"training {task}", t0)

        for task in TASKS:
            t0 = time.perf_counter()
            add(run_trainer_slice(cell, block, nw,
                                  write_trainer_split(tmp, task)))
            _phase(f"trainer {task}", t0)

        t0 = time.perf_counter()
        add(run_joint_slice(cell, block, nw, tmp))
        _phase("joint trainer", t0)

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
