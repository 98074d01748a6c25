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
   gate conv alone; the head kernel (csrc/head.cu) against its plain
   version in float64, in float32 and bfloat16, for one stream, AiR's two
   heads and COCO's per-sample fields, with its time, the plain
   version's and cuDNN's two convs alone (library_ms) at N = 16 and N = 1;
   the compose kernel (csrc/compose.cu) against its plain version in
   float64 at COCO's bank (K = 18), OSIE's conditioner (K = 1) and AiR's
   two (K = 2), with its time, the plain version's, cuBLAS's product of
   the bank with the head's 51 columns alone (library_ms) and a stock-op
   composition of two matmuls at K = 18 and K = 1;
5. serving slice, for each task: serves 12 images through
   scanpaths_tpu_torch.cli.predict at full width (ResNet-50, embed 512,
   240x320, T=16, batch 8, weights from a seed), greedy and sampled,
   float32 and bfloat16 (AiR with seeded attention maps, COCO with three
   target categories, so three bank heads share a batch); checks the
   records (every value finite, but for COCO's sampled durations whose
   exponent, recomputed in float64 from the sampler's mu, sigma2 and
   normal draw, lies past float32's range; so in phase 6) and that
   every forward launched the cell kernel 16 times
   (with two signal streams for AiR, one otherwise), the stage
   kernel 3 times and the head kernel 16 times a stream; then runs one
   forward through the kernels and
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
   Checks that the cell, stage and head wrappers refuse a gradient on the
   card, every loss and metric finite, the launch
   counts (no cell or stage launch; 2 NW launches per SCST step and
   stream), every NW call of the SCST steps against the plain NW
   exactly, and one OSIE supervised step at batch 2 on the card against
   the same step on the CPU (loss and gradient norm, rtol 1e-3).  Prints
   the step times, images/s, the reward grids' share of the SCST step
   and the NW time inside it, NW ms a call at the reward's shapes, and
   the peak memory allocated per phase.  For OSIE also: two supervised
   steps from step 2 from one state with float32 and with bfloat16 Adam
   first moments (--bf16_moments): the first loss equal, every stored
   first moment bfloat16, the parameters within 5% of the largest update
   and two float32 ulps (BF16_MOMENT_GAP), both peaks printed; and three SCST and three
   supervised steps with an async checkpoint write of the state in
   flight against none (the ms step() blocked, the write's ms, the
   steps' ms);
8. the trainer, for each task: writes a train split of 8 images and a
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
   batches, the device's idle share over the epoch's last 2 steps
   (torch.profiler) and the peak memory; per validation its wall and the
   sweep's share; per checkpoint write its ms and MB.  OSIE's and COCO's
   runs write their checkpoints on the writer thread (--ckpt_backend
   orbax; AiR's synchronously): per write the ms step() blocked and the
   ms and MB of each file written on the thread, and after the run the
   final checkpoint.pth and checkpoint_best.pth equal to a synchronous
   write of the same states; OSIE's resume reads the async-written
   checkpoint.pth;
9. the joint trainer: writes a joint data root in
   tools/make_synth_data.py's layout (8 train and 8 validation images
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
   last 2 steps and the peak memory; per validation and task its wall
   and the sweep's share; per checkpoint write its ms and MB;
10. the serving export: scanpaths_tpu_torch.cli.export writes, as
   processes started together, the float32 greedy bundle at batch 8 of
   every task from phase 3's seed checkpoint, each with --export_check
   (the reloaded bundle equal to the live serving module), for OSIE also
   a sampled (10 samples), a bfloat16 and a symbolic-batch bundle, and
   the COCO head of phase 9's run.  This process loads each bundle as
   its export ends (serve.load_bundle) and serves phase 5's 12 images
   through cli.predict --bundle: phase 5's record checks, 16 cell
   launches (cell ops with S = 2 for AiR) and 3 stage launches per
   bundle call, the float32 and bfloat16 records equal to phase 5's live
   ones exactly; the sampled bundle: one seed twice gives equal outputs,
   equal to the live serving module's on that seed, another seed others;
   the symbolic bundle at batch 1 and 8 (batch 8 equal to the batch-8
   bundle, batch 1 to the live predictor exactly; through the CLI its
   first chunk equal to the live records); the symbolic float32 bundle,
   exported on the card, loaded on the CPU and equal to the live CPU
   predictor on 2 images exactly.  Prints per bundle the export seconds,
   its MB and its load seconds, and the bundle's ms per call against the
   live forward+decode at batch 8 in float32 and bfloat16, each call of
   both also profiled (device busy and idle share);
11. the mesh over ranks, as torchrun launches it (this script re-entered
   under ``python -m torch.distributed.run --standalone`` as each rank's
   program, two calls: one rank on the card over NCCL, and two ranks
   sharing it over gloo, NCCL refusing two ranks on one device): (a) the
   one rank and the two take the same steps from the same weights, for
   OSIE and AiR at full width in float32: 2 supervised steps at global
   batch 16 and 2 SCST steps at global batch 4 with 5 rollouts (each
   rank its rows; the rollout noise drawn for the global batch from one
   generator seed), from optimizer step 2 with Adam's second moments
   preset (a first Adam step from zero moments is lr times the sign of
   the gradient, which rounding flips); checks every metric of every
   step (rtol 1e-5; the gradient norm 1e-3 at the first step and 1e-1
   after it, see DP_GRAD_NORM_RTOL), the parameters and BN running
   statistics after the first step (rtol 1e-4, atol 1e-6; after the
   last, reported), no cell or stage launch and 2 NW launches a SCST
   step and stream on each rank, each held to the plain NW exactly;
   prints every gap, the step ms of both sides, the gradient
   all-reduce's ms inside a step (two ranks sharing one card: no scaling
   number) and OSIE's world-1 supervised step beside phase 7's
   single-process one; (a') OSIE's steps under
   torch.use_deterministic_algorithms (CUBLAS_WORKSPACE_CONFIG=:4096:8),
   twice from the same state in the world-1 process and once on the two
   ranks: prints the gaps and the ops without a deterministic
   implementation; the two ranks' first gradient norm within 1e-3 of
   world 1's; (d) the same steps on a 1 x 2 mesh (--model_parallel 2,
   the sliced state of train/tp_step.py) at (a)'s bars, then an eval
   forward of the seed weights on the first batch with the sliced
   kernels gathered whole, within F32_TOL of world 1's, 16 cell and 3
   stage launches on each rank, each call held to its plain version;
   (c) cli/test.py --device_eval true over the two ranks on phase 8's
   OSIE and AiR runs against phase 8's single-process cli/test.py on the
   same runs and seed: at least 99% of rollouts' actions equal, every
   metric and std within rtol 1e-3, each rank's launches its rows';
   (b) cli/train.py's main under torchrun on two ranks sharing the card
   with phase 8's OSIE split and flags and --mesh_size 0: the artifacts
   written once, by rank 0, the record and every lr scalar equal to phase
   8's, the supervised losses against phase 8's single process (the
   first step's within rtol 1e-5, every step's within 1e-1, see
   DP_RUN_DRIFT_RTOL), each rank's validation launches (both validate
   their rows: 16 cell and 3 stage a forward), every SCST NW call exact
   on both ranks; prints the SCST scalars beside phase 8's (not
   asserted); (b) runs with phase 8's OSIE flags, so rank 0 writes its
   checkpoints on the writer thread;
12. the measuring tools (scanpaths_tpu_torch/tools/, in this process, at
   full width): bench_steps' nw (the kernel against its plain version,
   max abs err 0), sup and rl sections, bench_serving live at batches 1
   and 8 and on phase 10's float32 greedy OSIE bundle, profile_bench at
   batch 8 in bfloat16 and float32, and bench_train sup 16 with and
   without --bf16_moments; each JSON line printed and finite, every MFU
   under 1.0, each kernel launched;
13. the entry points and tools II (scanpaths_tpu_torch/entry.py and
   tools/, full width unless named): (a) entry()'s fn(state, images),
   once warm and once timed with CUDA events, its output shapes, finite
   values and 16 cell and 3 stage launches a call, then at input scale
   COMPARE_SCALE each kernel call against its plain version and the
   outputs against the plain forward (F32_TOL); (b)
   dryrun_multichip(2), two torchrun ranks sharing the card over gloo:
   its step lines, 2 NW launches a rank (the SCST step), the world-1
   step on rank 0 after the process group closes; (c)
   tools.dist_smoke, two torchrun nodes of two ranks sharing the card,
   ranks 2 and 3 on LOCAL_RANK 0 and 1 and cuda:0, their losses and
   gradient norms against one process's (dist_smoke.RTOL);
   (d) tools.real_data_smoke --task osie on a synthesized OSIE release
   (800x600 stimuli, a fixations.mat) with a reference-layout
   checkpoint_best.pth of seed weights: 2 steps, --device_eval true,
   exit 0, the checkpoint loaded, predict_schema_ok, the loss and the
   validation metric finite; (e) tools.profile_scan at batch 8 in
   float32 and bfloat16, in a process of its own: each variant finite,
   every loop's trace passing the tool's check (its busy shares
   printed), 16 cell launches a decode loop;
14. prints the kernels' JSON line (phase 11's and 13's workers'
   launches added), then {"ok": true, "device": ...} as the last line.

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
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from scanpaths_tpu_torch.utils import tracing

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


def head_work(n, h, w, c, dtype):
    """(operations, bytes) of the composed conditioner+head of one
    stream: the 5x5 C->2 conv, the 11x11 stride-5 C->1 conv and its
    border corrections, over h and the float32 fields in, the stop logit,
    the action map and the duration map out (float32)."""
    h5, w5 = (h - 5) // 5 + 1, (w - 5) // 5 + 1
    flops = 2 * c * (n * h * w * 25 * 2 + n * h5 * w5 * 121
                     + n * (2 * 11 * w5 + 11 * 2 * h5 + 4))
    nbytes = dtype.itemsize * n * h * w * c \
        + 4 * ((50 + 121 + 22 + 22 + 4) * c + 2 + h5 * w5 + 1) \
        + 4 * n * (1 + h * w + h5 * w5)
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


def _head_inputs(n, h, w, c, dtype, gen, per_sample=False):
    """h [n, h, w, c] in ``dtype`` and the float32 fields of a composed
    conditioner+head from weights at their init's scale (one bank entry
    a sample with ``per_sample``, COCO's)."""
    from scanpaths_tpu_torch.models import components, prepared
    dev = "cuda"

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std
    raw = {"w2": (rnd(1, 1, c, 1, std=c ** -0.5), rnd(1, std=0.1)),
           "w3": (rnd(1, 1, c, 1, std=c ** -0.5), rnd(1, std=0.1)),
           "kd": (rnd(7, 7, c, 1, std=(49 * c) ** -0.5), rnd(1, std=0.1))}
    if per_sample:
        bank = (rnd(3, 5, 5, c, c, std=(25 * c) ** -0.5),
                rnd(3, c, std=0.1))
        fused = prepared.fuse_bank_heads(
            *bank, torch.arange(n, device=dev) % 3, raw, h, w)
    else:
        fused = components.fuse_cond_head(
            rnd(5, 5, c, c, std=(25 * c) ** -0.5), rnd(c, std=0.1), raw, h,
            w)
    return rnd(n, h, w, c, std=0.5).to(dtype), fused


def _head_library(h, fused):
    """cuDNN's two convs of the plain composition alone (the 5x5 C->2 and
    the 11x11 stride-5 C->1 over h, channels-last), as the plain version
    calls them: the yardstick the kernel replaced."""
    import torch.nn.functional as F
    x = h.permute(0, 3, 1, 2)
    k_sa = fused["k_sa"].to(h.dtype).permute(3, 2, 0, 1)
    keff = fused["keff"].to(h.dtype).permute(3, 2, 0, 1)
    return (F.conv2d(x, k_sa, padding=2),
            F.conv2d(F.pad(x, (4, 2, 4, 2)), keff, stride=5))


def check_head(head, gen, sms):
    """The head kernel against its plain version in float64 on the
    kernel's own inputs (bfloat16 h widened exactly, so both dtypes take
    F32_TOL, scaled to the output), for one stream, AiR's second head on
    the same h and COCO's per-sample fields, at the main shape at N = 16
    and N = 1 and at edge ones; at the main shapes also its time, the
    plain version's, cuDNN's two convs alone (``library_ms``) and the
    bound, each from CUDA events around back-to-back calls (at N = 1 the
    host's submission rate bounds the kernel's), and the kernel's device
    time under torch.profiler (``device_ms``: its two kernels a call).
    Returns the summary (N = 16 unprefixed, N = 1 under "n1_", bfloat16
    under "bf16_")."""
    from torch.profiler import ProfilerActivity, profile
    summary = {}
    cases = [("main N=16", (16, 30, 40, 512)), ("main N=1", (1, 30, 40, 512)),
             ("ragged", (3, 10, 12, 32)), ("two column tiles", (2, 12, 47, 16)),
             ("one window", (2, 5, 6, 16))]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        pre = "" if dtype == torch.float32 else "bf16_"
        for label, shape in cases:
            errs = []
            for kind, per_sample, streams in (("S=1", False, 1),
                                              ("AiR", False, 2),
                                              ("COCO", True, 1)):
                h, fused = _head_inputs(*shape, dtype, gen, per_sample)
                for s in range(streams):
                    if s:
                        fused = _head_inputs(*shape, dtype, gen)[1]
                    got = head.cond_head(h, fused)
                    want = head.cond_head_plain(
                        h.double(), {k: v.double() for k, v in fused.items()})
                    torch.cuda.synchronize()
                    errs += [_close(f"head {label} {kind} stream {s} {dname} "
                                    f"{name}", a, b, F32_TOL, scaled=True)
                             for name, a, b in zip(("stop", "amap", "d"),
                                                   got, want)]
            err = max(errs)
            line = (f"[kernels] head {label} {shape} {dname} (S=1, AiR's two "
                    f"heads, COCO's per-sample fields): max abs err against "
                    f"float64 {err:.3g}")
            if label.startswith("main"):
                h, fused = _head_inputs(*shape, dtype, gen)
                iters = 50 if shape[0] == 1 else 20
                ms, plain_ms = _pair_ms(lambda: head.cond_head(h, fused),
                                        lambda: head.cond_head_plain(h, fused),
                                        iters, 5)
                library_ms, _ = _pair_ms(lambda: _head_library(h, fused),
                                         lambda: _head_library(h, fused), 5)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(iters):
                        head.cond_head(h, fused)
                    torch.cuda.synchronize()
                device_ms = sum(
                    v for k, v in _device_events(prof)[0].items()
                    if "head_part" in k or "head_finish" in k) / iters
                flops, nbytes = head_work(*shape, dtype)
                bound_ms, bound_by = _bound(flops, nbytes, PEAK_FLOPS[dtype])
                blocks, per_sm, _ = head.head_plan(*shape)
                line += (f"; {ms:.4f} ms (device {device_ms:.4f} ms; plain "
                         f"{plain_ms:.4f} ms, cuDNN's two convs alone "
                         f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by "
                         f"{bound_by}; device {_rate(flops, device_ms, bound_ms)}"
                         f"); {blocks} blocks, {per_sm} per SM, "
                         f"{blocks / (sms * per_sm):.2f} waves")
                sp = pre + ("" if shape[0] == 16 else "n1_")
                summary.update({
                    sp + "max_abs_err": err, sp + "ms": ms,
                    sp + "device_ms": device_ms, sp + "plain_ms": plain_ms,
                    sp + "library_ms": library_ms, sp + "bound_ms": bound_ms,
                    sp + "bound_by": bound_by})
            print(line, flush=True)
    return summary


def compose_work(k, c, mh, mw):
    """(operations, bytes) of composing K conditioner entries [5, 5, C, C]
    with the head: the products of each entry with the head's 51 columns
    (kd's 49 taps, w2, w3), a multiply-add two operations, over the
    entries' kernels and biases and the head's weights in and the fields
    out (219 C + 3 + h5 w5 a entry), float32."""
    h5, w5 = (mh - 3) // 5 + 1, (mw - 3) // 5 + 1
    flops = 2 * k * 25 * c * c * 51
    nbytes = 4 * (k * (25 * c * c + c) + 51 * c + 3
                  + k * (219 * c + 3 + h5 * w5))
    return flops, nbytes


def _compose_library(bank, w):
    """cuBLAS's float32 product of the bank [K, 5, 5, C, C] (contiguous)
    with the head's 51 columns ``w`` [C, 51]: the bulk of the compose
    kernel's operations in one library call (TF32 off), its yardstick."""
    return torch.matmul(bank.view(-1, bank.shape[-1]), w)


def _stock_columns(raw):
    """The head's 51 columns [C, 51]: kd's 49 taps, w2, w3."""
    c = raw["kd"][0].shape[2]
    return torch.cat([raw["kd"][0][..., 0].reshape(49, c),
                      raw["w2"][0][0, 0, :, 0][None],
                      raw["w3"][0][0, 0, :, 0][None]]).t()


def _stock_fold(mh, mw, device):
    """The constant 0/1 matrices of the stock-op composition: ``fold``
    [25 * 51, 219] takes a channel's 25 x 51 products T[a, b, i, n] to its
    219 outputs (k_sa's 50, keff's 121, wr's 22, wc's 22, wcc's 4, as
    csrc/compose.cu's header gives them), ``count`` [49, h5 * w5] sums
    kd . b1 over each drt window's taps inside the map."""
    fold = torch.zeros(25, 51, 219, dtype=torch.float32)
    for a in range(5):
        for b in range(5):
            fold[5 * a + b, 49, 2 * (5 * a + b)] = 1
            fold[5 * a + b, 50, 2 * (5 * a + b) + 1] = 1
            for p in range(7):
                for q in range(7):
                    fold[5 * a + b, 7 * p + q, 50 + 11 * (a + p) + b + q] = 1
    for d in range(5):
        for t in range(7):
            fold[20 + d, t, 171 + d + t] += 1
            fold[15 + d, 7 + t, 171 + d + t] += 1
            fold[20 + d, 7 + t, 182 + d + t] += 1
            fold[5 * d + 4, 7 * t, 193 + 2 * (d + t)] += 1
            fold[5 * d + 3, 7 * t + 1, 193 + 2 * (d + t)] += 1
            fold[5 * d + 4, 7 * t + 1, 194 + 2 * (d + t)] += 1
    for y in range(2):
        for x in range(2):
            for j in range(y, 2):
                for k in range(x, 2):
                    fold[5 * (y + 4 - j) + x + 4 - k, 7 * j + k,
                         215 + 2 * y + x] += 1
    h5, w5 = (mh - 3) // 5 + 1, (mw - 3) // 5 + 1
    rows = [[[0 <= 5 * o - 2 + p < n for p in range(7)] for o in range(m)]
            for n, m in ((mh, h5), (mw, w5))]
    count = torch.tensor([[float(rows[0][i][p] and rows[1][j][q])
                           for i in range(h5) for j in range(w5)]
                          for p in range(7) for q in range(7)])
    return fold.view(25 * 51, 219).to(device), count.to(device)


def _compose_stock(bank, bias, raw, fold, count, h5, w5):
    """The composition in stock ops, the design the kernel was weighed
    against: T = bank . [kd | w2 | w3] as one float32 matmul, the
    channels' products regrouped, one matmul with ``fold`` to every
    field, the biases by two more; contiguous fields, as the kernel's."""
    k, c = bank.shape[0], bank.shape[-1]
    w = _stock_columns(raw)
    t = torch.matmul(bank.view(-1, c), w).view(k, 25, c, 51)
    f = torch.matmul(t.transpose(1, 2).reshape(k * c, 25 * 51),
                     fold).view(k, c, 219)

    def field(lo, hi, *shape, dim=-1):
        return f[..., lo:hi].reshape(k, c, *shape).movedim(1, dim) \
            .contiguous()
    bb = torch.matmul(bias, w)
    return {"k_sa": field(0, 50, 5, 5, 2, dim=-2),
            "b_sa": bb[:, 49:] + torch.cat([raw["w2"][1], raw["w3"][1]]),
            "keff": field(50, 171, 11, 11)[..., None],
            "wr": field(171, 193, 2, 11), "wc": field(193, 215, 11, 2),
            "wcc": field(215, 219, 2, 2),
            "b1map": torch.matmul(bb[:, :49], count).view(k, h5, w5),
            "bd": raw["kd"][1].repeat(k)}


def check_compose(gen, sms):
    """The compose kernel against its plain version in float64 at C = 512
    and a 30x40 map: COCO's bank (K = 18, contiguous HWIO entries), OSIE's
    conditioner (K = 1) and AiR's two (K = 2), the latter as the HWIO
    views of OIHW conv weights, as the model holds them.  At K = 18 and
    K = 1 also its time, the plain version's, cuBLAS's float32 product of
    the bank with the head's 51 columns alone (``library_ms``, the bulk of
    the work in one library call), the stock-op composition of two
    matmuls (:func:`_compose_stock`, checked against float64 too) and the
    bound, from CUDA events around back-to-back calls, and the device time
    and kernels a call of the kernel, the library call and the stock
    composition under torch.profiler.  Returns the summary (K = 18
    unprefixed, K = 1 under "k1_")."""
    from torch.profiler import ProfilerActivity, profile

    from scanpaths_tpu_torch.ops import compose
    c, mh, mw = 512, 30, 40
    h5, w5 = (mh - 3) // 5 + 1, (mw - 3) // 5 + 1

    def rnd(*shape, std):
        return torch.randn(shape, generator=gen, device="cuda") * std

    def hwio(w):
        return w.permute(2, 3, 1, 0)

    def device(fn, iters):
        """(device ms, kernels) a call of fn under the profiler."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = _device_events(prof)[0]
        n = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
        return sum(times.values()) / iters, n / iters
    raw = {"w2": (hwio(rnd(1, c, 1, 1, std=c ** -0.5)), rnd(1, std=0.1)),
           "w3": (hwio(rnd(1, c, 1, 1, std=c ** -0.5)), rnd(1, std=0.1)),
           "kd": (hwio(rnd(1, c, 7, 7, std=(49 * c) ** -0.5)),
                  rnd(1, std=0.1))}
    raw64 = {k: (a.double(), b.double()) for k, (a, b) in raw.items()}
    fold, count = _stock_fold(mh, mw, "cuda")
    columns = _stock_columns(raw)
    summary = {}
    for k, layout in ((18, "bank"), (1, "conv"), (2, "conv")):
        if layout == "bank":
            ks = list(rnd(k, 5, 5, c, c, std=(25 * c) ** -0.5))
            bs = list(rnd(k, c, std=0.3))
        else:
            ks = [hwio(rnd(c, c, 5, 5, std=(25 * c) ** -0.5))
                  for _ in range(k)]
            bs = [rnd(c, std=0.3) for _ in range(k)]
        before = tracing.counter("cond_compose.launches")
        got = compose.cond_compose(ks, bs, raw, mh, mw)
        torch.cuda.synchronize()
        if tracing.counter("cond_compose.launches") != before + 1:
            raise AssertionError(f"compose K={k}: not one launch")
        want = compose.compose_bank_heads([t.double() for t in ks],
                                          [t.double() for t in bs], raw64,
                                          mh, mw)
        err = max(_close(f"compose K={k} {name}", got[name], want[name],
                         F32_TOL, scaled=True) for name in compose.FIELDS)
        line = (f"[kernels] compose K={k} ({layout}), C={c}, {mh}x{mw}: "
                f"max abs err against float64 {err:.3g}")
        if k != 2:
            iters = 20 if k > 1 else 50
            # the stock design reads the entries as one contiguous stack
            bank = torch.stack([t.contiguous() for t in ks])
            bias = torch.stack(bs)
            stock = _compose_stock(bank, bias, raw, fold, count, h5, w5)
            stock_err = max(
                _close(f"stock compose K={k} {name}", stock[name],
                       want[name], F32_TOL, scaled=True)
                for name in compose.FIELDS)

            def kernel_fn():
                return compose.cond_compose(ks, bs, raw, mh, mw)

            def plain_fn():
                return compose.compose_bank_heads(ks, bs, raw, mh, mw)

            def library_fn():
                return _compose_library(bank, columns)

            def stock_fn():
                return _compose_stock(bank, bias, raw, fold, count, h5, w5)
            ms, plain_ms = _pair_ms(kernel_fn, plain_fn, iters, 3)
            stock_ms, library_ms = _pair_ms(stock_fn, library_fn, iters)
            device_ms, _ = device(kernel_fn, iters)
            library_device_ms, _ = device(library_fn, iters)
            stock_device_ms, stock_kernels = device(stock_fn, iters)
            del bank, bias, stock
            flops, nbytes = compose_work(k, c, mh, mw)
            bound_ms, bound_by = _bound(flops, nbytes,
                                        PEAK_FLOPS[torch.float32])
            blocks = ((c + 4) // 5 + 1) * k
            line += (f"; {ms:.4f} ms (device {device_ms:.4f} ms; plain "
                     f"{plain_ms:.4f} ms; cuBLAS's bank x 51 columns alone "
                     f"{library_ms:.4f} ms, device {library_device_ms:.4f}; "
                     f"stock two-matmul composition {stock_ms:.4f} ms, "
                     f"device {stock_device_ms:.4f}, {stock_kernels:.0f} "
                     f"kernels, max abs err {stock_err:.3g}; bound "
                     f"{bound_ms:.4f} ms by {bound_by}; device "
                     f"{_rate(flops, device_ms, bound_ms)}); {blocks} "
                     f"blocks, {blocks / sms:.2f} a SM")
            sp = "" if k == 18 else "k1_"
            summary.update({
                sp + "max_abs_err": err, sp + "ms": ms,
                sp + "device_ms": device_ms, sp + "plain_ms": plain_ms,
                sp + "library_ms": library_ms,
                sp + "library_device_ms": library_device_ms,
                sp + "stock_ms": stock_ms,
                sp + "stock_device_ms": stock_device_ms,
                sp + "stock_kernels": stock_kernels,
                sp + "stock_max_abs_err": stock_err,
                sp + "bound_ms": bound_ms, sp + "bound_by": bound_by})
        else:
            summary["k2_max_abs_err"] = err
        print(line, flush=True)
    return summary


def _rate(flops, ms, bound_ms):
    """TFLOP/s achieved and the share of the bound reached."""
    return f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of bound"


def _waves(label, grid, sms):
    """A launch's tiles and its waves over the card's SMs."""
    gx, gy, per_sm = grid
    tiles = gx * gy
    return (f"{label} {tiles} tiles ({gx} x {gy}), {per_sm} per SM, "
            f"{tiles / (sms * per_sm):.2f} waves")


def _schedule(rep):
    """The float32 cell kernel's persistent schedule (``cell.cell_grid``)."""
    return (f"schedule {rep['ctas']} CTAs ({rep['per_sm']} per SM of "
            f"{rep['sms']}), {rep['tiles']} tiles, {rep['split_tiles']} cut "
            f"along K, the largest CTA's work {rep['most']} of a mean "
            f"{rep['units'] / rep['ctas']:.2f} chunks "
            f"({rep['most'] * rep['ctas'] / rep['units']:.4f})")


def check_kernels(cell, block):
    """The cell, stage, head and compose kernels; returns {kernel:
    {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "bf16_..."}}
    at the main path's shapes (float32 keys unprefixed, bfloat16 ones
    prefixed; the cell's two-stream shape, AiR's, also prefixed "s2_"; the
    head's N = 1 "n1_", with cuDNN's convs as "library_ms",
    :func:`check_head`; the compose kernel's K = 1 "k1_",
    :func:`check_compose`)."""
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
    # float32 also at the benchmark's batch and at one image ("n16_",
    # "n1_"): the persistent schedule's two regimes
    f32_cases = [("n16", (16, 30, 40, 512, 1)), ("n1", (1, 30, 40, 512, 1))]
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        dname = str(dtype).split(".")[-1]
        pre = "" if dtype == torch.float32 else "bf16_"
        for label, shape in cell_cases + (
                f32_cases if dtype == torch.float32 else []):
            a = _cell_inputs(*shape, dtype, gen)
            c_k, c_p = a["c"].clone(), a["c"].clone()
            args = (a["xg"], a["smaps"], a["kps"], a["kh"])
            h_k, _ = cell.cell_step(a["h"], c_k, *args)
            h_p, _ = cell.cell_step_plain(a["h"], c_p, *args)
            torch.cuda.synchronize()
            err = max(_close(f"cell {label} {dname} h'", h_k, h_p, tol),
                      _close(f"cell {label} {dname} c'", c_k, c_p, tol))
            line = f"[kernels] cell {label} {shape} {dname}: max_abs_err {err:.3g}"
            if not label.startswith("ragged"):
                c_t = a["c"].clone()
                ms, plain_ms = _pair_ms(
                    lambda: cell.cell_step(a["h"], c_t, *args),
                    lambda: cell.cell_step_plain(a["h"], c_t, *args), 5)
                bound_ms, bound_by = cell_bound(*shape, dtype)
                n, h, w, c, _ = shape
                flops = 2 * n * h * w * 9 * c * 4 * c
                grid = cell.cell_grid(n, h, w, c, dtype)
                line += (f", {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
                         f"{bound_ms:.3f} ms by {bound_by}; gate conv "
                         f"{_rate(flops, ms, bound_ms)}); " + (
                             _schedule(grid) if dtype == torch.float32 else
                             _waves("grid", (*grid["grid"], grid["per_sm"]),
                                    sms)))
                # S=1 (OSIE, COCO) unprefixed, S=2 (AiR) under "s2_", the
                # float32 batches of 16 and 1 under "n16_", "n1_"
                sp = pre + {"main S=1": "", "main S=2": "s2_"}.get(
                    label, label + "_")
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
    from scanpaths_tpu_torch.ops import head
    summary["cond_head"] = check_head(head, gen, sms)
    summary["cond_compose"] = check_compose(gen, sms)
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


# the serving CLIs' model flags at full width (phases 5 and 10)
FULL_WIDTH = ["--embed", "512", "--backbone_layers", "3,4,6,3", "--height",
              "240", "--width", "320", "--map_height", "30", "--map_width",
              "40", "--max_length", str(SEQ)]


def run_slice(cell, block, predict, tmp, task):
    """The serving slice of one task; returns the launch counts of the
    served runs.  Each run's records stay in ``tmp`` as
    ``<task>_<decode>_<half>.json`` (phase 10 holds the bundles to
    them)."""
    img_dir = serving_images(tmp)
    common = ["--task", task, "--predict_images", img_dir,
              "--batch", str(BATCH), "--seed", "0", "--device", "cuda"] \
        + FULL_WIDTH + serving_inputs(tmp, task)
    runs = [("greedy", "false"), ("sample", "false"), ("greedy", "true"),
            ("sample", "true")]
    forwards = -(-IMAGES // BATCH)
    want_s = 2 if task == "air" else 1
    totals = {"cell_step": 0, "stage_apply": 0, "cond_head": 0,
              "cond_compose": 0}
    for decode, half in runs:
        step, streams = _counting_streams(cell)
        tracing.reset_counters("cell_step.launches", "stage_apply.launches",
                               "cond_head.launches", "cond_compose.launches")
        t0 = time.perf_counter()
        with mock.patch.object(cell, "cell_step", step), \
                capture_durations() as calls:
            records = predict.main(common + [
                "--decode", decode, "--num_samples", "10",
                "--half_precision", half,
                "--predict_out",
                os.path.join(tmp, f"{task}_{decode}_{half}.json")])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        dc = tracing.counter("cell_step.launches")
        db = tracing.counter("stage_apply.launches")
        dh = tracing.counter("cond_head.launches")
        dk = tracing.counter("cond_compose.launches")
        inf = overflowed_durations(
            calls, [min(BATCH, IMAGES - lo) for lo in range(0, IMAGES, BATCH)]
            if decode == "sample" else [], task, True)
        _check_records(records, IMAGES, 10 if decode == "sample" else 1,
                       320, 240, overflow=inf)
        if dc != SEQ * forwards or db != 3 * forwards or \
                dh != SEQ * forwards * want_s or dk != 1 or \
                set(streams) != {want_s}:
            raise AssertionError(
                f"{task} {decode} half={half}: {forwards} forwards launched "
                f"the cell kernel {dc} times (streams {sorted(set(streams))})"
                f", the stage kernel {db} times, the head kernel {dh} "
                f"times and the compose kernel {dk} times (expected "
                f"{SEQ * forwards} with S={want_s}, {3 * forwards}, "
                f"{SEQ * forwards * want_s} and 1, the run's one weight "
                "version)")
        totals["cell_step"] += dc
        totals["stage_apply"] += db
        totals["cond_head"] += dh
        totals["cond_compose"] += dk
        print(f"[slice] {task} predict --decode {decode} --half_precision "
              f"{half}: {len(records)} records from {IMAGES} images, "
              f"{forwards} forwards, cell launches {dc} (S={want_s}), stage "
              f"launches {db}, head launches {dh}, compose launches {dk}, "
              f"{secs:.2f} s wall (model build and image "
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

    from scanpaths_tpu_torch.ops import head

    def plain():
        return (mock.patch.object(cell, "cell_step", cell.cell_step_plain),
                mock.patch.object(block, "stage_apply",
                                  block.stage_apply_plain),
                mock.patch.object(head, "cond_head", head.cond_head_plain))

    for half, tol in (("false", F32_TOL), ("true", BF16_TOL)):
        args = parse_opt(["--task", task, "--seed", "0",
                          "--half_precision", half])
        pred = predictor_mod.Predictor(args, "cuda")
        errs = {"cell_step": [], "stage_apply": [], "cond_head": []}
        streams = []
        # float32 only: the kernel's and the plain version's errors against
        # the plain version in float64 on the same inputs, per call
        f64_errs = {"kernel": [], "plain": []}
        cell_k, stage_k, head_k = (cell.cell_step, block.stage_apply,
                                   head.cond_head)

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

        def checked_head(h, fused):
            got = head_k(h, fused)
            errs["cond_head"].append(max(
                _close("head in forward", a, b, tol, scaled=True)
                for a, b in zip(got, head.cond_head_plain(h, fused))))
            return got

        with mock.patch.object(cell, "cell_step", checked_cell), \
                mock.patch.object(block, "stage_apply", checked_stage), \
                mock.patch.object(head, "cond_head", checked_head):
            pred.forward(images, maps, tids)
        torch.cuda.synchronize()
        n_streams = 2 if task == "air" else 1
        if len(errs["cell_step"]) != SEQ or len(errs["stage_apply"]) != 3 \
                or len(errs["cond_head"]) != SEQ * n_streams:
            raise AssertionError(f"{task} forward: {len(errs['cell_step'])} "
                                 f"cell, {len(errs['stage_apply'])} stage "
                                 f"and {len(errs['cond_head'])} head calls")
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
            p1, p2, p3 = plain()
            with p1, p2, p3:
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
            + 2 * REPEATS * forwards * streams,
            "cond_head": SEQ * forwards * streams, "cond_compose": 1}
    totals = dict.fromkeys(want, 0)
    real_add = device_eval.DeviceSweep.add_batch
    real_add_air = device_eval.DeviceSweep.add_batch_air
    from scanpaths_tpu_torch.train import trainer as tr
    real_human = tr.human_evaluation_device
    for half in ("false", "true"):
        captured, sweep_secs = [], [0.0]

        def timed(real):
            def add(self, *a, **kw):
                # the first batch's first two repeats of each stream
                if len([c for c in captured if c[6:] == list(a[6:])]) < 2:
                    captured.append([x.detach().clone()
                                     if torch.is_tensor(x) else x
                                     for x in a])
                t = time.perf_counter()
                real(self, *a, **kw)
                sweep_secs[0] += time.perf_counter() - t
            return add

        def human(*a, **kw):
            t = time.perf_counter()
            out = real_human(*a, **kw)
            sweep_secs[0] += time.perf_counter() - t
            return out

        tracing.reset_counters()
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
        got = tracing.launches()
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
    """The cell, stage and head kernels define no backward: on the card,
    under grad mode, each wrapper raises for any input that requires
    grad, before it launches anything."""
    from scanpaths_tpu_torch.ops import head
    gen = torch.Generator(device="cuda").manual_seed(2)
    h, fused = _head_inputs(1, 10, 12, 32, torch.float32, gen)
    cases = (("cell_step", cell.cell_step,
              _cell_inputs(1, 4, 5, 64, 1, torch.float32, gen)),
             ("stage_apply", lambda **kw: block.stage_apply(dil=1, **kw),
              _stage_inputs(1, 4, 5, 64, 32, 1, torch.float32, gen)),
             ("cond_head", lambda h, **kw: head.cond_head(h, kw),
              dict(fused, h=h)))
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
    print("[train] cell_step, stage_apply and cond_head raise on the card "
          "under grad mode for each input that requires grad", flush=True)


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
    the first supervised batch, the steady supervised step's ms)."""
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

    tracing.reset_counters()
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
    got = tracing.launches()
    want = {"cell_step": 0, "stage_apply": 0,
            "nw_scores_bins": TRAIN_STEPS * streams * 2
            + (TRAIN_STEPS * 2 if rl_cfg.apply_cd else 0), "cond_head": 0,
            "cond_compose": 0}
    if got != want:
        raise AssertionError(f"{task} training: launches {got}, expected "
                             f"{want}")
    if task == "osie":
        with tempfile.TemporaryDirectory() as tmp:
            measure_write_overlap(
                state, db, [steps.device_batch(b, "cuda", for_rl=True)
                            for b in rl_batches], rl_cfg, gen,
                args.lambda_1, tmp)
    # where a step's time goes (each after one more warm step)
    profile_call(lambda: steps.supervised_step(state, db, args.lambda_1),
                 f"{task} supervised step, batch {args.batch}, float32")
    rdb = steps.device_batch(rl_batches[-1], "cuda", for_rl=True)
    profile_call(lambda: steps.rl_step(state, rdb, rl_cfg, generator=gen),
                 f"{task} SCST step, batch {max(args.batch // 4, 1)}, "
                 "float32")
    del state
    torch.cuda.empty_cache()
    if task == "osie":
        check_bf16_moments(args, db, len(sup_loader), len(rl_loader))

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
    return got, per_step, sup_batch, steady


# phase 7's bfloat16-moment check: the second moments preset (the update
# then smooth in the gradient), and the parameter gap the two runs may
# show: a share of the largest update of the float32 run, plus two
# float32 ulps of the parameter.  The rounded moment itself moves a
# second-step update by under 0.2% of the largest; the second step's
# gradient also differs between the runs (the first updates round to
# the parameters' last bits apart, and cuDNN's backward is not
# deterministic), which moved one parameter by 1.4% of the largest
# update on an H100.  An update that ignored or misscaled the stored
# moment would move the second step by tens of percent.
BF16_MOMENT_NU = 1e-4
BF16_MOMENT_GAP = 5e-2
F32_ULP = 2.0 ** -23


def _to_host(obj):
    """A plain CPU copy of nested dicts, lists and tuples of tensors."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return type(obj)((k, _to_host(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _same(a, b, label):
    """Nested tensors equal in dtype and value."""
    if torch.is_tensor(a):
        if not (torch.is_tensor(b) and a.dtype == b.dtype
                and torch.equal(a, b)):
            raise AssertionError(f"{label}: differs")
    elif isinstance(a, dict):
        if list(a) != list(b):
            raise AssertionError(f"{label}: keys differ")
        for k in a:
            _same(a[k], b[k], f"{label}.{k}")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{label}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{label}[{i}]")
    elif a != b:
        raise AssertionError(f"{label}: {a} != {b}")


def check_bf16_moments(args, db, steps_sup, steps_rl):
    """Phase 7, OSIE: the same two supervised steps from optimizer step 2
    from one state (_train_model's, Adam's second moments preset to
    BF16_MOMENT_NU), with torch Adam's float32 first moment and with
    --bf16_moments (the port's Adam): the first step's loss equal, every
    stored first moment bfloat16, the parameters within BF16_MOMENT_GAP
    of the float32 run's largest update and two float32 ulps of the
    parameter; prints both runs' step ms and
    peak memory allocated (the state held through the steps)."""
    import copy

    from scanpaths_tpu_torch.train import steps
    base = _train_model(args)
    start = [p.detach().clone() for p in base.parameters()]
    runs = {}
    for bf16 in (False, True):
        flags = copy.copy(args)
        flags.bf16_moments = bf16
        model = copy.deepcopy(base)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = steps.TrainState.create(model, flags, steps_sup, steps_rl,
                                        step=2, device="cuda")
        for st in state.optimizer.state.values():
            st["exp_avg_sq"].fill_(BF16_MOMENT_NU)
        ms, losses = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = _finite(args.task, "supervised step",
                        steps.supervised_step(state, db, args.lambda_1))
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(m["loss"])
        dtypes = {str(st["exp_avg"].dtype)
                  for st in state.optimizer.state.values()}
        runs[bf16] = dict(ms=ms, losses=losses, dtypes=dtypes,
                          peak=torch.cuda.max_memory_allocated(),
                          params=[p.detach().cpu() for p in
                                  model.parameters()])
        del state, model
    f32, b16 = runs[False], runs[True]
    if b16["dtypes"] != {"torch.bfloat16"} or \
            f32["dtypes"] != {"torch.float32"}:
        raise AssertionError(f"first moments {f32['dtypes']}, "
                             f"{b16['dtypes']}")
    first_gap = abs(b16["losses"][0] - f32["losses"][0])
    if not first_gap <= 1e-6 * abs(f32["losses"][0]):
        raise AssertionError(f"bf16 moments: first loss {b16['losses'][0]} "
                             f"against {f32['losses'][0]}")
    update = max(float((p - q).abs().max())
                 for p, q in zip(f32["params"], start))
    gap = max(float((p - q).abs().max())
              for p, q in zip(b16["params"], f32["params"]))
    excess = max(float(((p - q).abs() - 2 * F32_ULP * q.abs()).max())
                 for p, q in zip(b16["params"], f32["params"]))
    if not excess <= BF16_MOMENT_GAP * update:
        raise AssertionError(f"bf16 moments: parameters {gap:.3g} from the "
                             f"float32 run's ({excess:.3g} over two ulps), "
                             f"largest update {update:.3g}")
    n = sum(p.numel() for p in start)
    print(f"[train] {args.task} --bf16_moments, two supervised steps from "
          f"step 2 from one state (second moments preset to "
          f"{BF16_MOMENT_NU}): loss {', '.join(f'{v:.6f}' for v in b16['losses'])}"
          f" against float32 moments {', '.join(f'{v:.6f}' for v in f32['losses'])}"
          f" (first step {'bit-equal' if first_gap == 0 else f'gap {first_gap:.3g}'});"
          f" every stored first moment bfloat16; largest parameter gap "
          f"{gap:.3g}, {excess:.3g} beyond two float32 ulps of the "
          f"parameter ({100 * max(excess, 0.0) / update:.3f}% of the largest "
          f"update {update:.3g}, bar {100 * BF16_MOMENT_GAP:.0f}%); step ms "
          f"{', '.join(f'{v:.1f}' for v in b16['ms'])} against "
          f"{', '.join(f'{v:.1f}' for v in f32['ms'])}; peak allocated "
          f"{_mib(b16['peak']):.1f} MiB against {_mib(f32['peak']):.1f} MiB "
          f"({(f32['peak'] - b16['peak']) / 1e6:.1f} MB less; half the "
          f"first moment of {n} parameters: {2 * n / 1e6:.1f} MB)",
          flush=True)


def measure_write_overlap(state, db, rdbs, rl_cfg, gen, lambda_1, tmp):
    """Phase 7, OSIE: what an async checkpoint write in flight costs the
    steps it overlaps (its writer thread holds the GIL while it
    pickles).  Three SCST and three supervised steps without a write,
    then each kind again right after AsyncCheckpointManager.step of the
    state (the trainer's reference-layout model and Adam state): prints
    the ms step() blocked, the write's ms, and the mean ms of the steps
    that ran while the write was in flight against the mean without."""
    from scanpaths_tpu_torch.models.port import to_reference_state_dict
    from scanpaths_tpu_torch.train import steps, tp_step
    from scanpaths_tpu_torch.utils import checkpointing as ck

    def take(kind, n=3):
        spans = []
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "SCST":
                steps.rl_step(state, rdbs[i % len(rdbs)], rl_cfg,
                              generator=gen)
            else:
                steps.supervised_step(state, db, lambda_1)
            torch.cuda.synchronize()
            spans.append((t0, time.perf_counter()))
        return spans

    def mean_ms(spans):
        return 1e3 * sum(b - a for a, b in spans) / max(len(spans), 1)

    writes = []
    real_save = ck.save

    def save(path, obj):
        t0 = time.perf_counter()
        real_save(path, obj)
        writes.append((t0, time.perf_counter()))
    mgr = ck.AsyncCheckpointManager(os.path.join(tmp, "overlap"))
    with mock.patch.object(ck, "save", save):
        for kind in ("SCST", "supervised"):
            alone = take(kind)
            model = state.model
            t0 = time.perf_counter()
            mgr.step(0.5, to_reference_state_dict(
                tp_step.full_state_dict(model), model.task, model.map_h,
                model.map_w), tp_step.full_optimizer_state(state.optimizer))
            blocked = 1e3 * (time.perf_counter() - t0)
            spans = take(kind)
            mgr.wait()
            start, end = writes[0][0], writes[-1][1]
            during = [sp for sp in spans if sp[0] < end]
            print(f"[train] osie async checkpoint write during {kind} steps: "
                  f"step() blocked {blocked:.1f} ms (the host copy), the "
                  f"writes (checkpoint.pth, checkpoint_best.pth) "
                  f"{1e3 * (end - start):.1f} ms on the writer thread; "
                  f"{len(during)} of {len(spans)} steps started while they "
                  f"were in flight: {mean_ms(during):.1f} ms a step against "
                  f"{mean_ms(alone):.1f} ms without a write "
                  f"({100 * (mean_ms(during) / mean_ms(alone) - 1):+.1f}%)",
                  flush=True)
            writes.clear()
    mgr.close()


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
# validation split; 8 train images, the fewest that give the SCST epoch
# the two steps its profiled window needs, keep the whole script inside
# its time with phases 10 and 11), and the steps of each epoch profiled
TRAINER_IMAGES, VALIDATION_IMAGES = 8, 16
PROFILE_STEPS = 2


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
    backend = "msgpack" if task == "air" else "orbax"
    return ["--task", task, "--img_dir", img_dir, "--fix_dir", fix_dir,
            "--ckpt_backend", backend,
            "--log_root", os.path.join(root, "logs"),
            "--batch", str(TEST_BATCH), "--eval_repeat_num", str(REPEATS),
            "--seed", "0", "--epoch", "2", "--start_rl_epoch", "1",
            "--warmup_epoch", "1", "--device_eval", "true",
            "--device", "cuda"] + maps.get(task, [])


def _minus(a, b):
    return {k: a[k] - b[k] for k in a}


def _expect(label, got, want):
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


@contextlib.contextmanager
def trainer_probes(cell, block, nw, tr, device_eval, ck, trace=True):
    """Wraps the port's Trainer for phase 8 and yields the list of its
    records, one dict per training epoch, validation, human baseline and
    checkpoint write: the launch counts of each (zeroed at its start,
    read at its end), the epoch's stats (``Trainer.epoch_stats``), its
    peak memory, the NW calls of an SCST epoch (their inputs and outputs
    cloned), a torch.profiler window over the epoch's last PROFILE_STEPS
    steps (device busy and span; without ``trace`` none, and NaN),
    the wall times of each validation and of the device sweep inside it,
    and each checkpoint write's ms and file sizes.  The seed duration head's last conv is scaled by 0.01
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
    real_async = ck.AsyncCheckpointManager.step
    async_steps = []
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
        before, calls = tracing.launches(), []
        with (_timed_calls(nw, "nw_scores_bins", calls, keep_args=True)
              if rl else contextlib.nullcontext()):
            out = real["train_epoch"](self, iteration, epoch)
        stamps = window["stamps"]
        free = len(stamps) - PROFILE_STEPS    # the steps before the window
        busy = span = float("nan")
        if trace:
            span = window["span"]
            # the trace is read after the epoch, outside its timing
            _, streams = _device_events(window["done"])
            busy = _union_ms([iv for ivs in streams.values() for iv in ivs])
        records.append(dict(
            kind="epoch", rl=rl, stats=dict(self.epoch_stats),
            launches=_minus(tracing.launches(), before),
            peak=torch.cuda.max_memory_allocated(), nw_calls=calls,
            busy=busy, span=span,
            free_rate=(free - 1) / (stamps[free - 1] - stamps[0])
            if free > 1 else float("nan")))
        return out

    def maybe_profile(self, iteration):
        k = iteration - window["first"]         # 1-based step of the epoch
        window["stamps"].append(time.perf_counter())
        if not trace:
            return
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
        def add(*a, **kw):
            t = time.perf_counter()
            real_fn(*a, **kw)
            sweep[0] += time.perf_counter() - t
        return add

    def validation_device(self, iteration):
        torch.cuda.synchronize()
        before, sweep[0], t0 = (tracing.launches(), 0.0,
                                time.perf_counter())
        out = real["validation_device"](self, iteration)
        torch.cuda.synchronize()
        records.append(dict(kind="validation", wall=time.perf_counter() - t0,
                            sweep=sweep[0],
                            launches=_minus(tracing.launches(),
                                            before)))
        return out

    def human_baseline(self):
        before, t0 = tracing.launches(), time.perf_counter()
        out = real["human_baseline"](self)
        records.append(dict(kind="human", wall=time.perf_counter() - t0,
                            launches=_minus(tracing.launches(),
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
    def async_step(self, metric, model_state, opt_state=None):
        torch.cuda.synchronize()
        state = _to_host({"model": model_state, "optimizer": opt_state})
        best = self.get_best_metric()
        t0 = time.perf_counter()
        real_async(self, metric, model_state, opt_state)
        ms = 1e3 * (time.perf_counter() - t0)
        wrote_best = not best or (metric >= best)
        records.append(dict(kind="checkpoint", ms=ms, writes=[],
                            n_writes=1 + wrote_best))
        async_steps.append((records[-1], self, state, wrote_best))
    with mock.patch.object(tr.Trainer, "train_epoch", train_epoch), \
            mock.patch.object(tr.Trainer, "_maybe_profile", maybe_profile), \
            mock.patch.object(tr.Trainer, "validation_device",
                              validation_device), \
            mock.patch.object(tr.Trainer, "human_baseline", human_baseline), \
            mock.patch.object(tr, "init_weights", init_weights), \
            mock.patch.object(ck.CheckpointManager, "step", checkpoint_step), \
            mock.patch.object(ck.AsyncCheckpointManager, "step",
                              async_step), \
            mock.patch.object(device_eval.DeviceSweep, "add_batch",
                              timed(real_add)), \
            mock.patch.object(device_eval.DeviceSweep, "add_batch_air",
                              timed(real_add_air)):
        yield records
    check_async_writes(async_steps, ck)


def check_async_writes(async_steps, ck):
    """After an async run (its manager closed): each step's record takes
    its writes (file, ms, MB) from the manager, and the final
    checkpoint.pth and checkpoint_best.pth load equal to a synchronous
    write (checkpointing.save) of the states those steps were given."""
    done = {}
    for rec, mgr, _, _ in async_steps:
        i = done.get(id(mgr), 0)
        rec["writes"] = [[name, ms, size / 1e6]
                         for name, ms, size in
                         mgr.writes[i:i + rec["n_writes"]]]
        done[id(mgr)] = i + rec["n_writes"]
        if len(rec["writes"]) != rec["n_writes"]:
            raise AssertionError(f"async checkpoint: {rec['writes']}")
    if not async_steps:
        return
    mgr = async_steps[-1][1]
    last = async_steps[-1][2]
    best = [st for _, _, st, wrote in async_steps if wrote]
    with tempfile.TemporaryDirectory() as d:
        pairs = [(mgr.path, os.path.join(d, "sync.pth"), last)]
        if best:
            pairs.append((mgr.best_path, os.path.join(d, "sync_best.pth"),
                          {"model": best[-1]["model"]}))
        for path, sync_path, state in pairs:
            ck.save(sync_path, state)
            _same(ck.load(path), ck.load(sync_path),
                  os.path.basename(path))


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
        elif "writes" in rec:
            print(f"[trainer] {task} {label} checkpoint write, async "
                  f"(--ckpt_backend orbax): step() blocked {rec['ms']:.1f} "
                  f"ms; on the writer thread "
                  + ", ".join(f"{name} {ms:.1f} ms ({mb:.1f} MB)"
                              for name, ms, mb in rec["writes"])
                  + ("" if rec["n_writes"] == 2
                     else ", checkpoint_best.pth not rewritten")
                  + "; the final files equal a synchronous write of the "
                  "same states", flush=True)
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
    """No cell, stage, head or compose launch in a training step; 16
    cell, 3 stage and 16 head launches a stream per validation forward
    and one compose launch a validation (the weights' one version); NW:
    2 per SCST step and stream (2
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
                                             "nw_scores_bins": nw_want,
                                             "cond_head": 0,
                                             "cond_compose": 0})
        elif rec["kind"] == "validation":
            _expect(where, rec["launches"], {
                "cell_step": SEQ * val_forwards,
                "stage_apply": 3 * val_forwards,
                "nw_scores_bins": 2 * repeats * val_forwards * n_streams,
                "cond_head": SEQ * val_forwards * n_streams,
                "cond_compose": 1})
        elif rec["kind"] == "human":
            _expect(where, rec["launches"], {
                "cell_step": 0, "stage_apply": 0,
                "nw_scores_bins": 2 * val_forwards, "cond_head": 0,
                "cond_compose": 0})


def run_trainer_slice(cell, block, nw, argv, keep=None):
    """Phase 8 for one task: cli/train.py at full width on the card (one
    supervised epoch, then one SCST epoch, each followed by a validation
    with the device sweep), its artifacts, scalars and launch counts,
    every NW call of its SCST steps against the plain NW, then
    cli/test.py on the run (it must read the run's own
    checkpoint_best.pth), and for OSIE a resumed third epoch (the record's
    iteration, Adam's step count and the lr scalar go on).  ``keep``, a
    dict, receives the first run's record and scalars, the test driver's
    argv on a copy of the run, its metrics, stds, records and wall, and
    the split's root, which is then left in place (phase 11 holds its
    runs over ranks to them, and removes it).  Returns the kernels'
    launches of the phase."""
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
    total = dict.fromkeys(tracing.KERNELS, 0)

    def run(label, run_argv):
        t0 = time.perf_counter()
        with trainer_probes(cell, block, nw, tr, device_eval, ck) as recs, \
                contextlib.redirect_stdout(io.StringIO()):
            before = tracing.launches()
            best = train_cli.main(run_argv)
            got = _minus(tracing.launches(), before)
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
    if keep is not None:
        keep.update(record=dict(record), scalars=scalars)

    # the test driver on the run's own checkpoint_best.pth
    opened = []
    real_path = predictor.checkpoint_path

    def checkpoint_path(evaluation_dir):
        opened.append(real_path(evaluation_dir))
        return opened[-1]
    test_argv = [a for a in argv] + ["--evaluation_dir", log_dir]
    seen = []
    real_eval = tr.EvalCore.evaluate

    def evaluate(self, *a, **kw):
        seen.append(real_eval(self, *a, **kw))
        return seen[-1]
    before = tracing.launches()
    t0 = time.perf_counter()
    with mock.patch.object(predictor, "checkpoint_path", checkpoint_path), \
            mock.patch.object(tr.EvalCore, "evaluate", evaluate), \
            contextlib.redirect_stdout(io.StringIO()):
        metrics = test_cli.main(test_argv)
    torch.cuda.synchronize()
    test_wall = time.perf_counter() - t0
    got = _minus(tracing.launches(), before)
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
        + 2 * REPEATS * val_forwards * streams,
        "cond_head": SEQ * val_forwards * streams,
        "cond_compose": 1})
    out = "validation" if task == "coco" else "test"
    with open(os.path.join(log_dir, f"{out}_predicts.json")) as f:
        records = json.load(f)
    n_records = len(records)
    if n_records != VALIDATION_IMAGES * REPEATS * streams:
        raise AssertionError(f"{task} test on the run: {n_records} records")
    print(f"[trainer] {task} cli/test.py --evaluation_dir <the run>: read "
          f"its checkpoint_best.pth, {n_records} records, "
          f"{time.perf_counter() - t0:.2f} s wall, launches {got}",
          flush=True)
    if keep is not None:
        # the run as the test driver read it (a resume below may write a
        # new checkpoint_best.pth)
        kept = os.path.join(os.path.dirname(log_root), "kept_run")
        shutil.copytree(log_dir, kept)
        (_, stds, _), = seen
        keep.update(root=os.path.dirname(log_root), test=dict(
            metrics=metrics, stds=stds, records=records, wall=test_wall),
            test_argv=argv + ["--evaluation_dir", kept])

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
        print(f"[trainer] osie resume --epoch 3 from the checkpoint.pth "
              f"the async writer wrote: went on from iteration "
              f"{record['iteration']} and Adam step {step0} to iteration "
              f"{record2['iteration']} and step {step1}; every learning_rate "
              f"scalar (the lr the optimizer applied) written once, equal "
              f"to lr * lr_multiplier of its run's schedule; first resumed "
              f"step at lr {lr[first][0]} (the --epoch 2 schedule gave "
              f"{old_lr})", flush=True)
    shutil.rmtree(log_root if keep is not None else os.path.dirname(log_root))
    torch.cuda.empty_cache()
    return total


JOINT_IMAGES = 8         # train and validation images a task
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
            before, calls, prof = tracing.launches(), [], None
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
                       launches=_minus(tracing.launches(), before),
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
        def add(*a, **kw):
            t = time.perf_counter()
            real_fn(*a, **kw)
            sweep[0] += time.perf_counter() - t
        return add

    def evaluate(self, loader, device_eval_, iteration=0, record=None):
        torch.cuda.synchronize()
        before, sweep[0], t0 = (tracing.launches(), 0.0,
                                time.perf_counter())
        out = real_eval(self, loader, device_eval_, iteration, record)
        torch.cuda.synchronize()
        records.append(dict(kind="validation", task=self.task,
                            wall=time.perf_counter() - t0, sweep=sweep[0],
                            forwards=len(loader),
                            launches=_minus(tracing.launches(),
                                            before)))
        return out

    def human_metrics(self, loader, device_eval_):
        before, t0 = tracing.launches(), time.perf_counter()
        out = real_human(self, loader, device_eval_)
        torch.cuda.synchronize()
        records.append(dict(kind="human", task=self.task, forwards=len(loader),
                            wall=time.perf_counter() - t0,
                            launches=_minus(tracing.launches(),
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
    """The launch counts of the phase's training steps (no cell, stage,
    head or compose launch; NW 2 per SCST step and stream), validations
    (16 cell and 3 stage launches per forward, one compose launch a
    validation, NW 2 per sweep batch, repeat and stream)
    and human baselines (NW 2 per batch), and every NW call of the SCST
    steps against the plain NW exactly.  Returns the NW calls checked."""
    checked = 0
    for i, rec in enumerate(records):
        where = f"joint {rec['kind']} {i} ({rec.get('task')})"
        streams = 2 if rec.get("task") == "air" else 1
        if rec["kind"] == "step":
            _expect(where, rec["launches"], {
                "cell_step": 0, "stage_apply": 0,
                "nw_scores_bins": 2 * streams if rec["rl"] else 0,
                "cond_head": 0, "cond_compose": 0})
            for j, (_, _, a, out) in enumerate(rec["nw_calls"]):
                _exact(f"{where} SCST NW call {j + 1}", out,
                       nw.nw_scores_bins_plain(*a))
            checked += len(rec["nw_calls"])
        elif rec["kind"] == "validation":
            fw = rec["forwards"]
            _expect(where, rec["launches"], {
                "cell_step": SEQ * fw, "stage_apply": 3 * fw,
                "nw_scores_bins": 2 * repeats * fw * streams,
                "cond_head": SEQ * fw * streams, "cond_compose": 1})
        elif rec["kind"] == "human":
            _expect(where, rec["launches"], {
                "cell_step": 0, "stage_apply": 0,
                "nw_scores_bins": 2 * rec["forwards"], "cond_head": 0,
                "cond_compose": 0})
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
    kernels' launches of the phase and the run's dir (moved to
    ``tmp/joint_run``)."""
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
        before = tracing.launches()
        best = train_cli.main(argv)
        total = _minus(tracing.launches(), before)
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
        before, t0 = tracing.launches(), time.perf_counter()
        with mock.patch.object(predictor, "checkpoint_path",
                               checkpoint_path), \
                contextlib.redirect_stdout(io.StringIO()):
            metrics = test_cli.main(joint_head_flags(root, task) + [
                "--evaluation_dir", log_dir, "--batch", str(args.batch),
                "--eval_repeat_num", str(REPEATS), "--seed", "0",
                "--device_eval", "true", "--device", "cuda"])
        torch.cuda.synchronize()
        got = _minus(tracing.launches(), before)
        if opened[-1:] != [want_path]:
            raise AssertionError(f"{task} test on the joint run read "
                                 f"{opened}, expected {want_path}")
        _check_tree(metrics)
        _expect(f"{task} test on the joint run", got, {
            "cell_step": SEQ * fw, "stage_apply": 3 * fw,
            "nw_scores_bins": 2 * fw + 2 * REPEATS * fw * streams,
            "cond_head": SEQ * fw * streams, "cond_compose": 1})
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
    tracing.reset_counters("cell_step.launches", "stage_apply.launches",
                           "cond_head.launches", "cond_compose.launches")
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
    got = {k: tracing.counter(f"{k}.launches")
           for k in ("cell_step", "stage_apply", "cond_head", "cond_compose")}
    _expect("predict on the joint run", got, {
        "cell_step": SEQ * forwards, "stage_apply": 3 * forwards,
        "cond_head": SEQ * forwards, "cond_compose": 1})
    for k in got:
        total[k] += got[k]
    print(f"[joint] cli/predict.py --task coco --evaluation_dir <the joint "
          f"run>: {len(records)} records from {IMAGES} images with targets "
          f"{SERVE_TARGETS}, {secs:.2f} s wall, launches {got}; {inf} "
          "sampled durations overflow float32", flush=True)
    # the run outlives its data: phase 10 exports its COCO head
    kept = os.path.join(tmp, "joint_run")
    shutil.move(log_dir, kept)
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return total, kept


# ---------------------------------------------------------------------------
# phase 10: the serving export
# ---------------------------------------------------------------------------

# where phase 10 exports and serves (a CPU rehearsal sets "cpu")
DEVICE = "cuda"
EXPORT_TIMEOUT = 600  # s, for all the export processes together
TIME_ITERS = 10       # bundle and live calls a side, in turns


def model_flags(test_argv, task):
    """The serving flags of a task's phase-3 run at full width."""
    argv = test_argv[task]
    return ["--task", task, "--evaluation_dir",
            argv[argv.index("--evaluation_dir") + 1], "--seed", "0"] \
        + FULL_WIDTH


def export_jobs(test_argv, joint_run, out):
    """cli/export.py's argv of each bundle phase 10 serves: every task's
    float32 greedy bundle at batch BATCH from phase 3's seed checkpoint,
    with --export_check; for OSIE also a sampled one (10 samples), a
    bfloat16 one and a symbolic batch, and phase 9's joint run's COCO
    head, whose checks run in this process."""
    jobs = {task: model_flags(test_argv, task) + ["--export_check", "true"]
            for task in TASKS}
    osie = model_flags(test_argv, "osie") + ["--export_check", "false"]
    jobs["osie_sample"] = osie + ["--decode", "sample", "--num_samples",
                                  "10"]
    jobs["osie_bf16"] = osie + ["--half_precision", "true"]
    jobs["osie_sym"] = osie + ["--export_batch", "sym"]
    jobs["joint_coco"] = model_flags(test_argv, "coco") + [
        "--evaluation_dir", joint_run, "--export_check", "false"]
    return {name: ["--export_batch", str(BATCH), "--device", DEVICE] + argv
            + ["--export_dir", os.path.join(out, name)]
            for name, argv in jobs.items()}


@contextlib.contextmanager
def export_bundles(jobs, out):
    """Starts ``python -m scanpaths_tpu_torch.cli.export`` for every job,
    all together (tracing is single-threaded host work, one process a
    job), and yields an iterator over the jobs in the order they finish:
    (name, the bundle's dir, the CLI's export seconds (trace and save),
    the process's wall seconds, the bundle's MB).  Raises with the log of
    a job that failed or whose --export_check did not pass; on leaving,
    stops any process left."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    procs = {}

    def finished():
        deadline = time.perf_counter() + EXPORT_TIMEOUT
        while procs:
            done = [n for n, (p, _, _) in procs.items()
                    if p.poll() is not None]
            if not done:
                if time.perf_counter() > deadline:
                    raise AssertionError(f"cli.export {sorted(procs)} ran "
                                         f"past {EXPORT_TIMEOUT} s")
                time.sleep(0.2)
                continue
            for name in done:
                proc, log, t0 = procs.pop(name)
                wall = time.perf_counter() - t0
                log.close()
                with open(log.name) as f:
                    text = f.read()
                checked = jobs[name][jobs[name].index("--export_check")
                                     + 1] == "true"
                if proc.returncode != 0 or checked != (
                        "[export] check ok" in text):
                    raise AssertionError(f"cli.export {name} exited "
                                         f"{proc.returncode}:\n"
                                         f"{text[-3000:]}")
                d = jobs[name][jobs[name].index("--export_dir") + 1]
                yield (name, d, float(text.split(" bytes in ")[1]
                                      .split(" s ")[0]), wall,
                       _mib(os.path.getsize(os.path.join(d, "serve.pt2"))))
    try:
        for name, argv in jobs.items():
            log = open(os.path.join(out, f"{name}.log"), "w")
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", "scanpaths_tpu_torch.cli.export",
                 *argv], cwd=repo, env=env, stdout=log,
                stderr=subprocess.STDOUT), log, time.perf_counter())
        yield finished()
    finally:
        for proc, log, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def _program_streams(fn):
    """The signal-stream count of each cell op in a loaded bundle's
    program (its smaps input's last dim)."""
    op = torch.ops.scanpaths_tpu_torch.cell_step.default
    return [n.args[3].meta["val"].shape[-1] for n in fn.module.graph.nodes
            if n.target is op]


def _exactly(name, got, want):
    for k in ("fix", "fix_len", "action_probs"):
        if not torch.equal(got[k].cpu(), want[k].cpu()):
            raise AssertionError(f"{name}: {k} differs")


def run_export_slice(cell, block, predict, predictor_mod, tmp, test_argv,
                     joint_run, smi):
    """Phase 10: cli/export.py writes every bundle of export_jobs (the
    exports run as processes, together), then this process loads each
    with serve.load_bundle and serves phase 5's images through
    cli/predict.py --bundle, counting the kernels launched inside the
    exported programs, and holds the records to the live CLI's (phase
    5's files) exactly; the OSIE bundles' own checks (module docstring);
    the bundle's ms per call against the live forward+decode at batch
    BATCH.  Returns the kernels' launches of the phase."""
    from scanpaths_tpu_torch.core.config import parse_opt
    img_dir = serving_images(tmp)
    out = os.path.join(tmp, "bundles")
    os.makedirs(out)
    torch.cuda.empty_cache()
    loaded, real_load = {}, predict.load_bundle

    def load(path, device=None):
        t1 = time.perf_counter()
        fn, mf = real_load(path, device)
        loaded[path] = (fn, mf, time.perf_counter() - t1)
        return fn, mf
    total = {"cell_step": 0, "stage_apply": 0, "cond_head": 0,
             "cond_compose": 0}
    calls = -(-IMAGES // BATCH)
    serving = {task: task for task in TASKS}
    serving.update(osie_sample="osie", osie_bf16="osie", osie_sym="osie",
                   joint_coco="coco")
    served, bundles = {}, {}

    def serve(name, d, secs, wall, mb):
        """cli/predict.py --bundle on the served images; checks the
        records and the launches (16 cell, cell ops with S streams, 3
        stage and 16 S head a call; one compose a call, none for COCO,
        whose bundle holds its bank composed)."""
        task = serving[name]
        want_s = 2 if task == "air" else 1
        tracing.reset_counters("cell_step.launches", "stage_apply.launches",
                               "cond_head.launches", "cond_compose.launches")
        with mock.patch.object(predict, "load_bundle", load):
            records = predict.main(
                ["--task", task, "--bundle", d, "--predict_images", img_dir,
                 "--batch", str(BATCH), "--seed", "0", "--device", DEVICE,
                 "--predict_out", os.path.join(tmp, f"bundle_{name}.json")]
                + serving_inputs(tmp, task))
        torch.cuda.synchronize()
        fn, mf, load_s = loaded[d]
        got = {k: tracing.counter(f"{k}.launches") for k in total}
        _expect(f"bundle {name}", got, {
            "cell_step": SEQ * calls, "stage_apply": 3 * calls,
            "cond_head": SEQ * calls * want_s,
            "cond_compose": 0 if task == "coco" else calls})
        streams = _program_streams(fn)
        if streams != [want_s] * SEQ:
            raise AssertionError(f"bundle {name}: cell ops with streams "
                                 f"{streams}, expected {SEQ} with S={want_s}")
        _check_records(records, IMAGES, 10 if mf["decode"] == "sample"
                       else 1, 320, 240)
        for k in total:
            total[k] += got[k]
        served[name], bundles[name] = records, (fn, mf)
        print(f"[export] {name}: cli.export {secs:.1f} s (trace and save; "
              f"its process {wall:.1f} s), bundle {mb:.1f} MB, load "
              f"{load_s:.1f} s; --bundle served {len(records)} records in "
              f"{calls} calls, launches {got} (cell ops S={want_s})",
              flush=True)

    # each bundle is served as its export ends, while the others run
    t0 = time.perf_counter()
    with export_bundles(export_jobs(test_argv, joint_run, out), out) as done:
        for job in done:
            serve(*job)
    print(f"[export] {len(served)} cli.export processes (the float32 ones "
          f"with --export_check) and their bundles served in "
          f"{time.perf_counter() - t0:.1f} s wall", flush=True)

    for name, half in (("osie", "false"), ("air", "false"),
                       ("coco", "false"), ("osie_bf16", "true")):
        task = serving[name]
        with open(os.path.join(tmp, f"{task}_greedy_{half}.json")) as f:
            if served[name] != json.load(f):
                raise AssertionError(f"bundle {name}: records differ from "
                                     "the live cli.predict's")
        print(f"[export] {name}: its {len(served[name])} records equal live "
              f"cli.predict --half_precision {half}'s (phase 5) exactly",
              flush=True)
    from scanpaths_tpu_torch.serve.export import ServeModule, serving_fn
    images = forward_inputs("osie")[0]
    f32_fn, bf16_fn = bundles["osie"][0], bundles["osie_bf16"][0]
    flags = model_flags(test_argv, "osie")

    def live(pred, x):
        s = pred.decode(pred.forward(x), "greedy", 1)
        return {"fix": s.fix[0], "fix_len": s.fix_len[0],
                "action_probs": s.action_probs[0]}

    def counted(label, calls, run):
        """``run()``'s bundle calls, with their launches checked and
        added to the phase's."""
        tracing.reset_counters("cell_step.launches", "stage_apply.launches",
                               "cond_head.launches", "cond_compose.launches")
        out = run()
        torch.cuda.synchronize()
        want = {"cell_step": SEQ * calls, "stage_apply": 3 * calls,
                "cond_head": SEQ * calls, "cond_compose": calls}
        _expect(label, {k: tracing.launches()[k] for k in want}, want)
        for k, v in want.items():
            total[k] += v
        return out
    pred = predictor_mod.Predictor(parse_opt(flags), DEVICE)

    # OSIE sampled: the seed decides the draw, as the live serving module
    # draws it
    fn, mf = bundles["osie_sample"]
    a, b, c = counted("osie_sample seeds", 3, lambda: (
        fn(1, images), fn(1, images), fn(2, images)))
    _exactly("osie_sample, seed 1 twice", b, a)
    _exactly("osie_sample against the live serving module", a, serving_fn(
        ServeModule(pred.model, pred.grid, "sample").eval(), mf,
        DEVICE)(1, images))
    if torch.equal(a["fix"], c["fix"]):
        raise AssertionError("osie_sample: seeds 1 and 2 drew the same "
                             "scanpaths")
    print(f"[export] osie_sample: {tuple(a['fix'].shape)} fixations a call; "
          "seed 1 twice gives equal outputs, equal to the live serving "
          "module's on seed 1; seed 2 other ones", flush=True)

    # OSIE symbolic batch: batch 8 against the batch-8 bundle, batch 1
    # against the live predictor at batch 1; the CLI's chunks of 8 and 4
    # against live cli.predict, whose tail chunk runs padded to 8
    sym_fn, mf = bundles["osie_sym"]
    one, eight = counted("osie_sym batches 1 and 8", 2, lambda: (
        sym_fn(images[:1]), sym_fn(images)))
    _exactly("osie_sym at batch 8 against the batch-8 bundle", eight,
             f32_fn(images))
    _exactly("osie_sym at batch 1 against the live predictor", one,
             live(pred, images[:1]))
    with open(os.path.join(tmp, "osie_greedy_false.json")) as f:
        want = json.load(f)
    if served["osie_sym"][:BATCH] != want[:BATCH]:
        raise AssertionError("osie_sym: the first chunk's records differ "
                             "from live cli.predict's")
    tail = [(g["X"] == w["X"] and g["Y"] == w["Y"], max(
        [abs(x - y) / max(abs(y), 1e-30) for x, y in zip(g["T"], w["T"])]
        or [0.0])) for g, w in zip(served["osie_sym"][BATCH:], want[BATCH:])]
    print(f"[export] osie_sym (inputs {mf['inputs'][0]['shape']}): batch 8 "
          f"equals the batch-8 bundle and batch 1 the live predictor at batch"
          f" 1 exactly; through the CLI the first chunk's {BATCH} records "
          f"equal live cli.predict's exactly, the tail chunk of "
          f"{len(tail)} (run at batch {len(tail)}, the live CLI pads it to "
          f"{BATCH}): positions equal in {sum(t[0] for t in tail)} records, "
          f"durations within rtol {max(t[1] for t in tail):.3g}",
          flush=True)

    # the bundle's ms per call against the live forward+decode
    for half, fn in (("false", f32_fn), ("true", bf16_fn)):
        if half == "true":
            del pred
            pred = predictor_mod.Predictor(parse_opt(
                flags + ["--half_precision", half]), DEVICE)
        names = ("cell_step", "stage_apply", "cond_head", "cond_compose")
        kernels = [tracing.counter(f"{k}.launches") for k in names]
        bundle_ms, live_ms = _pair_ms(lambda: fn(images),
                                      lambda: live(pred, images), TIME_ITERS)
        n = 2 + 4 * TIME_ITERS
        # the bundle composes in each of its n / 2 calls, the live model
        # once a weight version: the bfloat16 predictor made here once,
        # the float32 one, which served above, not again
        composes = n // 2 + (half == "true")
        if [tracing.counter(f"{k}.launches") - c
                for k, c in zip(names, kernels)] != [n * SEQ, n * 3, n * SEQ,
                                                     composes]:
            raise AssertionError("timed calls: unexpected launches")
        dtype = "bfloat16" if half == "true" else "float32"
        print(f"[export] osie {dtype} batch {BATCH}: bundle {bundle_ms:.2f} "
              f"ms a call, live forward+decode {live_ms:.2f} ms "
              f"({bundle_ms / live_ms - 1:+.1%}); {smi}", flush=True)
        profile_call(lambda: fn(images), f"bundle osie N={BATCH} {dtype}")
        profile_call(lambda: live(pred, images),
                     f"live forward+decode osie N={BATCH} {dtype}")
    del pred

    # the float32 bundle exported on the card, loaded on the CPU, against
    # the live predictor on the CPU: both run the plain versions
    t1 = time.perf_counter()
    cpu_fn, _ = real_load(os.path.join(out, "osie_sym"), "cpu")
    load_cpu = time.perf_counter() - t1
    cpu_pred = predictor_mod.Predictor(parse_opt(flags), "cpu")
    t1 = time.perf_counter()
    got = cpu_fn(images[:2])
    secs_cpu = time.perf_counter() - t1
    _exactly("osie_sym on the CPU against the live CPU predictor", got,
             live(cpu_pred, images[:2]))
    del cpu_pred, cpu_fn
    print(f"[export] osie_sym loaded on the CPU in {load_cpu:.1f} s: 2 images"
          f" in {secs_cpu:.2f} s, equal to the live CPU predictor exactly "
          f"({torch.get_num_threads()} threads)", flush=True)

    loaded.clear()
    bundles.clear()
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 11: data parallel
# ---------------------------------------------------------------------------

# the script the phase's torchrun workers run (this file; a CPU rehearsal
# points it at a wrapper that stubs the card calls first)
SCRIPT = os.path.abspath(__file__)
DP_TASKS = ("osie", "air")
DP_STEPS = 2                 # supervised and SCST steps a task and side
DP_START, DP_NU = 2, 1e-4    # optimizer step and preset second moments
DP_METRIC_RTOL = 1e-5
# The gradient norm is the one metric read from the float32 gradient of
# the BN-trained trunk, whose rounding depends on how the batch is split
# over the ranks (and varies run to run: cuDNN's backward is not
# deterministic), and the steps after the first start from weights that
# already part in the last bits, which that gradient amplifies (the SCST
# gradient is a sum of advantages of either sign over nearly equal
# rollouts).  In runs of this phase on an NVIDIA H100 80GB HBM3 at 700 W,
# with every loss and reward within 2.4e-6, world 1 and world 2 parted
# by 5.6e-6 (OSIE) and 1.7e-4 (AiR) in the first step's gradient norm
# and by up to 2.7e-2 at OSIE's last SCST step.  So the gradient norm is
# held at DP_GRAD_NORM_RTOL, which a gradient summed once too few or too
# many times (a change by tens of percent) still fails, and the state is
# held tight after the first step and reported after the last.  The first
# step starts from the same weights on both sides, so its gradient norm
# parts by the batch split's rounding alone (and the two BN formulas:
# cuDNN's in one process, the all-reduced two-pass one over ranks).
# Under torch.use_deterministic_algorithms world 1 repeats its steps bit
# for bit (every metric and parameter; no op warns), and the two ranks
# part from it by 6.7e-4 in OSIE's first gradient norm (1.6e-4 later);
# without it, by 6.7e-4 (OSIE) and 2.5e-4 (AiR) (phase 11(a'), a run of
# this script on an NVIDIA H100 80GB HBM3 at 700 W).  So the first step
# is held at DP_FIRST_GRAD_NORM_RTOL, the later ones at
# DP_GRAD_NORM_RTOL.
DP_GRAD_NORM_RTOL = 1e-1
DP_FIRST_GRAD_NORM_RTOL = 1e-3
DP_STATE_TOL = dict(rtol=1e-4, atol=1e-6)
# A run's supervised losses against phase 8's single process: the first
# step sees the same weights and batch at DP_METRIC_RTOL; from the first
# update on, Adam from zero moments moves each parameter by about lr
# times the SIGN of its gradient, the two runs' float32 gradients part in
# the last bits (one BN formula a side, the batch split), near-zero
# gradients flip, and the losses drift apart step by step: by 2.6e-3
# (loss/loss) and 4.2e-2 (loss/loss_duration) over OSIE's 15 steps (a
# run of this phase on an NVIDIA H100 80GB HBM3 at 700 W).  Every step
# is held at DP_RUN_DRIFT_RTOL.
DP_RUN_DRIFT_RTOL = 1e-1
DP_TIMEOUT = 600             # s, a torchrun call


def _torchrun(nproc, args, timeout=DP_TIMEOUT, env=None):
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc SCRIPT args`` (``env`` added to the environment), in a session
    of its own that is killed whole on the timeout.  Raises with the
    output's tail unless it exits 0."""
    import signal
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", SCRIPT, *args]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True,
                            env={**os.environ, **(env or {})})
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"torchrun {args[0]} ({nproc} ranks) passed "
                             f"{timeout} s:\n{out[-4000:]}")
    if proc.returncode:
        raise AssertionError(f"torchrun {args[0]} ({nproc} ranks) exited "
                             f"{proc.returncode}:\n{out[-4000:]}")
    return out


def _rank_out(out_dir, rank):
    with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
        return json.load(f)


def _save_state(model, m, out_dir, name):
    """Rank 0 saves ``model``'s state dict, each sliced kernel gathered
    whole (every rank takes part in the gather)."""
    from scanpaths_tpu_torch.train import tp_step
    sd = tp_step.full_state_dict(model)
    if m.is_primary:
        torch.save({k: v.detach().cpu() for k, v in sd.items()},
                   os.path.join(out_dir, f"{name}.pt"))


@contextlib.contextmanager
def checking_kernels(cell, block, label):
    """Within the block every cell and stage kernel call is held to its
    plain version on the same inputs at F32_TOL (scaled); yields the
    lists of the calls' largest errors by kernel."""
    errs = {"cell_step": [], "stage_apply": []}
    cell_k, stage_k = cell.cell_step, block.stage_apply

    def checked_cell(h, c, *a):
        c_p = c.clone()
        h_k, c_k = cell_k(h, c, *a)
        h_p, c_p = cell.cell_step_plain(h, c_p, *a)
        errs["cell_step"].append(max(
            _close(f"cell in {label}", h_k, h_p, F32_TOL, scaled=True),
            _close(f"cell in {label}", c_k, c_p, F32_TOL, scaled=True)))
        return h_k, c_k

    def checked_stage(x, dil, *w):
        y_k = stage_k(x, dil, *w)
        errs["stage_apply"].append(_close(
            f"stage in {label}", y_k, block.stage_apply_plain(x, dil, *w),
            F32_TOL, scaled=True))
        return y_k

    with mock.patch.object(cell, "cell_step", checked_cell), \
            mock.patch.object(block, "stage_apply", checked_stage):
        yield errs


def checked_forward(cell, block, nw, model, batch, device):
    """One eval forward of ``model`` on a host batch through the kernels,
    each kernel call held to its plain version on the same inputs at
    F32_TOL (scaled); returns (the outputs, the calls' largest errors, the
    kernels' launches)."""
    from scanpaths_tpu_torch.serve.predictor import eval_forward
    before = tracing.launches()
    with checking_kernels(cell, block, "TP forward") as errs:
        out = eval_forward(model, device, False, batch["images"],
                           batch.get("attention_maps"), batch.get("tasks"))
    torch.cuda.synchronize()
    return ({k: v.cpu() for k, v in out.items()},
            {k: max(v) for k, v in errs.items()},
            _minus(tracing.launches(), before))


def dp_steps_worker(out_dir, job_path):
    """One rank of phase 11(a), (a') and (d), under torchrun: the job's
    runs in turn in one process group (``runs``, each into
    ``<out_dir>/run<i>``; :func:`_dp_run`), then ``rank<r>.json`` with
    every run's results.  A run may set ``model_parallel`` (the mesh of
    its steps) and ``deterministic`` (torch.use_deterministic_algorithms,
    warn_only, and cuDNN's deterministic algorithms for the run; the
    messages of the ops without a deterministic implementation are
    recorded)."""
    import argparse
    import warnings

    from scanpaths_tpu_torch.train import mesh
    with open(job_path) as f:
        job = json.load(f)
    caught = []
    real_warn = warnings.showwarning

    def showwarning(message, *a, **kw):
        if "deterministic" in str(message):
            caught.append(str(message).split("\n")[0])
        real_warn(message, *a, **kw)
    warnings.simplefilter("always")
    warnings.showwarning = showwarning
    m = mesh.make_mesh(argparse.Namespace(mesh_size=0), DEVICE)
    res = dict(rank=m.rank, world=m.world, backend=m.backend,
               device=str(m.device), note=m.note, runs=[])
    for i, run in enumerate(job["runs"]):
        det = run.get("deterministic", False)
        torch.use_deterministic_algorithms(det, warn_only=True)
        torch.backends.cudnn.deterministic = det
        mesh.set_model_parallel(run.get("model_parallel", 1))
        out = os.path.join(out_dir, f"run{i}")
        os.makedirs(out, exist_ok=True)
        caught.clear()
        res["runs"].append(_dp_run(run, job["argv"], m, out))
        res["runs"][-1]["warned"] = sorted(set(caught))
    with open(os.path.join(out_dir, f"rank{m.rank}.json"), "w") as f:
        json.dump(res, f)
    mesh.close_mesh(m)


def _dp_run(run, argv, m, out_dir):
    """One run of dp_steps_worker: for each task of ``run``, DP_STEPS
    supervised steps at the global --batch and DP_STEPS SCST steps at
    --batch / 4 (DP_STEPS global batches each, this data rank's rows) from
    the seed weights of _train_model, from optimizer step DP_START with
    Adam's second moments preset to DP_NU, on the current mesh (the TP
    state of train/tp_step.py on a model group of more than one rank);
    the metrics, the step and all-reduce times, the launch counts; every
    SCST NW call held to the plain NW exactly.  Rank 0 saves each task's
    state dict (whole) after the first step and after the last.  With
    ``repeat`` the steps are taken that many times from the same state
    (``<task>_<i>`` files); with ``forward``, an eval forward of the seed
    weights on the first supervised batch (the sliced kernels gathered
    whole) through the kernels, each call held to its plain version, its
    outputs saved by rank 0; with ``test``, cli/test.py's main on each
    argv after the steps (its metrics and stds, rank 0's records, the
    launches)."""
    import copy

    from scanpaths_tpu_torch.data.datasets import (EvaluationDataset, Loader,
                                                   SupervisedDataset)
    from scanpaths_tpu_torch.ops import block, cell, nw
    from scanpaths_tpu_torch.train import mesh, steps, tp_step, trainer
    res = dict(model_parallel=mesh.model_size(), tasks={}, tests=[])
    real_reduce = mesh.reduce_gradients

    def timed_reduce(params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_reduce(params)
        torch.cuda.synchronize()
        reduce_ms.append(1e3 * (time.perf_counter() - t0))
    for task in run["tasks"]:
        args = _train_args(argv[task])
        cfg = trainer.data_config(args)
        sup_loader = Loader(SupervisedDataset(task, cfg, "train"),
                            batch_size=args.batch, shuffle=True,
                            seed=args.seed, drop_last=True,
                            **trainer.rank_slice())
        rl_loader = Loader(EvaluationDataset(task, cfg, "train"),
                           batch_size=max(args.batch // 4, 1), shuffle=True,
                           seed=args.seed + 1, drop_last=True,
                           **trainer.rank_slice())
        rl_cfg = trainer.rl_config(args, rl_loader.dataset)
        sup_batches = list(itertools.islice(sup_loader, DP_STEPS))
        rl_batches = list(itertools.islice(rl_loader, DP_STEPS))
        seed = _train_model(args)
        reps = []
        for rep in range(run.get("repeat", 1)):
            tag = f"{task}_{rep}" if run.get("repeat") else task
            state = tp_step.train_state_class().create(
                copy.deepcopy(seed), args, len(sup_loader), len(rl_loader),
                step=DP_START, device=m.device)
            for st in state.optimizer.state.values():
                st["exp_avg_sq"].fill_(DP_NU)
            gen = torch.Generator(device=m.device).manual_seed(args.seed)
            reduce_ms = []
            metrics, step_ms, calls = [], [], []
            tracing.reset_counters()
            # the all-reduce is timed where there is one: a synchronised
            # wrapper in a step that has none would only stall it
            with (mock.patch.object(mesh, "reduce_gradients", timed_reduce)
                  if mesh.distributed() else contextlib.nullcontext()):
                for rl, batches in ((False, sup_batches), (True, rl_batches)):
                    for b in batches:
                        db = steps.device_batch(b, m.device, for_rl=rl)
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        if rl:
                            with _timed_calls(nw, "nw_scores_bins", calls,
                                              keep_args=True):
                                out = steps.rl_step(state, db, rl_cfg,
                                                    generator=gen)
                        else:
                            out = steps.supervised_step(state, db,
                                                        args.lambda_1)
                        metrics.append(_finite(task, f"rank {m.rank} step",
                                               out))
                        torch.cuda.synchronize()
                        step_ms.append(1e3 * (time.perf_counter() - t0))
                        if len(metrics) == 1:
                            _save_state(state.model, m, out_dir,
                                        f"{tag}_first")
            launches = tracing.launches()
            for i, (_, _, a, got) in enumerate(calls):
                _exact(f"{task} rank {m.rank} SCST NW call {i + 1}", got,
                       nw.nw_scores_bins_plain(*a))
            _save_state(state.model, m, out_dir, tag)
            reps.append(dict(
                metrics=metrics, step_ms=step_ms, reduce_ms=reduce_ms,
                launches=launches, nw_checked=len(calls)))
            del state, calls
            torch.cuda.empty_cache()
        res["tasks"][task] = dict(
            reps[0], reps=reps, apply_cd=rl_cfg.apply_cd,
            rows=[int(sup_batches[0]["images"].shape[0]),
                  int(rl_batches[0]["images"].shape[0])],
            params=sum(p.numel() for p in seed.parameters()))
        if run.get("forward"):
            tp_step.shard_model(seed)
            seed.to(m.device).eval()
            with tp_step.gathered(seed):
                outs, errs, got = checked_forward(cell, block, nw, seed,
                                                  sup_batches[0], m.device)
            res["tasks"][task]["forward"] = dict(errs=errs, launches=got)
            if m.is_primary:
                torch.save(outs, os.path.join(out_dir, f"{task}_forward.pt"))
        del seed
        torch.cuda.empty_cache()
    for test_argv in run.get("test", []):
        from scanpaths_tpu_torch.cli import test as test_cli
        seen = []
        real_eval = trainer.EvalCore.evaluate

        def evaluate(self, *a, **kw):
            seen.append(real_eval(self, *a, **kw))
            return seen[-1]
        before = tracing.launches()
        t0 = time.perf_counter()
        with mock.patch.object(trainer.EvalCore, "evaluate", evaluate), \
                contextlib.redirect_stdout(io.StringIO()):
            test_cli.main(test_argv + ["--mesh_size", "0"])
        torch.cuda.synchronize()
        (metrics, stds, records), = seen
        res["tests"].append(dict(
            task=test_argv[test_argv.index("--task") + 1], metrics=metrics,
            stds=stds, records=records, wall=time.perf_counter() - t0,
            launches=_minus(tracing.launches(), before)))
    return res


def dp_train_worker(out_dir, argv):
    """One rank of phase 11(b), under torchrun: cli/train.py's main on
    ``argv`` inside phase 8's probes (the duration head scaled as phase 8
    scales it; no profiler), every SCST NW call held to the plain NW
    exactly; writes ``rank<r>.json`` with the records and launches."""
    from scanpaths_tpu_torch.cli import train as train_cli
    from scanpaths_tpu_torch.metrics import device_eval
    from scanpaths_tpu_torch.ops import block, cell, nw
    from scanpaths_tpu_torch.train import trainer as tr
    from scanpaths_tpu_torch.utils import checkpointing as ck
    rank = int(os.environ["RANK"])
    with trainer_probes(cell, block, nw, tr, device_eval, ck,
                        trace=False) as recs, \
            contextlib.redirect_stdout(io.StringIO()):
        before = tracing.launches()
        train_cli.main(argv)
        got = _minus(tracing.launches(), before)
    checked = 0
    for rec in recs:
        for i, (_, _, a, out) in enumerate(rec.pop("nw_calls", [])):
            _exact(f"rank {rank} SCST NW call {i + 1}", out,
                   nw.nw_scores_bins_plain(*a))
            checked += 1
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(dict(rank=rank, records=recs, launches=got,
                       nw_checked=checked), f)


def _state_gap(a, b):
    """(max abs gap, the largest gap past DP_STATE_TOL's bound, its key)
    over two state dicts' float tensors."""
    worst, excess, key = 0.0, -math.inf, None
    for k, va in a.items():
        if not va.is_floating_point():
            continue
        d = (va.double() - b[k].double()).abs()
        e = d - DP_STATE_TOL["rtol"] * b[k].double().abs()
        worst = max(worst, float(d.max()))
        if float(e.max()) > excess:
            excess, key = float(e.max()), k
    return worst, excess, key


def _dp_call(root, label, world, job, env=None):
    """One torchrun call of dp_steps_worker on ``world`` ranks with
    ``job``: (its out dir, every rank's result, its wall seconds)."""
    out = os.path.join(root, label)
    os.makedirs(out)
    path = os.path.join(out, "job.json")
    with open(path, "w") as f:
        json.dump(job, f)
    t0 = time.perf_counter()
    _torchrun(world, ["--dp-steps", out, path], env=env)
    return (out, [_rank_out(out, r) for r in range(world)],
            time.perf_counter() - t0)


def _metric_gaps(got, want):
    """{metric: largest relative gap} of two step-metric lists, and the
    first step's gradient-norm gap apart (``grad_norm_first``)."""
    rel = {}
    for i, (g, w) in enumerate(zip(got, want)):
        if set(g) != set(w):
            raise AssertionError(f"step {i}: metric keys")
        for k in w:
            key = "grad_norm_first" if (k, i) == ("grad_norm", 0) else k
            rel[key] = max(rel.get(key, 0.0), abs(g[k] - w[k])
                           / max(abs(w[k]), 1e-30))
    return rel


def _dp_bound(key):
    return {"grad_norm_first": DP_FIRST_GRAD_NORM_RTOL,
            "grad_norm": DP_GRAD_NORM_RTOL}.get(key, DP_METRIC_RTOL)


def check_dp_steps(tmp, test_argv, smi, phase7_ms, phase8):
    """Phase 11(a), (a'), (c) and (d).  (a): the steps of dp_steps_worker
    on one rank over NCCL and on two ranks sharing the card over gloo,
    from the same weights and global batches; (d): the same steps on a
    1 x 2 mesh (``--model_parallel 2``, the TP state), then one eval
    forward of the seed weights on the first batch through the kernels
    (the sliced kernels gathered whole) against world 1's.  Every metric
    within DP_METRIC_RTOL (the gradient norm: the first step's within
    DP_FIRST_GRAD_NORM_RTOL, the later ones' within DP_GRAD_NORM_RTOL),
    the parameters and BN running statistics after the first step within
    DP_STATE_TOL, no cell or stage launch in a step, 2 NW launches a SCST
    step and stream on each rank, each held to the plain NW exactly; each
    forward 16 cell and 3 stage launches on each rank, each held to its
    plain version, its outputs within F32_TOL of world 1's.  (a'): OSIE's
    steps under torch.use_deterministic_algorithms, twice in one world-1
    process and once on two ranks: the gaps printed, and the ops that warn
    named.  (c): cli/test.py --device_eval true on two ranks on phase 8's
    OSIE and AiR runs against phase 8's single-process cli/test.py on the
    same runs and seed: at least 99% of rollouts' actions equal, every
    metric and std within rtol 1e-3, each rank's launches its rows'.
    Returns the launches of the workers."""
    root = os.path.join(tmp, "dp_steps")
    os.makedirs(root)
    argv = {t: test_argv[t] for t in DP_TASKS}
    total = dict.fromkeys(tracing.KERNELS, 0)

    def add(counts):
        for k in total:
            total[k] += counts[k]
    tests = [phase8[t]["test_argv"] for t in DP_TASKS]
    # two calls, so each process's start and warm-up is paid once: world
    # 1 (the steps and forwards, then OSIE's steps twice under the
    # deterministic algorithms), and two ranks sharing the card (the
    # data-parallel steps, deterministic, then the TP steps, forwards and
    # cli/test.py over the ranks); cuBLAS's deterministic workspace is
    # set for both
    det = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    out1, w1c, s1 = _dp_call(root, "world1", 1, dict(argv=argv, runs=[
        dict(tasks=DP_TASKS, forward=True),
        dict(tasks=["osie"], deterministic=True, repeat=2)]), env=det)
    out2, w2c, s2 = _dp_call(root, "world2", 2, dict(argv=argv, runs=[
        dict(tasks=DP_TASKS, deterministic=True),
        dict(tasks=DP_TASKS, model_parallel=2, forward=True, test=tests)]),
        env=det)

    def runs(ranks, i):
        return [dict(r["runs"][i], **{k: r[k] for k in (
            "rank", "world", "backend", "device", "note")}) for r in ranks]
    (w1,), (d1,), w2, wt = (runs(w1c, 0), runs(w1c, 1), runs(w2c, 0),
                            runs(w2c, 1))
    out1, outd1, out2, outt = (os.path.join(out1, "run0"),
                               os.path.join(out1, "run1"),
                               os.path.join(out2, "run0"),
                               os.path.join(out2, "run1"))
    # one rank on its card talks NCCL, two sharing it gloo (on the CPU,
    # where a rehearsal runs, all gloo)
    if w1["backend"] != ("nccl" if DEVICE == "cuda" else "gloo") or \
            any(r["backend"] != "gloo" for r in w2 + wt):
        raise AssertionError(f"backends {w1['backend']}, "
                             f"{[r['backend'] for r in w2 + wt]}")
    print(f"[dp] world 1: {w1['device']} over {w1['backend']}; world 2 and "
          f"the 1 x 2 TP mesh: {w2[0]['device']}, {w2[1]['device']} over "
          f"{w2[0]['backend']}"
          + (f" ({w2[0]['note']})" if w2[0]["note"] else "")
          + f"; torchrun calls {s1:.1f} s (world 1: the steps, forwards "
          f"and the deterministic repeats) and {s2:.1f} s (two ranks: the "
          "deterministic data-parallel steps, the TP steps, forwards and "
          "two cli/test runs) wall", flush=True)
    for task in DP_TASKS:
        want = w1["tasks"][task]
        streams = 2 if task == "air" else 1
        nw_want = DP_STEPS * (2 * streams + 2 * want["apply_cd"])
        for r in [w1] + w2 + wt:
            got = r["tasks"][task]
            add(got["launches"])
            _expect(f"{task} steps, world {r['world']} (model parallel "
                    f"{r['model_parallel']}) rank {r['rank']}",
                    got["launches"], {"cell_step": 0, "stage_apply": 0,
                                      "nw_scores_bins": nw_want,
                                      "cond_head": 0, "cond_compose": 0})
            if got["nw_checked"] != nw_want:
                raise AssertionError(f"{task}: {got['nw_checked']} NW calls "
                                     "checked")
        for label, ranks, out in (("world 2 (deterministic)", w2, out2),
                                  ("TP 1 x 2", wt, outt)):
            rel = {}
            for r in ranks:
                for k, v in _metric_gaps(r["tasks"][task]["metrics"],
                                         want["metrics"]).items():
                    rel[k] = max(rel.get(k, 0.0), v)
            worst = max(rel, key=lambda k: rel[k] / _dp_bound(k))
            gaps = {name: _state_gap(
                torch.load(os.path.join(out, f"{name}.pt")),
                torch.load(os.path.join(out1, f"{name}.pt")))
                for name in (f"{task}_first", task)}
            gap, excess, key = gaps[f"{task}_first"]
            print(f"[dp] {task} {label} against world 1: {DP_STEPS} "
                  f"supervised steps at batch {want['rows'][0]} and "
                  f"{DP_STEPS} SCST steps at batch {want['rows'][1]} (x "
                  f"{_train_args(argv[task]).rl_sample_number} rollouts), "
                  f"{want['params'] / 1e6:.1f} M parameters: largest "
                  f"relative gap {rel[worst]:.3g} ({worst}; rtol "
                  f"{_dp_bound(worst)}): "
                  + ", ".join(f"{k} {v:.2g}" for k, v in sorted(rel.items()))
                  + "; grad_norm by step, world 1 / " + label + ": "
                  + ", ".join(f"{w['grad_norm']:.6g}/{g['grad_norm']:.6g}"
                              for w, g in zip(want["metrics"],
                                              ranks[0]["tasks"][task][
                                                  "metrics"]))
                  + f"; parameters and BN running statistics after the "
                  f"first step: largest abs gap {gap:.3g}, largest excess "
                  f"over rtol {DP_STATE_TOL['rtol']} {excess:.3g} ({key}; "
                  f"atol {DP_STATE_TOL['atol']}); after the last: largest "
                  f"abs gap {gaps[task][0]:.3g}, largest excess "
                  f"{gaps[task][1]:.3g} ({gaps[task][2]}; reported)",
                  flush=True)
            if rel[worst] > _dp_bound(worst):
                raise AssertionError(f"{task} {label}: metric {worst} off "
                                     f"by {rel[worst]:.3g}")
            if excess > DP_STATE_TOL["atol"]:
                raise AssertionError(f"{task} {label}: state {key} off by "
                                     f"{excess:.3g} past rtol")
        w2t, wtt = ([r["tasks"][task] for r in ranks] for ranks in (w2, wt))
        print(f"[dp] {task} step ms, {smi}: world 1 (one rank, "
              f"{w1['backend']}) " + ", ".join(f"{v:.1f}" for v in
                                               want["step_ms"])
              + "; two ranks sharing one card over gloo (not a scaling "
              "number): world 2 (deterministic algorithms) rank 0 "
              + ", ".join(f"{v:.1f}" for v in w2t[0]["step_ms"])
              + ", rank 1 " + ", ".join(f"{v:.1f}" for v in w2t[1]["step_ms"])
              + "; TP 1 x 2 rank 0 "
              + ", ".join(f"{v:.1f}" for v in wtt[0]["step_ms"])
              + ", rank 1 " + ", ".join(f"{v:.1f}" for v in wtt[1]["step_ms"])
              + " (supervised steps, then SCST); the gradient all-reduce "
              f"inside a world-2 step ({want['params'] * 4 / 1e6:.1f} MB "
              "f32), rank 0: "
              + ", ".join(f"{v:.2f}" for v in w2t[0]["reduce_ms"]) + " ms"
              + (f" (world 1 calls none: {want['reduce_ms']})"
                 if want["reduce_ms"] else " (world 1 calls none)"),
              flush=True)
        if task == "osie":
            print(f"[dp] osie supervised step at batch {want['rows'][0]}, "
                  f"{smi}: world 1 under torchrun (NCCL group, the "
                  f"single-card path) step 2 {want['step_ms'][1]:.1f} ms "
                  f"against phase 7's single process, steps 2-"
                  f"{TRAIN_STEPS} {phase7_ms:.1f} ms "
                  f"({100 * (want['step_ms'][1] / phase7_ms - 1):+.1f}%)",
                  flush=True)
        # the TP eval forward against world 1's
        ref = torch.load(os.path.join(out1, f"{task}_forward.pt"))
        got = torch.load(os.path.join(outt, f"{task}_forward.pt"))
        errs = {k: _close(f"{task} TP eval forward {k}", got[k], ref[k],
                          F32_TOL, scaled=True) for k in ref}
        for r in [w1] + wt:
            fw = r["tasks"][task]["forward"]
            add(fw["launches"])
            _expect(f"{task} eval forward, model parallel "
                    f"{r['model_parallel']} rank {r['rank']}",
                    fw["launches"], {"cell_step": SEQ, "stage_apply": 3,
                                     "nw_scores_bins": 0,
                                     "cond_head": SEQ * streams,
                                     "cond_compose": 1})
        print(f"[dp] {task} TP eval forward (1 x 2 mesh, the sliced "
              f"kernels gathered whole) of the first batch against world "
              f"1's: max abs err " + ", ".join(f"{k} {v:.3g}"
                                               for k, v in errs.items())
              + f" (F32_TOL {F32_TOL}, scaled); each rank "
              f"{SEQ} cell and 3 stage launches, each call held to its "
              "plain version, largest err rank 0 "
              + ", ".join(f"{k} {v:.3g}" for k, v in
                          wt[0]["tasks"][task]["forward"]["errs"].items())
              + ", rank 1 "
              + ", ".join(f"{k} {v:.3g}" for k, v in
                          wt[1]["tasks"][task]["forward"]["errs"].items()),
              flush=True)
    # (a'): determinism
    det_runs = d1["tasks"]["osie"]["reps"]
    rep = _metric_gaps(det_runs[1]["metrics"], det_runs[0]["metrics"])
    rep_state = {n: _state_gap(
        torch.load(os.path.join(outd1, f"osie_1{n}.pt")),
        torch.load(os.path.join(outd1, f"osie_0{n}.pt")))[0]
        for n in ("_first", "")}
    split = {}
    for r in w2:
        for k, v in _metric_gaps(r["tasks"]["osie"]["metrics"],
                                 det_runs[0]["metrics"]).items():
            split[k] = max(split.get(k, 0.0), v)
    split_state = {n: _state_gap(
        torch.load(os.path.join(out2, f"osie{n}.pt")),
        torch.load(os.path.join(outd1, f"osie_0{n}.pt")))[0]
        for n in ("_first", "")}
    for run in det_runs:
        add(run["launches"])
    warned = sorted(set(d1["warned"]) | {w for r in w2 for w in r["warned"]})
    print(f"[dp] osie steps under torch.use_deterministic_algorithms "
          f"(warn_only; CUBLAS_WORKSPACE_CONFIG=:4096:8; cudnn "
          f"deterministic), {smi}: world 1 twice from the same state in one "
          f"process: largest relative metric gap "
          + ", ".join(f"{k} {v:.3g}" for k, v in sorted(rep.items()))
          + f"; state largest abs gap after the first step "
          f"{rep_state['_first']:.3g}, after the last {rep_state['']:.3g}"
          + f"; world 2 against it (the batch split alone, if world 1 "
          f"repeats): "
          + ", ".join(f"{k} {v:.3g}" for k, v in sorted(split.items()))
          + f"; state after the first step {split_state['_first']:.3g}, "
          f"after the last {split_state['']:.3g}; ops without a "
          f"deterministic implementation: {warned or 'none'}", flush=True)
    # (c): cli/test.py over two ranks against phase 8's single process
    for i, task in enumerate(DP_TASKS):
        ref = phase8[task]["test"]
        streams = 2 if task == "air" else 1
        forwards = -(-VALIDATION_IMAGES // TEST_BATCH)
        for r in wt:
            t = r["tests"][i]
            add(t["launches"])
            _expect(f"{task} cli/test.py over two ranks, rank {r['rank']}",
                    t["launches"], {
                        "cell_step": SEQ * forwards,
                        "stage_apply": 3 * forwards,
                        "nw_scores_bins": (2 + 2 * REPEATS * streams)
                        * forwards,
                        "cond_head": SEQ * forwards * streams,
                        "cond_compose": 1})
        t0, t1 = (r["tests"][i] for r in wt)
        if t1["records"] or len(t0["records"]) != len(ref["records"]):
            raise AssertionError(f"{task} records: rank 0 "
                                 f"{len(t0['records'])}, rank 1 "
                                 f"{len(t1['records'])}, one process "
                                 f"{len(ref['records'])}")
        same = sum(a["X"] == b["X"] and a["Y"] == b["Y"]
                   for a, b in zip(t0["records"], ref["records"]))
        share = same / len(ref["records"])
        rel = {}

        def walk(g, w, path):
            for k in w:
                if isinstance(w[k], dict):
                    walk(g[k], w[k], path + [k])
                else:
                    rel["-".join(path + [k])] = abs(g[k] - w[k]) / max(
                        abs(w[k]), 1e-30)
        for tree in ("metrics", "stds"):
            for r in wt:
                walk(r["tests"][i][tree], ref[tree], [tree])
        worst = max(rel, key=rel.get)
        print(f"[dp] {task} cli/test.py --device_eval true over two ranks "
              f"sharing one card (gloo) on phase 8's run, against the "
              f"single process on the same run and seed: {same} of "
              f"{len(ref['records'])} rollouts' actions equal ({share:.2%}),"
              f" largest relative gap of the metrics and stds {rel[worst]:.3g}"
              f" ({worst}); wall {t0['wall']:.1f} s (one process "
              f"{ref['wall']:.1f} s); launches rank 0 {t0['launches']}, "
              f"rank 1 {t1['launches']}", flush=True)
        if share < 0.99 or rel[worst] > 1e-3:
            raise AssertionError(f"{task} cli/test.py over two ranks: "
                                 f"{share:.2%} actions equal, {worst} off "
                                 f"by {rel[worst]:.3g}")
        shutil.rmtree(phase8[task]["root"])
    bad = {k: v for k, v in split.items() if v > _dp_bound(k)}
    if bad:
        raise AssertionError(f"deterministic world 2 against world 1: {bad}")
    shutil.rmtree(root)
    return total


def check_dp_run(tmp, phase8):
    """Phase 11(b): cli/train.py under torchrun on two ranks sharing the
    card (gloo) with phase 8's OSIE split and flags (written again from
    seed 0) and --mesh_size 0.  Checks the artifacts (written once, by
    rank 0), the record's iteration and every lr scalar against phase 8's
    single-process run exactly, its supervised losses (the first step
    within DP_METRIC_RTOL, every step within DP_RUN_DRIFT_RTOL), each
    rank's launches (both validate their rows: 16 cell and 3 stage a
    validation forward, NW for the rows each counts, as phase 8's per
    batch), every SCST NW call exact on both ranks; prints the SCST
    scalars beside phase 8's.  Returns the workers' launches."""
    argv = write_trainer_split(tmp, "osie")
    args = _train_args(argv)
    log_root = argv[argv.index("--log_root") + 1]
    out = os.path.join(tmp, "dp_run")
    os.makedirs(out)
    t0 = time.perf_counter()
    _torchrun(2, ["--dp-train", out, "--", *argv, "--mesh_size", "0"])
    secs = time.perf_counter() - t0
    ranks = [_rank_out(out, r) for r in range(2)]
    sup_steps = TRAINER_IMAGES * TEST_SUBJECTS["osie"] // args.batch
    rl_steps = TRAINER_IMAGES // max(args.batch // 4, 1)
    val_forwards = -(-VALIDATION_IMAGES // args.batch)
    for r in ranks:
        check_trainer_launches("osie", f"data parallel rank {r['rank']}",
                               r["records"], 1, args.eval_repeat_num,
                               val_forwards, rl_steps,
                               args.apply_consistency_divergence)
    kinds = [r["kind"] for r in ranks[1]["records"]]
    if kinds != ["human", "epoch", "validation", "epoch", "validation"]:
        raise AssertionError(f"rank 1 ran {kinds}")
    for r in ranks:
        if r["nw_checked"] != 2 * rl_steps:
            raise AssertionError(f"rank {r['rank']}: {r['nw_checked']} SCST "
                                 "NW calls checked")
    log_dir = _run_dir(log_root)
    record, scalars = check_run("osie", log_dir)
    twice = {(t, s) for t, by in scalars.items() for s, v in by.items()
             if len(v) != 1}
    with open(os.path.join(log_dir, "log_train.txt")) as f:
        heads = f.read().count("The args corresponding")
    if twice or heads != 1:
        raise AssertionError(f"written more than once: {sorted(twice)[:5]}, "
                             f"{heads} argument listings")
    if (record["epoch"], record["iteration"]) != \
            (phase8["record"]["epoch"], phase8["record"]["iteration"]):
        raise AssertionError(f"record {record}, phase 8 {phase8['record']}")
    if scalars["learning_rate"] != phase8["scalars"]["learning_rate"]:
        raise AssertionError("lr scalars differ from phase 8's")
    by_step = {}
    for tag in ("loss/loss", "loss/loss_actions", "loss/loss_duration"):
        want = phase8["scalars"][tag]
        if sorted(scalars[tag]) != sorted(want):
            raise AssertionError(f"{tag} steps differ from phase 8's")
        by_step[tag] = [abs(scalars[tag][s][0] - want[s][0])
                        / abs(want[s][0]) for s in sorted(want)]
    first = {k: v[0] for k, v in by_step.items()}
    rel = {k: max(v) for k, v in by_step.items()}
    print(f"[dp] torchrun --nproc_per_node 2: cli/train.py's main --task "
          f"osie --mesh_size 0 (two ranks sharing one card over gloo, "
          f"phase 8's split and flags, --batch {args.batch} global): "
          f"{secs:.1f} s wall; artifacts once, by rank 0; record "
          f"{record['epoch']}/{record['iteration']} and all "
          f"{len(scalars['learning_rate'])} lr scalars equal to phase 8's; "
          f"{sup_steps} supervised steps' losses against phase 8's single "
          f"process: the first step's relative gap "
          + ", ".join(f"{k} {v:.3g}" for k, v in first.items())
          + f" (rtol {DP_METRIC_RTOL}), the largest over the steps "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
          + f" (rtol {DP_RUN_DRIFT_RTOL}; loss/loss by step "
          + ", ".join(f"{v:.2g}" for v in by_step["loss/loss"])
          + f"); launches rank 0 {ranks[0]['launches']},"
          f" rank 1 {ranks[1]['launches']}; {ranks[0]['nw_checked']} + "
          f"{ranks[1]['nw_checked']} SCST NW calls held to the plain NW "
          "exactly", flush=True)
    for rec in ranks[0]["records"]:
        if rec["kind"] == "epoch":
            st = rec["stats"]
            print(f"[dp] rank 0 epoch {st['epoch']} "
                  f"({'SCST' if rec['rl'] else 'supervised'}): "
                  f"{st['steps']} steps in {st['seconds']:.2f} s, "
                  f"{st['steps_per_sec']:.3f} steps/s steady "
                  f"({st['steps_per_sec'] * st['images_per_step']:.2f} "
                  "images/s, two ranks sharing one card over gloo); peak "
                  f"allocated {_mib(rec['peak']):.0f} MiB", flush=True)
        elif rec["kind"] == "validation":
            print(f"[dp] rank 0 validation (device sweep): "
                  f"{rec['wall']:.2f} s wall; launches {rec['launches']}",
                  flush=True)
    first_rl = phase8["record"]["iteration"] - rl_steps + 1
    for tag in ("rl_loss", "reward_hmean"):
        print(f"[dp] SCST {tag} by step, data parallel against phase 8 (not "
              "asserted: the rollouts may part once the weights differ in "
              "the last bits): " + ", ".join(
                  f"{scalars[tag][s][0]:.5g}/{phase8['scalars'][tag][s][0]:.5g}"
                  for s in range(first_rl, first_rl + rl_steps)), flush=True)
    bad = {k: v for k, v in first.items() if not v <= DP_METRIC_RTOL}
    bad.update({k: v for k, v in rel.items() if not v <= DP_RUN_DRIFT_RTOL})
    if bad:
        raise AssertionError(f"data-parallel supervised losses: {bad}")
    shutil.rmtree(os.path.dirname(log_root))
    shutil.rmtree(out)
    total = dict.fromkeys(tracing.KERNELS, 0)
    for r in ranks:
        for k in total:
            total[k] += r["launches"][k]
    return total


def run_dp_slice(tmp, test_argv, phase7_ms, phase8, smi):
    """Phase 11: check_dp_steps, then check_dp_run.  Returns the kernels'
    launches of the phase's workers."""
    t0 = time.perf_counter()
    total = check_dp_steps(tmp, test_argv, smi, phase7_ms, phase8)
    print(f"[dp] steps, forwards, determinism and cli/test.py over ranks: "
          f"{time.perf_counter() - t0:.1f} s wall", flush=True)
    for k, v in check_dp_run(tmp, phase8["osie"]).items():
        total[k] += v
    return total


# ---------------------------------------------------------------------------
# phase 12: the measuring tools
# ---------------------------------------------------------------------------

TOOL_ITERS = 5


def run_tools_slice(cell, block, nw, tmp):
    """Phase 12: the port's measuring tools (scanpaths_tpu_torch/tools/),
    called in this process at full width: bench_steps' nw, sup and rl
    sections, bench_serving live at batches 1 and 8 and on phase 10's
    float32 greedy OSIE bundle, profile_bench at batch 8 in bfloat16 and
    float32, and bench_train sup 16 with and without --bf16_moments.
    Each prints its JSON lines (finite, every MFU under 1.0, or the tool
    raises); the NW kernel's max abs error against its plain version
    must be 0.  Returns the kernels' launches of the phase."""
    import types

    from scanpaths_tpu_torch.tools import (bench_serving, bench_steps,
                                          bench_train, common,
                                          profile_bench)
    geo = dict(common.FULL)
    before = tracing.launches()
    recs = bench_steps.bench_nw("cuda", iters=TOOL_ITERS)
    if recs[-1]["value"] != 0.0 or not recs[-1]["nan_in_same_places"]:
        raise AssertionError(f"bench_steps nw: {recs[-1]}")
    bench_steps.bench_sup("cuda", geo, iters=TOOL_ITERS)
    bench_steps.bench_rl("cuda", geo, iters=TOOL_ITERS)
    torch.cuda.empty_cache()
    bench_serving.run("cuda", geo, torch.float32, (1, 8), iters=10)
    bench_serving.run("cuda", bundle=os.path.join(tmp, "bundles", "osie"),
                      iters=10)
    for dtype in (torch.bfloat16, torch.float32):
        profile_bench.run("cuda", geo, dtype, 8, iters=10)
    torch.cuda.empty_cache()
    for bf16 in (False, True):
        flags = types.SimpleNamespace(device="cuda", dtype="bfloat16",
                                      bf16_moments=bf16, iters=TOOL_ITERS)
        bench_train.bench_sup(flags, geo, 16)
        torch.cuda.empty_cache()
    got = _minus(tracing.launches(), before)
    if not all(got.values()):
        raise AssertionError(f"tools: launches {got}")
    print(f"[tools] launches {got}", flush=True)
    return got


# ---------------------------------------------------------------------------
# phase 13: the entry points and tools II
# ---------------------------------------------------------------------------

DRYRUN_RANKS = 2


def check_entry(cell, block, nw):
    """Phase 13(a): entry()'s fn(state, images) at full geometry, once
    warm and once timed with CUDA events: the output shapes, finite
    values, 16 cell and 3 stage launches a call; then, at input scale
    COMPARE_SCALE, each kernel call held to its plain version on the same
    inputs and the outputs to the plain forward's.  Returns the launches
    of the two driven calls."""
    from scanpaths_tpu_torch import entry
    fn, (state, images) = entry.entry()
    first = tracing.launches()
    fn(state, images)
    torch.cuda.synchronize()
    before = tracing.launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(state, images)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    driven = _minus(tracing.launches(), first)
    got = _minus(tracing.launches(), before)
    # the warm call composed for the state's one weight version
    _expect("entry() forward", got, {"cell_step": SEQ, "stage_apply": 3,
                                     "nw_scores_bins": 0, "cond_head": SEQ,
                                     "cond_compose": 0})
    n, mh, mw = images.shape[0], images.shape[1] // 8, images.shape[2] // 8
    want = {"all_actions_prob": (n, SEQ, 1 + mh * mw),
            "log_normal_mu": (n, SEQ), "log_normal_sigma2": (n, SEQ),
            "action_map": (n, SEQ, mh, mw)}
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if shapes != want or not all(bool(torch.isfinite(v).all())
                                 for v in out.values()):
        raise AssertionError(f"entry() forward: {shapes}, finite "
                             f"{[bool(torch.isfinite(v).all()) for v in out.values()]}")
    gen = torch.Generator(device=images.device).manual_seed(3)
    x = COMPARE_SCALE * torch.randn(images.shape, generator=gen,
                                    device=images.device)
    with checking_kernels(cell, block, "entry() forward") as errs:
        out_k = fn(state, x)
    with mock.patch.object(cell, "cell_step", cell.cell_step_plain), \
            mock.patch.object(block, "stage_apply", block.stage_apply_plain):
        out_p = fn(state, x)
    torch.cuda.synchronize()
    gaps = {k: _close(f"entry() forward {k} at scale {COMPARE_SCALE}",
                      out_k[k], out_p[k], F32_TOL, scaled=True)
            for k in out_k}
    print(f"[entry] entry() fn(state, images) N={n} {8 * mh}x{8 * mw} "
          f"T={SEQ} "
          f"float32: {ms:.2f} ms (CUDA events, the call after a warm one); "
          f"launches a call {got}; outputs {shapes}, finite; at input scale "
          f"{COMPARE_SCALE} each kernel call against its plain version: "
          + ", ".join(f"{k} {len(v)} calls, max abs err {max(v):.3g}"
                      for k, v in errs.items())
          + "; outputs against the plain forward: "
          + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items()), flush=True)
    del fn, state, out, out_k, out_p
    torch.cuda.empty_cache()
    return driven


def check_dryrun(n):
    """Phase 13(b): dryrun_multichip(n) on the card (n ranks sharing it
    over gloo): its lines, and the launches its ranks report (training
    steps launch no cell or stage kernel; each rank's SCST step 2 NW)."""
    import re
    from scanpaths_tpu_torch import entry
    out = entry.dryrun_multichip(n)
    lines = [line for line in out.splitlines() if line.startswith("dryrun")]
    m = re.search(r"dryrun kernel launches over the \d+ ranks: (\{.*\})",
                  out)
    if len(lines) != 4 or m is None:
        raise AssertionError(f"dryrun_multichip({n}): {out[-3000:]}")
    got = json.loads(m.group(1))
    _expect(f"dryrun_multichip({n})", got, {
        "cell_step": 0, "stage_apply": 0, "nw_scores_bins": 2 * n,
        "cond_head": 0, "cond_compose": 0})
    return got


def check_dist_smoke(tmp):
    """Phase 13(c): tools.dist_smoke, 2 nodes x 2 ranks sharing the card
    over gloo, against one process (the tool checks the ranks' places and
    the losses and gradient norms at its card bounds, dist_smoke.RTOL);
    the supervised steps launch no kernel."""
    from scanpaths_tpu_torch.tools import dist_smoke
    r = dist_smoke.launch(os.path.join(tmp, "dist_smoke"), "cuda")
    shutil.rmtree(os.path.join(tmp, "dist_smoke"))
    print("[entry] dist_smoke, 2 nodes x 2 ranks on the one card: (RANK, "
          "LOCAL_RANK, device, backend) "
          + ", ".join(f"({x['rank']}, {x['local_rank']}, {x['device']}, "
                      f"{x['backend']})" for x in r["ranks"])
          + "; " + "; ".join(
              f"{k} {r['ranks'][0][k]} against one process's "
              f"{r['single'][k]}, relative gaps {r['gap'][k]} (bounds "
              f"{dist_smoke.RTOL['cuda'][k]}: the first step, every step)"
              for k in r["gap"]), flush=True)


def check_real_data(cell, block, nw, tmp):
    """Phase 13(d): tools.real_data_smoke --task osie at full width on a
    synthesized OSIE release (tools/synth.py::make_osie_release: 9
    train/validation and 2 test images of 800x600, 4 subjects each) with
    a checkpoint_best.pth of seed weights in the reference layout in the
    released one's place: 2 steps, --device_eval true.  It must exit 0,
    load the checkpoint and write records in the reference schema.
    Returns its launches."""
    from scanpaths_tpu_torch.models import port
    from scanpaths_tpu_torch.models.scanpath_model import (ScanpathModel,
                                                           init_weights)
    from scanpaths_tpu_torch.tools import real_data_smoke, synth
    root = os.path.join(tmp, "real_data")
    synth.make_osie_release(root, np.random.default_rng(0))
    model = ScanpathModel("osie")
    init_weights(model, 0)
    torch.save({"model": port.to_reference_state_dict(
        model.state_dict(), "osie", 30, 40)},
        os.path.join(root, "osie", "checkpoint_best.pth"))
    del model
    out = os.path.join(tmp, "real_data.json")
    before = tracing.launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = real_data_smoke.main([
            "--root", root, "--task", "osie", "--steps", "2",
            "--device_eval", "true", "--device", "cuda", "--workdir",
            os.path.join(tmp, "real_data_work"), "--out", out])
    secs = time.perf_counter() - t0
    got = _minus(tracing.launches(), before)
    with open(out) as f:
        (rep,) = json.load(f)["tasks"]
    ck = rep.get("released_checkpoint", {})
    if rc != 0 or rep.get("predict_schema_ok") is not True or \
            not ck.get("ok") or rep.get("train_steps") != 2 or \
            not all(got.values()) or not all(
                math.isfinite(rep.get(k, math.nan)) for k in (
                    "loss_first", "loss_last",
                    "validation_selection_metric")):
        raise AssertionError(f"real_data_smoke: rc {rc}, {rep}, launches "
                             f"{got}")
    print(f"[entry] real_data_smoke --task osie, full width: exit {rc} in "
          f"{secs:.1f} s; preprocess {rep['preprocess_records']}; released "
          f"checkpoint loaded ({ck['ported_params']} parameters, "
          f"{ck['geometry']}); {rep['train_steps']} steps, loss "
          f"{rep['loss_first']} (the mean of the steps, finite); validation "
          f"metric "
          f"{rep['validation_selection_metric']}; "
          f"{rep['predict_artifact']} predict_schema_ok "
          f"{rep['predict_schema_ok']}; launches {got}", flush=True)
    shutil.rmtree(root)
    shutil.rmtree(os.path.join(tmp, "real_data_work"))
    torch.cuda.empty_cache()
    return got


PROFILE_TIMEOUT = 300  # s, the profile_scan process


def check_profile_scan(smi):
    """Phase 13(e): ``python -m scanpaths_tpu_torch.tools.profile_scan``
    at batch BATCH, full width, float32 and bfloat16, in a process of its
    own (a fresh profiler: in this long process the trace has lost device
    events): each variant's line finite (the tool raises otherwise), each
    loop's trace passing the tool's check (a cell-kernel event a step,
    the device time within the span), 16 cell launches a loop of a
    variant and 3 stage launches (the hoisted inputs) a dtype, as the
    tool's records count them.  Returns the launches."""
    import signal
    from scanpaths_tpu_torch.tools import profile_scan
    cmd = [sys.executable, "-m", "scanpaths_tpu_torch.tools.profile_scan",
           "--batch", str(BATCH), "--iters", str(TOOL_ITERS)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            cwd=os.path.dirname(SCRIPT),
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=PROFILE_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"profile_scan passed {PROFILE_TIMEOUT} s:\n"
                             f"{out[-4000:]}")
    recs = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    if proc.returncode or [r["dtype"] for r in recs] != ["float32",
                                                          "bfloat16"]:
        raise AssertionError(f"profile_scan exited {proc.returncode}:\n"
                             f"{out[-4000:]}")
    total = dict.fromkeys(tracing.KERNELS, 0)
    for rec in recs:
        loops = len(profile_scan.VARIANTS) * rec["loops_per_variant"]
        # the head runs in two of the variants, cell+head and full; the
        # hoist composes once
        _expect(f"profile_scan {rec['dtype']}", rec["launches"], {
            "cell_step": SEQ * loops, "stage_apply": 3,
            "nw_scores_bins": 0,
            "cond_head": 2 * SEQ * rec["loops_per_variant"],
            "cond_compose": 1})
        bad = {k: v for k, v in rec["trace"].items() if v != "ok"}
        if bad:
            raise AssertionError(f"profile_scan {rec['dtype']}: the trace "
                                 f"cannot give the busy share: {bad}")
        for k in total:
            total[k] += rec["launches"][k]
        print(f"[entry] profile_scan {rec['dtype']} batch {BATCH}: ms a "
              "step " + ", ".join(f"{k} {v:.3f}" for k, v in
                                  rec["ms_per_step"].items())
              + "; busy share " + ", ".join(
                  f"{k} {v:.3f}" for k, v in rec["busy_share"].items())
              + f" (every trace checked); launches {rec['launches']}; "
              f"{smi}", flush=True)
    return total


def run_entry_slice(cell, block, nw, tmp, smi):
    """Phase 13: check_entry, check_dryrun, check_dist_smoke,
    check_real_data and check_profile_scan in turn, each with its wall
    time.  Returns the kernels' launches of the phase."""
    total = dict.fromkeys(tracing.KERNELS, 0)
    for label, run in (
            ("entry()", lambda: check_entry(cell, block, nw)),
            (f"dryrun_multichip({DRYRUN_RANKS})",
             lambda: check_dryrun(DRYRUN_RANKS)),
            ("dist_smoke", lambda: check_dist_smoke(tmp)),
            ("real_data_smoke", lambda: check_real_data(cell, block, nw,
                                                         tmp)),
            ("profile_scan", lambda: check_profile_scan(smi))):
        t0 = time.perf_counter()
        got = run()
        for k, v in (got or {}).items():
            total[k] += v
        print(f"[entry] {label}: {time.perf_counter() - t0:.1f} s wall; "
              f"{_memory()}", flush=True)
    print(f"[entry] launches {total}", flush=True)
    return total


def print_ptxas(log):
    """One line per compiled kernel from ptxas -v: its name with template
    arguments, registers, spills and shared memory.  Raises if the
    float32 cell kernel spills."""
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
            if name.startswith("cell_f32") and \
                    "0 bytes spill stores, 0 bytes spill loads" not in spill:
                raise AssertionError(f"{name} spills: {spill}")
            name = None


def _memory():
    """The host's available memory, this process's resident set and the
    use of the temporary directory's filesystem, in GiB (/proc and
    statvfs)."""
    with open("/proc/meminfo") as f:
        info = {k: int(v.split()[0]) / 2**20 for k, v in
                (line.split(":", 1) for line in f)}
    with open("/proc/self/status") as f:
        rss = next(int(line.split()[1]) for line in f
                   if line.startswith("VmRSS")) / 2**20
    tmp = tempfile.gettempdir()
    du = shutil.disk_usage(tmp)
    return (f"host {info['MemAvailable']:.1f} of {info['MemTotal']:.1f} GiB "
            f"available, this process {rss:.1f} GiB resident, {tmp} "
            f"{du.used / 2**30:.1f} of {du.total / 2**30:.1f} GiB used")


def _phase(name, t0):
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f} s wall; "
          f"{_memory()}", flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    if len(sys.argv) > 1:
        # one rank of phase 11, started by _torchrun
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        mode, out = sys.argv[1:3]
        if mode == "--dp-steps":
            dp_steps_worker(out, sys.argv[3])
        elif mode == "--dp-train" and sys.argv[3] == "--":
            dp_train_worker(out, sys.argv[4:])
        else:
            raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}")
        return
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

    launches = dict.fromkeys(tracing.KERNELS, 0)

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
        phase7_ms = {}
        for task in TASKS:
            t0 = time.perf_counter()
            counts, per_step, sup_batch, sup_ms = run_train_slice(
                cell, block, nw, test_argv[task])
            phase7_ms[task] = sup_ms
            add(counts)
            summary["nw_scores_bins"][f"{task}_ms_per_rl_step"] = per_step
            if task == "osie":
                check_train_parity(test_argv[task], sup_batch)
            _phase(f"training {task}", t0)

        phase8 = {task: {} for task in DP_TASKS}
        for task in TASKS:
            t0 = time.perf_counter()
            add(run_trainer_slice(cell, block, nw,
                                  write_trainer_split(tmp, task),
                                  keep=phase8.get(task)))
            _phase(f"trainer {task}", t0)

        t0 = time.perf_counter()
        counts, joint_run = run_joint_slice(cell, block, nw, tmp)
        add(counts)
        _phase("joint trainer", t0)

        t0 = time.perf_counter()
        add(run_export_slice(cell, block, predict, predictor, tmp, test_argv,
                             joint_run, smi))
        _phase("export", t0)

        t0 = time.perf_counter()
        add(run_dp_slice(tmp, test_argv, phase7_ms["osie"], phase8, smi))
        _phase("data parallel", t0)

        t0 = time.perf_counter()
        add(run_tools_slice(cell, block, nw, tmp))
        _phase("tools", t0)

        # nothing after phase 12 reads the earlier phases' files, and
        # where the temporary directory is in memory they hold host RAM
        # that phase 13's processes need
        for name in os.listdir(tmp):
            path = os.path.join(tmp, name)
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)
        t0 = time.perf_counter()
        add(run_entry_slice(cell, block, nw, tmp, smi))
        _phase("entry points and tools II", t0)

    sources = {"cell_step": ("scanpaths_tpu_torch/csrc/cell.cu",
                             "scanpaths_tpu/ops/pallas_cell.py:218"),
               "stage_apply": ("scanpaths_tpu_torch/csrc/block.cu",
                               "scanpaths_tpu/ops/pallas_block.py:197"),
               "nw_scores_bins": ("scanpaths_tpu_torch/csrc/nw.cu",
                                  "scanpaths_tpu/ops/pallas_nw.py:111"),
               "cond_head": ("scanpaths_tpu_torch/csrc/head.cu", None),
               "cond_compose": ("scanpaths_tpu_torch/csrc/compose.cu", None)}
    # no single PyTorch call computes any of the first three functions (a
    # fused ConvLSTM step, a stage of bottleneck blocks, an NW alignment);
    # the head's library_ms is cuDNN's two convs it replaced, the compose
    # kernel's cuBLAS's product of the bank with the head's 51 columns
    kernels = [dict(name=name, route="cuda", source=sources[name][0],
                    replaces=sources[name][1], launches=launches[name],
                    **{"library_ms": None, **summary[name]})
               for name in sources]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
