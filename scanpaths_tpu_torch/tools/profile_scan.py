"""The decode step split into variants (the port of
``tools/profile_scan.py``).  ``tools/profile_bench.py`` splits the
forward into trunk, hoisted convs, decode and sampling; this tool times
the 16-step decode loop of the OSIE model (seed weights) with parts of
its step body left out, over fixed hoisted inputs, so the loop's time is
shared out among the cell, the signal gates, the fused head and the
history attention:

  cell        the cell kernel alone (``ops.cell.cell_step``) on zero
              signal inputs: the kernel takes one signal stream at
              least, and a zero map adds nothing
  cell+sig    + the signal gates (``lstm``: ``SignalGates.kp`` and the
              kernel's taps) from fixed memories, the first history
              entry's spatial and semantic features
  cell+head   + the fused conditioner+head and the duration tail
              (``apply_fused_cond_head``, which on the card is the head
              kernel, ``ops.head.cond_head`` -> ``csrc/head.cu``, and
              ``head.finish_duration``)
  full        the real step: ``spatial_att`` and ``semantic_att`` over
              the history, the cell, the head, ``_new_stream_entry`` and
              the history writes, the ops of ``ScanpathModel._decode``
              in its order (:func:`scan`)

Differences per step: ``signal`` = cell+sig - cell, ``head`` =
cell+head - cell+sig (the JAX tool's head figure is cell+head - cell,
its signals included), ``history`` = full - cell+head.  The hoisted
inputs (:func:`hoist`) are ``_decode``'s step invariants, computed as
it computes them.  Each variant's time is the median over ``--iters``
loops, each read on the host through a device scalar (TF32 off,
``tools/common.py``); on the card one more loop runs under
torch.profiler, and its busy share is the union of the kernels' device
intervals over the span between CUDA events around it, so a host-bound
loop shows as idle, not as work.  The trace is checked against the
loop's known work first (:func:`trace_problem`: a cell-kernel event a
step, the summed device time within the span); a trace that fails the
check gives no share (null, with the reason under ``trace``), and off
the card nothing is traced (both null).  The same trace gives the head
kernel's device ms a step (``head_kernel_ms_per_step``: its two
kernels, :data:`HEAD_KERNELS`, summed; 0 in the variants without the
head, null off the card).  The record's ``launches`` are the kernels'
launch counts over the whole run.

    python -m scanpaths_tpu_torch.tools.profile_scan [--batch 8]
        [--dtype float32|bfloat16|both] [--iters 5]
        [--device cuda|cpu] [--tiny]

prints one JSON line a dtype (float32, then bfloat16 by default).
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

from . import common

VARIANTS = ("cell", "cell+sig", "cell+head", "full")
WARMUP = 2
# the cell kernels' names in a trace (csrc/cell.cu)
CELL_KERNELS = ("cell_f32", "cell_bf16")
# the head kernel's two kernels in a trace (csrc/head.cu)
HEAD_KERNELS = ("head_part", "head_finish")
# the device events' summed time may pass the span between the CUDA
# events by this share (the two clocks' agreement) and no more
SPAN_SLACK = 0.01


@torch.no_grad()
def hoist(model, images) -> dict:
    """``ScanpathModel._decode``'s step invariants for ``images`` (an
    OSIE model): the trunk's grid through the stage kernels, ``visual``
    and its channel mean, the folded x-gates, the cell's gate kernel and
    the composed conditioner+head."""
    from ..models import resnet
    from ..models.components import conv2d, hwio
    dt = model.dtype
    x = resnet.fused_forward(model.backbone, images, dt)
    k, b = hwio(model.sal_conv)
    visual = F.relu(conv2d(x, k, b, padding=((1, 1), (1, 1)), dtype=dt))
    return {"visual": visual, "vismean": visual.mean(dim=-1),
            "xg": model.lstm.fold_bias(model.xgates(visual)),
            "kh": model.lstm.gate_kernel(),
            "fused": model._fused_heads(None)[0]}


@torch.no_grad()
def scan(model, kind: str, hoisted: dict):
    """One T-step decode of variant ``kind`` over ``hoisted``: returns
    (the steps' (z, mu, sigma2, amap) for the head variants, else [],
    the final h, the final c).  ``full`` is ``_decode``'s step for one
    stream, op for op."""
    from ..models.components import apply_fused_cond_head
    from ..ops import cell as cell_ops
    dt, t_len = model.dtype, model.seq_len
    mh, mw = model.map_h, model.map_w
    visual, vismean = hoisted["visual"], hoisted["vismean"]
    xg, kh, fused = hoisted["xg"], hoisted["kh"], hoisted["fused"]
    n = visual.shape[0]
    amap0 = torch.zeros((n, mh, mw), dtype=dt, device=visual.device)
    entry = model._new_stream_entry(amap0, visual, vismean)
    hist = {key: v.new_zeros((n, t_len + 1) + v.shape[1:])
            for key, v in entry.items()}
    for key, v in entry.items():
        hist[key][:, 0] = v
    fixed = [(entry["spat"].reshape(n, mh, mw), entry["sem"])]
    if kind == "cell":
        zmaps = visual.new_zeros((n, mh, mw, 1))
        zkps = visual.new_zeros((n, 1, 9, 3 * model.embed))
    h, c = torch.zeros_like(visual), torch.zeros_like(visual)
    slots = torch.arange(t_len + 1, device=visual.device)
    outs = []
    for step in range(t_len):
        if kind == "cell":
            h, c = cell_ops.cell_step(h, c, xg, zmaps, zkps, kh)
            continue
        signals = fixed
        if kind == "full":
            valid = slots <= step
            smem = model.spatial_att(hist["spat"], hist["spat_conv"],
                                     entry["spat"], valid)
            cmem = model.semantic_att(hist["sem"], hist["sem_proj"],
                                      entry["sem"], valid)
            signals = [(smem.reshape(n, mh, mw), cmem)]
        h, c = model.lstm(xg, h, c, signals, kh)
        if kind == "cell+sig":
            continue
        stop_logit, amap, d = apply_fused_cond_head(h, fused, dt)
        mu, sigma2 = model.head.finish_duration(d)
        z = torch.cat([stop_logit, amap.reshape(n, -1)], dim=-1)
        amap = amap.to(dt)
        outs.append((z, mu, sigma2, amap))
        if kind == "full":
            entry = model._new_stream_entry(amap, visual, vismean)
            for key, v in entry.items():
                hist[key][:, step + 1] = v
    return outs, h, c


def checksum(outs, h) -> torch.Tensor:
    """A device scalar that depends on every output of a loop."""
    total = h.float()[:, 0, 0].sum()
    for z, mu, sigma2, amap in outs:
        total = total + z.sum() + mu.sum() + sigma2.sum() \
            + amap.float()[:, 0, 0].sum()
    return total


def trace_problem(spans_us, cell_events: int, steps: int,
                  span_ms: float) -> str | None:
    """Why a loop's trace cannot give its busy share, or None: fewer
    cell-kernel events than the loop's ``steps`` (the trace lost
    events), or device events whose summed time passes the span (they
    were not all inside it)."""
    if cell_events < steps:
        return (f"{cell_events} cell-kernel events in the trace for "
                f"{steps} steps")
    total_ms = sum(hi - lo for lo, hi in spans_us) / 1e3
    if total_ms > span_ms * (1 + SPAN_SLACK):
        return (f"device events sum to {total_ms:.3f} ms over a "
                f"{span_ms:.3f} ms span")
    return None


def busy_share(fn, steps: int) -> tuple[float | None, str, float | None]:
    """The device's busy share of one call of ``fn`` on the card, a loop
    of ``steps`` cell steps: the union of the kernels' device intervals
    under torch.profiler over the span between CUDA events around the
    call.  Returns (the share, "ok", the head kernel's device ms a step),
    or (None, the reason, None) when the trace fails
    :func:`trace_problem`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        common.sync(fn())
        end.record()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    span_ms = start.elapsed_time(end)
    problem = trace_problem(
        spans, sum(any(k in e.name for k in CELL_KERNELS) for e in events),
        steps, span_ms)
    if problem is not None:
        return None, problem, None
    busy_us, reach = 0.0, -math.inf
    for lo, hi in spans:
        busy_us += max(0.0, hi - max(lo, reach))
        reach = max(reach, hi)
    head_us = sum(e.time_range.end - e.time_range.start for e in events
                  if any(k in e.name for k in HEAD_KERNELS))
    return busy_us / 1e3 / span_ms, "ok", head_us / 1e3 / steps


def run(device, geo, dtype=torch.float32, batch=8, iters=5):
    """The four variants of ``geo``'s OSIE model (seed weights) at
    ``batch`` in ``dtype``; prints and returns the record."""
    from ..utils.tracing import launches
    before = launches()
    model = common.osie_model(geo, device, dtype).eval()
    hoisted = hoist(model, common.random_images(batch, geo, device))
    on_card = torch.device(device).type == "cuda"
    ms, busy, trace, head_ms = {}, {}, {}, {}
    for kind in VARIANTS:
        def loop(kind=kind):
            outs, h, _ = scan(model, kind, hoisted)
            return checksum(outs, h)
        ms[kind] = common.timed(loop, iters, warmup=WARMUP,
                                reduce=np.median) * 1e3 / model.seq_len
        busy[kind], trace[kind], head_ms[kind] = busy_share(
            loop, model.seq_len) if on_card else (None, None, None)
    return common.emit({
        "metric": "decode_step_split", "batch": batch, "t": model.seq_len,
        "dtype": str(dtype)[6:], "device": str(device),
        "ms_per_step": ms,
        "signal_ms_per_step": ms["cell+sig"] - ms["cell"],
        "head_ms_per_step": ms["cell+head"] - ms["cell+sig"],
        "history_ms_per_step": ms["full"] - ms["cell+head"],
        "busy_share": busy, "trace": trace,
        "head_kernel_ms_per_step": head_ms,
        "loops_per_variant": WARMUP + iters + int(on_card),
        "launches": {k: v - before[k] for k, v in launches().items()}})


def main(argv=None):
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--dtype", default="both",
                   choices=("float32", "bfloat16", "both"))
    p.add_argument("--iters", type=int, default=5)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    common.no_tf32()
    dtypes = ("float32", "bfloat16") if args.dtype == "both" \
        else (args.dtype,)
    return [run(args.device, common.geometry(args), getattr(torch, d),
                args.batch, args.iters) for d in dtypes]


if __name__ == "__main__":
    main()
