"""Bulk visual-search scanpath generation (COCO-Search18), closed loop,
one caller.  As ``generate.py``, with a search target: each unit is a
batch of the mix's ``batch`` images, each with its target's id and a
detector map of that target (``reference/search.py::boxes``), through
the trunk (``resnet.fused_forward``), the decoder
(``ScanpathModel.forward`` with ``task_ids``: the bank entries of the
batch's distinct ids composed with the head, the cell kernel, the head
kernel with per-sample fields) and ``ops/sampling.random_sample`` with
the mix's ``rollouts`` per image, until the scanpaths are on the host.
Every unit's images, maps and ids are drawn on the card from its own
seed, so no two units share an input and no result can be reused.

End to end: ``scanpaths_per_s``, every scanpath the window completed
(images x rollouts a batch) over the window's seconds.  Traced runs also
record CUDA events around each layer call (``trunk``, ``decode``,
``sample``, ``to_host``), profile ``profile_units`` batches right after
the window, and print on standard error the program's compositions a
profiled batch (``cond_head.composed``) beside the batch's distinct ids.
The output check (:func:`check`) holds the timed path's outputs to the
per-sample reference (``reference/search.py``).
"""

from __future__ import annotations

import sys
import time

import torch

from benchmark import harness
from benchmark.reference import compare, sampler, search


def inputs(cfg: dict, mix: dict, n: int, seed: int, unit: int, device):
    """A unit's ``n`` images [n, H, W, 3] (standard normal, as in
    ``harness.inputs``), detector maps [n, mh, mw, 1] and target ids [n],
    from its seed on ``device``."""
    gen = torch.Generator(device=device).manual_seed(
        harness.unit_seed(seed, unit))
    images = torch.randn((n, cfg["height"], cfg["width"], 3),
                         generator=gen, device=device)
    maps, ids = search.boxes(gen, n, cfg, mix, device)
    return images, maps, ids


def build_model(ctx: harness.Context):
    """The program's ``ScanpathModel`` of the configuration, its weights
    the seed's in the reference layout (:func:`search.make_state_dict`,
    their calibration kept in ``ctx.scales``) read through the program's
    own loader."""
    from scanpaths_tpu_torch.models.port import load_reference_state_dict
    from scanpaths_tpu_torch.models.scanpath_model import ScanpathModel
    cfg, device = ctx.cfg, ctx.device
    if cfg["dtype"] != "float32":
        raise ValueError(f"dtype {cfg['dtype']!r}: the harness builds "
                         "float32 configurations")
    sd, ctx.scales = search.make_state_dict(cfg, ctx.seed, device,
                                            ctx.scales)
    with torch.device(device):
        net = ScanpathModel(cfg["task"], embed=cfg["embed"],
                            seq_len=cfg["max_length"],
                            map_h=cfg["map_height"], map_w=cfg["map_width"],
                            backbone_layers=tuple(cfg["backbone_layers"]))
    net.load_state_dict(load_reference_state_dict(sd, cfg["task"]))
    return net.eval()


@torch.no_grad()
def check(ctx: harness.Context, picked: list, n: int, rollouts: int | None,
          control_precision: str | None = None) -> dict:
    """``harness.check`` against the per-sample reference: the units
    ``picked``, a list of (unit index, [one served dict]), the reference
    run once over all their inputs on the seed's weights made anew (with
    the program's calibration), each unit's noise redrawn from its seed;
    ``control_precision`` judges the control's outputs
    (:func:`search.served`) in place of the served ones.  Returns the
    worst of each number."""
    cfg, dev = ctx.cfg, ctx.device
    sd, ctx.scales = search.make_state_dict(cfg, ctx.seed, dev, ctx.scales)
    batch = [inputs(cfg, ctx.mix, n, ctx.seed, i, dev) for i, _ in picked]
    images, maps, ids = (torch.cat(v) for v in zip(*batch))
    ref = search.forward(sd, cfg, images, maps, ids)
    scales = compare.ranges([ref])
    gen = torch.Generator(device=dev)
    readings = []
    for k, (i, served) in enumerate(picked):
        rows = slice(k * n, (k + 1) * n)
        noise = None
        if rollouts is not None:
            gen.manual_seed(harness.unit_seed(ctx.seed, i, 1))
            noise = sampler.noise(gen, rollouts, ref["logits"][rows].shape,
                                  ref["mu"][rows].shape, dev)
        if control_precision is not None:
            served = [search.served(sd, cfg, images[rows], maps[rows],
                                    ids[rows], noise, control_precision)]
        r = {key: v[rows] for key, v in ref.items()}
        g, nrm = (None, None) if noise is None else noise
        readings += [compare.judge(r, s, cfg, scales, g, nrm)
                     for s in served]
    return compare.worst(readings)


def run(ctx: harness.Context) -> harness.Outcome:
    from scanpaths_tpu_torch.models import resnet
    from scanpaths_tpu_torch.ops.sampling import random_sample
    from scanpaths_tpu_torch.utils import tracing
    cfg, mix = ctx.cfg, ctx.mix
    n, rollouts = mix["batch"], mix["rollouts"]
    on_card = ctx.device.type == "cuda"
    harness.mark(ctx, "program imported")
    model = build_model(ctx)
    harness.mark(ctx, "weights made and loaded")
    grid = harness.grid(cfg)
    gen = torch.Generator(device=ctx.device)
    spans = harness.Spans(events=False)

    def prepare(i):
        return inputs(cfg, mix, n, ctx.seed, i, ctx.device)

    @torch.no_grad()
    def serve(i, images, maps, ids):
        with spans("trunk"):
            x = resnet.fused_forward(model.backbone, images, model.dtype)
        with spans("decode"):
            out = model(attention_maps=maps, task_ids=ids, features=x)
        with spans("sample"):
            gen.manual_seed(harness.unit_seed(ctx.seed, i, 1))
            sample = random_sample(
                out["all_actions_prob"], out["log_normal_mu"],
                out["log_normal_sigma2"], grid, gen, rollouts=rollouts)
        with spans("to_host"):
            sample.fix.cpu()
            sample.fix_len.cpu()
        return out, sample

    for i in range(mix["warmup_units"]):
        serve(-1 - i, *prepare(-1 - i))
    setup_s = time.perf_counter() - ctx.t0
    harness.mark(ctx, "warm-up done")
    spans.events = ctx.trace and on_card
    kept = []
    start = time.perf_counter()
    while True:
        i = len(kept)
        kept.append(serve(i, *prepare(i)))
        end = time.perf_counter()
        if end - start >= ctx.seconds:
            break
    window_s = end - start
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    outcome = harness.Outcome(
        attempted=len(kept), failed=0, setup_s=setup_s, window_s=window_s,
        e2e={"scanpaths_per_s": len(kept) * n * rollouts / window_s},
        peak_bytes=peak, numbers={}, limits=ctx.spec["limits"],
        counts={"images": len(kept) * n, "batch": n, "streams": 1})
    if spans.events:
        outcome.spans = spans.ms()
        units = range(len(kept), len(kept) + mix["profile_units"])
        tracing.reset_counters("cond_head.composed")
        outcome.trace = harness.profile(spans, prepare, serve, units[0],
                                        len(units))
        distinct = [len(torch.unique(prepare(u)[2])) for u in units]
        print(f"profiled batches: cond_head.composed "
              f"{tracing.counter('cond_head.composed') / len(units):g} a "
              f"batch; distinct target ids {distinct}", file=sys.stderr,
              flush=True)
    picked = [(i, [harness.served_dict(kept[i][0], None, kept[i][1])])
              for i in harness.pick(ctx.seed, len(kept),
                                    ctx.spec["check_units"])]
    del model, kept
    harness.free()
    outcome.numbers = check(ctx, picked, n, rollouts)
    return outcome
