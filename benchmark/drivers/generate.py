"""Bulk scanpath generation, closed loop, one caller: each unit is a
batch of the mix's ``batch`` images (and attention maps, for a task
that takes them) through the trunk (``resnet.fused_forward``), the
decoder (``ScanpathModel.forward`` on the trunk's grid) and
``ops/sampling.random_sample`` with the mix's ``rollouts`` per image
and stream, until the scanpaths are on the host.  Every unit's inputs
are drawn on the card from its own seed, so no two units share an input
and no result can be reused.

End to end: ``scanpaths_per_s``, every scanpath the window completed
(images x streams x rollouts a batch) over the window's seconds.  Traced
runs also record CUDA events around each layer call (``trunk``,
``decode``, ``sample``, ``to_host``) and profile ``profile_units``
batches right after the window.
"""

from __future__ import annotations

import time

import torch

from benchmark import harness


def run(ctx: harness.Context) -> harness.Outcome:
    from scanpaths_tpu_torch.models import resnet
    from scanpaths_tpu_torch.ops.sampling import random_sample
    mix = ctx.mix
    n, rollouts = mix["batch"], mix["rollouts"]
    on_card = ctx.device.type == "cuda"
    harness.mark(ctx, "program imported")
    model = harness.build_model(ctx)
    harness.mark(ctx, "weights made and loaded")
    grid = harness.grid(ctx.cfg)
    streams = model.streams
    gen = torch.Generator(device=ctx.device)
    spans = harness.Spans(events=False)

    def prepare(i):
        return harness.inputs(ctx.cfg, n, ctx.seed, i, ctx.device)

    @torch.no_grad()
    def serve(i, images, maps):
        with spans("trunk"):
            x = resnet.fused_forward(model.backbone, images, model.dtype)
        with spans("decode"):
            out = model(attention_maps=maps, features=x)
        samples = []
        with spans("sample"):
            for si, stream in enumerate(streams):
                pre = f"{stream}_" if stream else ""
                gen.manual_seed(harness.unit_seed(ctx.seed, i, 1 + si))
                samples.append(random_sample(
                    out[pre + "all_actions_prob"], out[pre + "log_normal_mu"],
                    out[pre + "log_normal_sigma2"], grid, gen,
                    rollouts=rollouts))
        with spans("to_host"):
            for s in samples:
                s.fix.cpu()
                s.fix_len.cpu()
        return out, samples

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
    per_unit = n * len(streams) * rollouts
    outcome = harness.Outcome(
        attempted=len(kept), failed=0, setup_s=setup_s, window_s=window_s,
        e2e={"scanpaths_per_s": len(kept) * per_unit / window_s},
        peak_bytes=peak, numbers={}, limits=ctx.spec["limits"],
        counts={"images": len(kept) * n, "batch": n,
                "streams": len(streams)})
    if spans.events:
        outcome.spans = spans.ms()
        outcome.trace = harness.profile(spans, prepare, serve, len(kept),
                                        mix["profile_units"])
    picked = [(i, [harness.served_dict(kept[i][0], stream, s)
                   for stream, s in zip(streams, kept[i][1])])
              for i in harness.pick(ctx.seed, len(kept),
                                    ctx.spec["check_units"])]
    del model, kept
    harness.free()
    outcome.numbers = harness.check(ctx, picked, n, rollouts)
    return outcome
