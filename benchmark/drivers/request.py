"""Single-image requests, closed loop, one client: each request is one
image that arrives as a host float32 array, served as
``serve/predictor.py``'s ``Predictor`` serves it (``forward`` on the
host array, then ``decode`` greedy), until the fixations are back on
the host.  Every request's image is drawn from its own seed and copied
to the host before its clock starts.

End to end: ``request_p95_ms``, the 95th percentile of every request's
time from send to fixations on the host; a request that fails counts
as lasting the whole window.  Traced runs profile ``profile_units``
requests right after the window, each request in spans ``forward`` and
``decode``.
"""

from __future__ import annotations

import sys
import time
import types

import torch

from benchmark import harness
from benchmark.yardstick import stats


def predictor(model, cfg, device):
    """A ``Predictor`` serving ``model``: its constructor would make
    seed weights on the host, so the benchmark's are given to it."""
    from scanpaths_tpu_torch.serve.predictor import Predictor
    pred = Predictor.__new__(Predictor)
    pred.args = types.SimpleNamespace(ablate_attention_info=False)
    pred.device = device
    pred.grid = harness.grid(cfg)
    pred.model = model
    pred.generator = None
    return pred


def run(ctx: harness.Context) -> harness.Outcome:
    mix = ctx.mix
    if mix["batch"] != 1 or mix["decode"] != "greedy":
        raise ValueError("the request driver serves one image, greedy")
    on_card = ctx.device.type == "cuda"
    harness.mark(ctx, "program imported")
    model = harness.build_model(ctx)
    harness.mark(ctx, "weights made and loaded")
    pred = predictor(model, ctx.cfg, ctx.device)
    streams = model.streams
    spans = harness.Spans(events=False)

    def prepare(i):
        images, maps = harness.inputs(ctx.cfg, 1, ctx.seed, i, ctx.device)
        return images.cpu().numpy(), \
            None if maps is None else maps.cpu().numpy()

    @torch.no_grad()
    def serve(i, image, maps):
        with spans("forward"):
            out = pred.forward(image, maps)
        samples = []
        with spans("decode"):
            for stream in streams:
                s = pred.decode(out, "greedy", 1, stream)
                s.fix.cpu().numpy()
                s.fix_len.cpu().numpy()
                samples.append(s)
        return out, samples

    for i in range(mix["warmup_units"]):
        serve(-1 - i, *prepare(-1 - i))
    setup_s = time.perf_counter() - ctx.t0
    harness.mark(ctx, "warm-up done")
    spans.events = ctx.trace and on_card
    kept, latency, failed = [], [], 0
    start = time.perf_counter()
    while True:
        image, maps = prepare(len(kept))
        sent = time.perf_counter()
        try:
            kept.append(serve(len(kept), image, maps))
            latency.append(time.perf_counter() - sent)
        except RuntimeError as e:
            print(f"request {len(kept)} failed: {e}", file=sys.stderr,
                  flush=True)
            kept.append(None)
            latency.append(None)
            failed += 1
        end = time.perf_counter()
        if end - start >= ctx.seconds:
            break
    window_s = end - start
    latency = [window_s if t is None else t for t in latency]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    outcome = harness.Outcome(
        attempted=len(kept), failed=failed, setup_s=setup_s,
        window_s=window_s,
        e2e={"request_p95_ms": 1e3 * stats.percentile(latency, 95)},
        peak_bytes=peak, numbers={}, limits=ctx.spec["limits"],
        counts={"images": len(kept), "batch": 1, "streams": len(streams)})
    if spans.events:
        outcome.spans = spans.ms()
        outcome.trace = harness.profile(spans, prepare, serve, len(kept),
                                        mix["profile_units"])
    done = [i for i, k in enumerate(kept) if k is not None]
    picked = [(i, [harness.served_dict(kept[i][0], stream, s)
                   for stream, s in zip(streams, kept[i][1])])
              for i in (done[j] for j in harness.pick(
                  ctx.seed, len(done), ctx.spec["check_units"]))]
    del model, pred, kept
    harness.free()
    outcome.numbers = harness.check(ctx, picked, 1, None)
    return outcome
