"""Where the time of the decode benchmark's step goes (the port of
``tools/profile_bench.py``): the OSIE model with seed weights (its
duration head calibrated) runs the step, the eval forward and 10
sampled decodes, ``--iters`` times in one loop with the port's spans on
(``utils/tracing.py``); each row is the median over the steps of

  backbone                  the ``trunk`` span: the dilated ResNet-50
                            -> [N, 30, 40, 2048]
  hoisted(sal_conv+xgates)  ``decode.hoist``: sal_conv + relu, the
                            x-gates and the decoder's other step
                            invariants
  decode_scan               ``decode`` less ``decode.hoist``: the 16
                            steps and the softmax
  sampling_x10              ``sample``: the 10 sampled decodes
  full_step                 the step, read on the host through a device
                            scalar

beside the analytic FLOP split (``tools/flops.py``) and the step's MFU.

    python -m scanpaths_tpu_torch.tools.profile_bench [--batch 8]
        [--dtype bfloat16|float32] [--iters N] [--device cuda|cpu] [--tiny]

A span's time is its device time on a card (CUDA events on the current
stream) and its host time on the CPU.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import common, flops

SAMPLES = 10
WARMUP = 2


def span_ms(spans) -> dict:
    """Each root span's summed ms by span name: {root id: {name: ms}}."""
    out: dict = {}
    for s in spans:
        ms = s.host_ms if s.device_ms is None else s.device_ms
        names = out.setdefault(s.root, {})
        names[s.name] = names.get(s.name, 0.0) + ms
    return out


def run(device, geo, dtype=torch.bfloat16, batch=8, iters=6):
    from ..ops.sampling import random_sample, sample_checksum
    from ..utils import tracing
    model = common.osie_model(geo, device, dtype, calibrated=True).eval()
    grid = common.grid_spec(geo)
    images = common.random_images(batch, geo, device)
    gen = torch.Generator(device=device).manual_seed(1)

    def step():
        with tracing.span("step"):
            out = model(images)
            s = random_sample(out["all_actions_prob"], out["log_normal_mu"],
                              out["log_normal_sigma2"], grid, gen,
                              rollouts=SAMPLES)
            return sample_checksum(s)

    for _ in range(WARMUP):
        common.sync(step())
    tracing.clear()
    tracing.enable()
    try:
        walls = []
        for _ in range(iters):
            t0 = time.perf_counter()
            common.sync(step())
            walls.append(time.perf_counter() - t0)
        steps = list(span_ms(tracing.spans()).values())
    finally:
        tracing.disable()
        tracing.clear()

    def median(fn):
        return float(np.median([fn(t) for t in steps]))
    full_step = float(np.median(walls))
    parts = flops.model_flops_parts(**common.flop_geometry(geo))
    per_image = flops.model_flops_per_image(**common.flop_geometry(geo))
    return common.emit({
        "metric": "bench_component_breakdown", "batch": batch,
        "dtype": str(dtype)[6:], "device": str(device),
        "ms": {"backbone": median(lambda t: t["trunk"]),
               "hoisted(sal_conv+xgates)": median(
                   lambda t: t["decode.hoist"]),
               "decode_scan": median(
                   lambda t: t["decode"] - t["decode.hoist"]),
               "sampling_x10": median(lambda t: t["sample"]),
               "full_step": full_step * 1e3},
        "gflop_per_image": {
            "backbone": (parts["stem"] + parts["blocks"]) / 1e9,
            "hoisted": parts["hoisted"] / 1e9,
            "decode_scan": parts["t"] * (parts["step_gates"]
                                         + parts["step_other"]) / 1e9,
            "total": per_image / 1e9},
        "mfu_full_step": flops.mfu(per_image * batch, full_step, dtype)})


def main(argv=None):
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--iters", type=int, default=6)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    common.no_tf32()
    return run(args.device, common.geometry(args), getattr(torch, args.dtype),
               args.batch, args.iters)


if __name__ == "__main__":
    main()
