"""Where the time of the decode benchmark's step goes (the port of
``tools/profile_bench.py``): four scopes timed alone on the OSIE model
with seed weights (its duration head calibrated),

  backbone   the dilated ResNet-50 -> [N, 30, 40, 2048]
  hoisted    the backbone, then sal_conv + relu + the x-gates
  forward    the whole eval forward (backbone, hoisted, the 16-step decode)
  step       the forward and 10 sampled decodes

from which ``hoisted = hoisted - backbone``, ``decode_scan = forward -
hoisted`` and ``sampling_x10 = step - forward`` are derived, beside the
analytic FLOP split (``tools/flops.py``) and the step's MFU.

    python -m scanpaths_tpu_torch.tools.profile_bench [--batch 8]
        [--dtype bfloat16|float32] [--iters N] [--device cuda|cpu] [--tiny]

Each scope's time is the median over ``--iters`` calls, each read on
the host through a device scalar.  The derived rows are differences of
scopes timed apart, so they move by a few ms between runs.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from . import common, flops

SAMPLES = 10


def run(device, geo, dtype=torch.bfloat16, batch=8, iters=6):
    from ..models import resnet
    from ..models.components import conv2d, hwio
    from ..ops.sampling import random_sample, sample_checksum
    model = common.osie_model(geo, device, dtype, calibrated=True).eval()
    grid = common.grid_spec(geo)
    images = common.random_images(batch, geo, device)
    gen = torch.Generator(device=device).manual_seed(1)

    @torch.no_grad()
    def backbone():
        return resnet.fused_forward(model.backbone, images,
                                    dtype).float().sum()

    @torch.no_grad()
    def hoisted():
        x = resnet.fused_forward(model.backbone, images, dtype)
        k, b = hwio(model.sal_conv)
        visual = F.relu(conv2d(x, k, b, padding=((1, 1), (1, 1)),
                               dtype=dtype))
        return model.xgates(visual).float().sum()

    def forward():
        return model(images)["all_actions_prob"].sum()

    def step():
        out = model(images)
        s = random_sample(out["all_actions_prob"], out["log_normal_mu"],
                          out["log_normal_sigma2"], grid, gen,
                          rollouts=SAMPLES)
        return sample_checksum(s)

    t = {name: common.timed(fn, iters, reduce=np.median)
         for name, fn in (("backbone", backbone), ("hoisted", hoisted),
                          ("forward", forward), ("step", step))}
    parts = flops.model_flops_parts(**common.flop_geometry(geo))
    per_image = flops.model_flops_per_image(**common.flop_geometry(geo))
    return common.emit({
        "metric": "bench_component_breakdown", "batch": batch,
        "dtype": str(dtype)[6:], "device": str(device),
        "ms": {"backbone": t["backbone"] * 1e3,
               "hoisted(sal_conv+xgates)":
                   (t["hoisted"] - t["backbone"]) * 1e3,
               "decode_scan": (t["forward"] - t["hoisted"]) * 1e3,
               "sampling_x10": (t["step"] - t["forward"]) * 1e3,
               "full_step": t["step"] * 1e3},
        "gflop_per_image": {
            "backbone": (parts["stem"] + parts["blocks"]) / 1e9,
            "hoisted": parts["hoisted"] / 1e9,
            "decode_scan": parts["t"] * (parts["step_gates"]
                                         + parts["step_other"]) / 1e9,
            "total": per_image / 1e9},
        "mfu_full_step": flops.mfu(per_image * batch, t["step"], dtype)})


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
