"""Serving latency of single-image greedy decoding (the port of
``tools/bench_serving.py``), live or from an exported bundle.

    python -m scanpaths_tpu_torch.tools.bench_serving [--bundle DIR]
        [--device cuda|cpu] [--dtype float32|bfloat16] [--batches 1,8,32]
        [--iters N] [--tiny]

For each batch one JSON line holds both serving disciplines:

* ``p50_ms``/``p95_ms``/``images_per_sec``: request and response, each
  request's result read on the host before the next is sent;
* ``pipelined_images_per_sec``/``device_ms_per_batch``: every request
  sent ahead and the results read at the end, so the time a batch tends
  to the device's; ``dispatch_overhead_ms`` is p50 less that.

Live, the step is the OSIE model with seed weights (its duration head
calibrated) and ``ops/sampling.py::greedy_sample``; with ``--bundle`` it
is a greedy ``cli/export.py`` bundle loaded by
``serve/export.py::load_bundle`` (its batch from the manifest, 1 and 8
for a symbolic one).  A request's result is its fixations, their
lengths and a device checksum over them.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from . import common


def live_step(geo, device, dtype):
    from ..ops.sampling import greedy_sample, sample_checksum
    model = common.osie_model(geo, device, dtype, calibrated=True).eval()
    grid = common.grid_spec(geo)

    def step(images):
        out = model(images)
        s = greedy_sample(out["all_actions_prob"], out["log_normal_mu"],
                          out["log_normal_sigma2"], grid)
        return s.fix, s.fix_len, sample_checksum(s)
    return step


def bundle_step(bundle_dir, device):
    """(step, batches, (height, width), manifest) of a greedy OSIE
    bundle."""
    from ..serve.export import load_bundle
    fn, mf = load_bundle(bundle_dir, device)
    if mf["decode"] != "greedy" or mf["task"] != "osie":
        raise ValueError(f"the serving benchmark times greedy OSIE "
                         f"bundles; this one is {mf['task']} "
                         f"{mf['decode']}")
    geo = mf["geometry"]
    batches = (1, 8) if mf["batch"] == "sym" else (int(mf["batch"]),)

    def step(images):
        out = fn(images)
        fix, n = out["fix"], out["fix_len"]
        return fix, n, torch.nan_to_num(
            fix * (n > 0)[:, None, None]).sum() + n.float().sum()
    return step, batches, (geo["height"], geo["width"]), mf


def measure(step, batch, shape, device, iters):
    """One batch's record of both disciplines."""
    gen = torch.Generator(device=device).manual_seed(0)
    images = torch.randn((batch, *shape, 3), generator=gen, device=device)
    for _ in range(3):
        common.sync(step(images)[2])
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        common.sync(step(images)[2])
        lat.append(time.perf_counter() - t0)
    lat_ms = np.asarray(lat) * 1e3
    p50 = float(np.percentile(lat_ms, 50))
    t0 = time.perf_counter()
    chks = [step(images)[2] for _ in range(iters)]
    for c in chks:
        common.sync(c)
    dt = time.perf_counter() - t0
    device_ms = dt / iters * 1e3
    return {"p50_ms": p50, "p95_ms": float(np.percentile(lat_ms, 95)),
            "images_per_sec": batch / float(np.median(lat)),
            "pipelined_images_per_sec": batch * iters / dt,
            "device_ms_per_batch": device_ms,
            "dispatch_overhead_ms": max(p50 - device_ms, 0.0)}


def run(device, geo=None, dtype=torch.float32, batches=(1, 8, 32),
        iters=30, bundle=""):
    """The serving record, live (``geo``, ``dtype``, ``batches``) or of
    ``bundle``."""
    if bundle:
        step, batches, shape, mf = bundle_step(bundle, device)
        dtype_name = mf.get("model_dtype", "float32")
    else:
        step, shape = live_step(geo, device, dtype), (geo["height"],
                                                      geo["width"])
        dtype_name = str(dtype)[6:]
    results = {f"batch{b}": measure(step, b, shape, device, iters)
               for b in batches}
    return common.emit({"metric": "greedy_serving_latency",
                        "source": "bundle" if bundle else "live_model",
                        "device": str(device), "dtype": dtype_name,
                        **results})


def main(argv=None):
    p = common.parser(__doc__.splitlines()[0])
    p.add_argument("--bundle", default="")
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--batches", default="1,8,32")
    p.add_argument("--iters", type=int, default=30)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    common.no_tf32()
    return run(args.device, common.geometry(args), getattr(torch, args.dtype),
               tuple(int(b) for b in args.batches.split(",")), args.iters,
               args.bundle)


if __name__ == "__main__":
    main()
