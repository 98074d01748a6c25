"""Export a trained run to a serving bundle (port of
``scanpaths_tpu/cli/export.py``).

    python -m scanpaths_tpu_torch.cli.export --task osie \\
        --evaluation_dir RUN --export_dir bundle/ \\
        [--decode sample --num_samples 10] [--export_batch 8|sym] \\
        [--half_precision true] [--export_platforms cuda,cpu] \\
        [--device cuda]

The bundle (``serve.pt2`` + ``manifest.json``, ``serve/export.py``)
holds the trained weights; a serving host needs torch and the port's op
registrations and nothing else of the port:

    import scanpaths_tpu_torch.ops                 # registers the kernels
    program = torch.export.load("bundle/serve.pt2")

or, with the seed and device handling, ``fn, manifest =
scanpaths_tpu_torch.serve.load_bundle("bundle/")`` and ``fn(images)``
(see ``manifest["inputs"]``).

The weights are read as ``cli/predict.py`` reads them
(``serve/predictor.py::Predictor``: ``RUN/checkpoints/checkpoint_best.pth``;
a joint run's ``--task`` head; ``--task joint`` raises).  ``--device``
(default ``cuda``) is this CLI's own flag; with no card it raises unless
``--device cpu`` is given.  ``--export_platforms`` names torch devices,
the first of which must be ``--device``'s (default: that device, then
the other).  ``--export_check`` reloads the bundle and holds it to the
live serving module on random inputs: ``fix``, ``fix_len`` and
``action_probs`` must be equal.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..core.config import parse_opt
from ..serve.export import ServeModule, export_bundle, load_bundle, \
    serving_fn
from ..serve.predictor import Predictor


def check_feed(args, b: int, n_ids: int | None = None) -> list:
    """Random inputs of batch ``b`` in the bundle's order (COCO's task
    ids below ``n_ids``)."""
    rng = np.random.default_rng(0)
    feed = [7] if args.decode == "sample" else []
    feed.append(rng.normal(size=(b, args.height, args.width, 3))
                .astype(np.float32))
    if args.task in ("air", "coco"):
        feed.append(rng.uniform(size=(b, args.map_height, args.map_width,
                                      1)).astype(np.float32))
    if args.task == "coco":
        feed.append(rng.integers(0, n_ids, size=(b,)).astype(np.int32))
    return feed


def max_abs_diff(a, b) -> float:
    """Largest |a - b| where the two differ (NaN beside NaN and equal
    infinities count as equal; a NaN beside a number is inf)."""
    a, b = a.double(), b.double()
    differ = (a != b) & ~(a.isnan() & b.isnan())
    if not bool(differ.any()):
        return 0.0
    return float((a[differ] - b[differ]).abs().nan_to_num(nan=float("inf"))
                 .max())


def main(argv=None) -> dict:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    ns, rest = pre.parse_known_args(argv)
    args = parse_opt(rest)
    if args.task == "joint":
        raise ValueError(
            "export a joint checkpoint one task head at a time: pass "
            "--task osie|air|coco with --evaluation_dir at the joint run")
    if not args.evaluation_dir:
        raise ValueError("--evaluation_dir (trained run dir) required")
    if not args.export_dir:
        raise ValueError("--export_dir required")
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run on the CPU")

    predictor = Predictor(args, device)
    platforms = [p for p in args.export_platforms.split(",") if p] or None
    num_samples = args.num_samples or args.eval_repeat_num
    batch = args.export_batch if args.export_batch == "sym" \
        else int(args.export_batch)
    t0 = time.perf_counter()
    manifest = export_bundle(
        args.export_dir, predictor.model, predictor.grid,
        decode=args.decode, num_samples=num_samples, batch=batch,
        platforms=platforms, map_h=args.map_height, map_w=args.map_width)
    print(f"[export] wrote {args.export_dir}: {manifest['bytes']} bytes in "
          f"{time.perf_counter() - t0:.1f} s (export and save), "
          f"platforms={manifest['platforms']}, "
          f"inputs={[i['name'] for i in manifest['inputs']]}",
          file=sys.stderr)

    if args.export_check:
        fn, mf = load_bundle(args.export_dir, device)
        live = serving_fn(ServeModule(predictor.model, predictor.grid,
                                      args.decode).eval(), mf, device)
        b = 2 if batch == "sym" else batch
        feed = check_feed(args, b, mf.get("num_task_ids"))
        got, want = fn(*feed), live(*feed)
        err = max(max_abs_diff(got[k], want[k])
                  for k in ("fix", "fix_len", "action_probs"))
        if err != 0.0:
            raise RuntimeError(f"the bundle disagrees with the live model: "
                               f"max abs difference {err}")
        print(f"[export] check ok: bundle == live model (batch {b})",
              file=sys.stderr)
    return manifest


if __name__ == "__main__":
    main()
