"""Serving entry point: predict scanpaths for image files with the
PyTorch port (OSIE).

    python -m scanpaths_tpu_torch.cli.predict --task osie \\
        --predict_images img1.jpg,img2.jpg [--evaluation_dir RUN] \\
        [--decode sample --num_samples 10] [--half_precision true] \\
        [--device cuda] [--predict_out scanpaths.json]

``--device`` (default ``cuda``) is this CLI's own flag; every other flag
is ``core/config.py::parse_opt``'s, the JAX package's CLI flags.  With
``--device cuda`` and no card the CLI raises: pass ``--device cpu`` to
run on the CPU.  Images are served in chunks of ``--batch``, the tail
chunk padded to the full batch.  Output records use the reference
prediction schema: X/Y in pixels of the model geometry, T in
milliseconds, one record per (image, sample).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..core.config import parse_opt
from ..data.transforms import load_image
from ..serve.predictor import Predictor


def _expand_images(spec: str) -> list[str]:
    if os.path.isdir(spec):
        exts = (".jpg", ".jpeg", ".png", ".bmp")
        return sorted(os.path.join(spec, f) for f in os.listdir(spec)
                      if f.lower().endswith(exts))
    return [p for p in spec.split(",") if p]


def _records(img_names, samples) -> list[dict]:
    """Samples with leading [R, N] -> reference-schema records."""
    fix = samples.fix.float().cpu().numpy()
    lens = samples.fix_len.cpu().numpy()
    recs = []
    for r in range(fix.shape[0]):
        for i, name in enumerate(img_names):
            n = int(lens[r, i])
            recs.append({
                "name": name,
                "repeat_id": r + 1,
                "X": [float(v) for v in fix[r, i, :n, 0]],
                "Y": [float(v) for v in fix[r, i, :n, 1]],
                "T": [float(v * 1000) for v in fix[r, i, :n, 2]],
                "length": n,
            })
    return recs


def main(argv=None) -> list[dict]:
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    ns, rest = pre.parse_known_args(argv)
    args = parse_opt(rest)
    if args.task != "osie":
        raise ValueError(f"--task {args.task}: only osie is ported")
    if args.bundle:
        raise ValueError("--bundle: exported bundles are not served by "
                         "the port")
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    paths = _expand_images(args.predict_images)
    if not paths:
        raise ValueError("--predict_images gave no image files")
    if args.predict_att:
        print("[predict] warning: --predict_att is ignored for osie (the "
              "osie model takes no attention input)", file=sys.stderr)
    if args.decode == "greedy" and args.num_samples > 1:
        print(f"[predict] warning: --num_samples {args.num_samples} is "
              "ignored under --decode greedy", file=sys.stderr)

    predictor = Predictor(args, device)
    # 0 = the evaluation setting: eval_repeat_num scanpaths per image
    n_samples = args.num_samples or args.eval_repeat_num
    bs = max(args.batch, 1)
    blank = np.zeros((args.height, args.width, 3), np.float32)
    records = []
    for lo in range(0, len(paths), bs):
        chunk = paths[lo:lo + bs]
        n_real = len(chunk)
        images = np.stack([load_image(p, args.height, args.width)
                           for p in chunk] + [blank] * (bs - n_real))
        out = predictor.forward(images)
        samples = predictor.decode(out, args.decode, n_samples)
        samples = type(samples)(*(v[:, :n_real] for v in samples))
        records.extend(_records([os.path.basename(p) for p in chunk],
                                samples))

    payload = json.dumps(records, indent=2)
    if args.predict_out:
        with open(args.predict_out, "w") as f:
            f.write(payload)
    else:
        sys.stdout.write(payload + "\n")
    return records


if __name__ == "__main__":
    main()
