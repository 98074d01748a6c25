"""Serving entry point: predict scanpaths for image files with the
PyTorch port.

    python -m scanpaths_tpu_torch.cli.predict --task osie|air|coco \\
        --predict_images img1.jpg,img2.jpg [--evaluation_dir RUN] \\
        [--predict_att a1.npy,a2.npy] [--target_category cup] \\
        [--decode sample --num_samples 10] [--half_precision true] \\
        [--device cuda] [--predict_out scanpaths.json]

Conditioning inputs: AiR and COCO take an attention map per image
(``--predict_att`` .npy files, resized to the map and divided by their
max; zeros when omitted); COCO also takes the search target
(``--target_category``, one name for every image or one per image).  An
AiR checkpoint serves its good (right-answer) stream.  A joint run
(``--evaluation_dir`` at a ``--task joint`` run) serves its ``--task``
head; ``--task joint`` itself raises.

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
from ..data.datasets import COCO_OBJECT_NAMES
from ..data.transforms import load_image, resize_map
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
    if args.task == "joint":
        raise ValueError(
            "serve a joint checkpoint one task at a time: pass --task "
            "osie|air|coco with --evaluation_dir pointing at the joint run "
            "(the Evaluator detects the joint checkpoint from hparams.json)")
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
    att_paths = [p for p in args.predict_att.split(",") if p]
    if att_paths and args.task == "osie":
        print("[predict] warning: --predict_att is ignored for osie (the "
              "osie model takes no attention input)", file=sys.stderr)
        att_paths = []
    if att_paths and len(att_paths) != len(paths):
        raise ValueError(f"{len(att_paths)} attention maps for "
                         f"{len(paths)} images")
    task_ids = None
    if args.task == "coco":
        cats = [c for c in args.target_category.split(",") if c]
        if not cats:
            raise ValueError("--target_category is required for coco")
        if len(cats) == 1:
            cats = cats * len(paths)
        if len(cats) != len(paths):
            raise ValueError(f"{len(cats)} target categories for "
                             f"{len(paths)} images")
        unknown = sorted(set(cats) - set(COCO_OBJECT_NAMES))
        if unknown:
            raise ValueError(f"--target_category {unknown}: not among "
                             f"{COCO_OBJECT_NAMES}")
        task_ids = np.asarray([COCO_OBJECT_NAMES.index(c) for c in cats],
                              np.int32)
    if args.decode == "greedy" and args.num_samples > 1:
        print(f"[predict] warning: --num_samples {args.num_samples} is "
              "ignored under --decode greedy", file=sys.stderr)

    predictor = Predictor(args, device)
    # 0 = the evaluation setting: eval_repeat_num scanpaths per image
    n_samples = args.num_samples or args.eval_repeat_num
    # an AiR checkpoint serves its correct-answer stream
    stream = "good" if args.task == "air" else None
    mh, mw = args.map_height, args.map_width
    bs = max(args.batch, 1)
    blank = np.zeros((args.height, args.width, 3), np.float32)
    records = []
    for lo in range(0, len(paths), bs):
        chunk = paths[lo:lo + bs]
        n_real = len(chunk)
        images = np.stack([load_image(p, args.height, args.width)
                           for p in chunk] + [blank] * (bs - n_real))
        maps = tids = None
        if args.task in ("air", "coco"):
            maps = np.zeros((bs, mh, mw, 1), np.float32)
            for i, ap in enumerate(att_paths[lo:lo + bs]):
                m = resize_map(np.load(ap).astype(np.float32), (mh, mw))
                maps[i, ..., 0] = m / max(float(m.max()), 1e-12)
        if task_ids is not None:
            tids = np.zeros((bs,), np.int32)
            tids[:n_real] = task_ids[lo:lo + n_real]
        out = predictor.forward(images, maps, tids)
        samples = predictor.decode(out, args.decode, n_samples, stream)
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
