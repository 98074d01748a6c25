"""Serving entry point: predict scanpaths for image files with the
PyTorch port.

    python -m scanpaths_tpu_torch.cli.predict --task osie|air|coco \\
        --predict_images img1.jpg,img2.jpg [--evaluation_dir RUN] \\
        [--predict_att a1.npy,a2.npy] [--target_category cup] \\
        [--decode sample --num_samples 10] [--half_precision true] \\
        [--device cuda] [--predict_out scanpaths.json]
    python -m scanpaths_tpu_torch.cli.predict --task osie \\
        --bundle BUNDLE --predict_images DIR [--device cuda]

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
chunk padded to the full batch.  With ``--bundle`` (a directory
``cli/export.py`` wrote) the exported program serves instead of the
model: its manifest sets the decode mode, the sample count, the
geometry and the batch (a fixed batch pads the tail chunk, a symbolic
one is chunked by ``--batch``).  Output records use the reference
prediction schema: X/Y in pixels of the model geometry, T in
milliseconds, one record per (image, sample).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types

import numpy as np
import torch

from ..core.config import parse_opt
from ..data.datasets import COCO_OBJECT_NAMES
from ..data.transforms import load_image, resize_map
from ..serve.export import load_bundle
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


def _inputs(args, chunk, att_paths, task_ids, rows: int, geo: dict):
    """Images [rows, h, w, 3] of ``chunk`` (zero rows past it), attention
    maps [rows, mh, mw, 1] (AiR, COCO: ``att_paths``' maps resized and
    divided by their max, zeros when omitted) and task ids [rows]
    (COCO), at the geometry ``geo`` (the manifest's fields)."""
    h, w = geo["height"], geo["width"]
    mh, mw = geo["map_height"], geo["map_width"]
    blank = np.zeros((h, w, 3), np.float32)
    images = np.stack([load_image(p, h, w) for p in chunk]
                      + [blank] * (rows - len(chunk)))
    maps = tids = None
    if args.task in ("air", "coco"):
        maps = np.zeros((rows, mh, mw, 1), np.float32)
        for i, ap in enumerate(att_paths):
            m = resize_map(np.load(ap).astype(np.float32), (mh, mw))
            maps[i, ..., 0] = m / max(float(m.max()), 1e-12)
    if task_ids is not None:
        tids = np.zeros((rows,), np.int32)
        tids[:len(task_ids)] = task_ids
    return images, maps, tids


def _main_bundle(args, paths, att_paths, task_ids, device) -> list[dict]:
    """Serve from an exported bundle (``serve/export.py``): no model code
    and no checkpoint, the program and its weights are the bundle.
    Decode mode, sample count and geometry come from the manifest; a
    sampled bundle gets a seed per chunk, drawn from a generator seeded
    with ``--seed``."""
    fn, mf = load_bundle(args.bundle, device)
    if mf["task"] != args.task:
        raise ValueError(f"the bundle was exported for task "
                         f"{mf['task']!r}, got --task {args.task!r}")
    decode, num_samples = mf["decode"], mf["num_samples"]
    # decode mode and sample count are inside the program: warn when
    # the flags ask for something else
    if args.decode and args.decode != decode:
        print(f"[predict] warning: --decode {args.decode} is ignored; "
              f"the bundle was exported with decode={decode!r}",
              file=sys.stderr)
    if args.num_samples and args.num_samples != num_samples:
        print(f"[predict] warning: --num_samples {args.num_samples} is "
              f"ignored; the bundle was exported with "
              f"num_samples={num_samples}", file=sys.stderr)
    # a symbolic bundle takes any batch: chunk by --batch, so that the
    # images are not all stacked at once; a fixed batch pads the tail
    sym = mf["batch"] == "sym"
    bs = max(args.batch, 1) if sym else int(mf["batch"])
    gen = torch.Generator().manual_seed(args.seed)
    records = []
    for lo in range(0, len(paths), bs):
        chunk = paths[lo:lo + bs]
        images, maps, tids = _inputs(
            args, chunk, att_paths[lo:lo + bs],
            None if task_ids is None else task_ids[lo:lo + bs],
            len(chunk) if sym else bs, mf["geometry"])
        if maps is not None and args.ablate_attention_info:
            maps = np.zeros_like(maps)
        feed = [v for v in (images, maps, tids) if v is not None]
        if decode == "sample":
            feed.insert(0, int(torch.randint(0, 2**31 - 1, (),
                                             generator=gen)))
        out = fn(*feed)
        lead = (lambda v: v[None]) if decode == "greedy" else (lambda v: v)
        samples = types.SimpleNamespace(
            fix=lead(out["fix"])[:, :len(chunk)],
            fix_len=lead(out["fix_len"])[:, :len(chunk)])
        records.extend(_records([os.path.basename(p) for p in chunk],
                                samples))
    return records


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
    if args.bundle:
        records = _main_bundle(args, paths, att_paths, task_ids, device)
    else:
        records = _main_live(args, paths, att_paths, task_ids, device)

    payload = json.dumps(records, indent=2)
    if args.predict_out:
        with open(args.predict_out, "w") as f:
            f.write(payload)
    else:
        sys.stdout.write(payload + "\n")
    return records


def _main_live(args, paths, att_paths, task_ids, device) -> list[dict]:
    """Serve the model of ``--evaluation_dir`` (or of ``--seed``), in
    chunks of ``--batch``, the tail chunk padded to the full batch."""
    if args.decode == "greedy" and args.num_samples > 1:
        print(f"[predict] warning: --num_samples {args.num_samples} is "
              "ignored under --decode greedy", file=sys.stderr)
    predictor = Predictor(args, device)
    # 0 = the evaluation setting: eval_repeat_num scanpaths per image
    n_samples = args.num_samples or args.eval_repeat_num
    # an AiR checkpoint serves its correct-answer stream
    stream = "good" if args.task == "air" else None
    geo = {"height": args.height, "width": args.width,
           "map_height": args.map_height, "map_width": args.map_width}
    bs = max(args.batch, 1)
    records = []
    for lo in range(0, len(paths), bs):
        chunk = paths[lo:lo + bs]
        images, maps, tids = _inputs(
            args, chunk, att_paths[lo:lo + bs],
            None if task_ids is None else task_ids[lo:lo + bs], bs, geo)
        out = predictor.forward(images, maps, tids)
        samples = predictor.decode(out, args.decode, n_samples, stream)
        samples = type(samples)(*(v[:, :len(chunk)] for v in samples))
        records.extend(_records([os.path.basename(p) for p in chunk],
                                samples))
    return records


if __name__ == "__main__":
    main()
