"""Real-data readiness drive (port of ``tools/real_data_smoke.py``): the
one command that drives the port's whole path the moment the real
datasets and the authors' released checkpoints are mounted.  Given a
directory of mounted artifacts it

  1. sha-checks the torchvision trunk (``resnet50-19c8e357.pth``; the
     name embeds its sha256 prefix, ``models/resnet.py``) and records
     the sha256 of every released ``.pth`` checkpoint found;
  2. runs the offline preprocessing (OSIE ``fixations.mat`` split, AiR
     GQA join: ``data/preprocess.py``; COCO ships upstream splits);
  3. loads a released full-model ``checkpoint_best.pth`` (reference
     layout) into the task's model, strictly
     (:func:`port_released_checkpoint`), and starts training from the
     trunk when it is there;
  4. runs ``--steps`` supervised steps of ``cli/train.py``'s ``Trainer``
     on the produced split and one validation sweep (the reference's
     loop shape: reference OSIE/train.py:165-196, then :283-350);
  5. writes the prediction artifact through ``cli/test.py`` and diffs
     its record schema against the reference's field for field
     (:data:`REFERENCE_PREDICT_SCHEMA`; reference AiR/test.py:153-191,
     OSIE/test.py:130-146, COCO_Search18/test.py:145-161).

A task section whose inputs are absent is reported as ``skipped``, and
when every section is skipped the drive exits 0, so it can live in
automation now and light up when the data arrives.  A section that
raises, a released checkpoint that does not load (its section ends
there) or a prediction schema that differs is reported in the JSON and
makes :func:`main` return 1.

Expected layout under --root (flags can override pieces):

    <root>/resnet50-19c8e357.pth         torchvision ImageNet trunk
    <root>/osie/fixations.mat            OSIE eye-tracking release
    <root>/osie/stimuli/*.jpg            OSIE images (800x600)
    <root>/osie/checkpoint_best.pth      released OSIE model (optional)
    <root>/air/consolidated_answers.json AiR answer/accuracy release
    <root>/air/val_balanced_questions.json  GQA questions
    <root>/air/val_sceneGraphs.json      GQA scene graphs
    <root>/air/fixations/<qid>/<subj>.mat   AiR fixation tracks
    <root>/air/images/*.jpg              GQA images
    <root>/air/attention/<qid>.npy       machine attention maps
    <root>/air/checkpoint_best.pth       released AiR model (optional)
    <root>/coco/images/<task>/*.jpg      COCO-Search18 stimuli
    <root>/coco/fixations/coco_search18_fixations_TP_{train,validation}_split1.json
    <root>/coco/detectors/coco_search18_detector.json
    <root>/coco/checkpoint_best.pth      released COCO model (optional)

Usage:
    python -m scanpaths_tpu_torch.tools.real_data_smoke --root DIR \\
        [--task all|osie|air|coco] [--steps 50] [--device cuda|cpu] \\
        [--out REAL_DATA_SMOKE.json] [-- extra train/test CLI flags]
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import sys
import tempfile
from os.path import exists, join

import numpy as np
import torch

# field-for-field reference prediction-record schemas (see the docstring)
REFERENCE_PREDICT_SCHEMA = {
    "osie": {"name", "repeat_id", "X", "Y", "T", "length"},
    "air": {"img_names", "qid", "repeat_id", "performance",
            "X", "Y", "T", "length"},
    "coco": {"img_names", "task", "repeat_id", "X", "Y", "T", "length"},
}


def sha256_of(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def _missing(paths: dict) -> list:
    return [f"{k}: {v}" for k, v in paths.items() if not exists(v)]


def released_geometry(sd: dict) -> dict:
    """The model geometry a reference-layout state dict holds: the embed
    width (``sal_conv``), the action map (the spatial-attention conv's
    [1, 1, H, W] kernel) and the trunk's blocks a stage
    (``resnet.4-7.<block>``)."""
    blocks = {}
    for key in sd:
        parts = key.split(".")
        if parts[0] == "resnet" and parts[1] in ("4", "5", "6", "7"):
            blocks[parts[1]] = max(blocks.get(parts[1], 0),
                                   int(parts[2]) + 1)
    map_h, map_w = sd["spatial_att.spatial_attention.weight"].shape[-2:]
    return dict(embed=int(sd["sal_conv.weight"].shape[0]), map_h=int(map_h),
                map_w=int(map_w),
                backbone_layers=tuple(blocks[s] for s in "4567"))


def port_released_checkpoint(path: str, task: str, report: dict):
    """Loads a released full-model ``checkpoint_best.pth`` (the reference
    layout: a bare state dict or ``{"model": ...}``, ``module.``
    prefixes allowed) into ``task``'s model of the geometry it holds
    (``models/port.py::load_reference_state_dict``, then a strict
    ``load_state_dict``) and records its sha256 and parameter count in
    ``report["released_checkpoint"]``.  Returns the model (on the CPU, in
    eval mode), or None with the error recorded."""
    from ..models.port import load_reference_state_dict
    from ..models.scanpath_model import ScanpathModel

    try:
        sd = torch.load(path, map_location="cpu")
        sd = sd.get("model", sd)
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
        geo = released_geometry(sd)
        model = ScanpathModel(task, **geo)
        model.load_state_dict(load_reference_state_dict(sd, task))
        report["released_checkpoint"] = {
            "path": path, "sha256": sha256_of(path),
            "ported_params": sum(p.numel() for p in model.parameters()),
            "geometry": geo, "ok": True}
        return model.eval()
    except Exception as e:  # noqa: BLE001 — reported, and main returns 1
        report["released_checkpoint"] = {"path": path, "ok": False,
                                         "error": repr(e)[:300]}
        return None


def _base_args(task: str, workdir: str, a) -> list:
    argv = [
        "--task", task,
        "--log_root", join(workdir, "logs"),
        "--batch", str(a.batch),
        "--eval_repeat_num", str(a.eval_repeat_num),
        "--epoch", "2", "--start_rl_epoch", "1", "--warmup_epoch", "1",
        "--device_eval", str(a.device_eval),
        "--half_precision", "true",
        "--packed_cache_dir", join(workdir, "packed"),
        "--cache_images", "false",
        "--backbone_layers", a.backbone_layers,
        "--embed", str(a.embed),
    ]
    argv += a.extra
    if a.trunk and exists(a.trunk):
        argv += ["--checkpoint", a.trunk]
    return argv


def run_task_smoke(task: str, data_argv: list, workdir: str, a,
                   report: dict):
    """Steps 4-5: ``--steps`` supervised steps of the ``Trainer``, one
    validation sweep, a checkpoint triad, then ``cli/test.py`` on the run
    and the prediction records' schema against the reference's."""
    from ..cli import test as test_cli
    from ..core.config import parse_opt
    from ..data.prefetch import prefetch
    from ..models.port import to_reference_state_dict
    from ..train import steps, tp_step
    from ..train.trainer import Trainer

    device = torch.device(a.device)
    args = parse_opt(_base_args(task, workdir, a) + data_argv)
    np.random.seed(args.seed)
    trainer = Trainer(args, device)
    trainer.model.train()
    n, losses = 0, []
    while n < a.steps:
        for db in prefetch(trainer.train_loader, functools.partial(
                steps.device_batch, device=device, for_rl=False), depth=2):
            losses.append(float(steps.supervised_step(
                trainer.state, db, args.lambda_1)["loss"]))
            n += 1
            if n >= a.steps:
                break
    report["train_steps"] = n
    report["loss_first"] = round(float(np.mean(losses[:5])), 4)
    report["loss_last"] = round(float(np.mean(losses[-5:])), 4)

    cur = (trainer.validation_device(n) if args.device_eval
           else trainer.validation(n))
    sel = trainer.selection_metric(cur)
    report["validation_selection_metric"] = round(float(sel), 4)

    # a checkpoint triad for cli/test.py to load, then its run
    model_state = to_reference_state_dict(
        tp_step.full_state_dict(trainer.model), task, trainer.model.map_h,
        trainer.model.map_w)
    trainer.checkpoint_manager.step(
        sel, model_state,
        tp_step.full_optimizer_state(trainer.state.optimizer))
    trainer.record_manager.save(0, n, sel)
    trainer.close_run()
    test_cli.main(_base_args(task, workdir, a) + data_argv
                  + ["--evaluation_dir", trainer.log_dir,
                     "--device", a.device])
    name = ("validation_predicts.json" if task == "coco"
            else "test_predicts.json")
    with open(join(trainer.log_dir, name)) as f:
        recs = json.load(f)
    got = set(recs[0]) if recs else set()
    want = REFERENCE_PREDICT_SCHEMA[task]
    report["predict_artifact"] = name
    report["predict_schema_ok"] = got == want
    if got != want:
        report["predict_schema_diff"] = {
            "missing": sorted(want - got), "extra": sorted(got - want)}


def _released(ckpt: str, task: str, report: dict) -> bool:
    """Whether the section goes on: no released checkpoint, or one that
    loads."""
    return not exists(ckpt) or \
        port_released_checkpoint(ckpt, task, report) is not None


def smoke_osie(root: str, workdir: str, a) -> dict:
    report = {"task": "osie"}
    inputs = {"fixations.mat": a.osie_mat or join(root, "osie",
                                                  "fixations.mat"),
              "stimuli": a.osie_stimuli or join(root, "osie", "stimuli")}
    missing = _missing(inputs)
    if missing:
        return dict(report, skipped=True, missing=missing)
    from ..data.preprocess import preprocess_osie

    fix_out = join(workdir, "osie_fixations")
    preprocess_osie(inputs["fixations.mat"], fix_out)
    sizes = {}
    for s in ("train", "validation", "test"):
        with open(join(fix_out, f"osie_fixations_{s}.json")) as f:
            sizes[s] = len(json.load(f))
    report["preprocess_records"] = sizes
    if _released(join(root, "osie", "checkpoint_best.pth"), "osie", report):
        run_task_smoke("osie", ["--img_dir", inputs["stimuli"],
                                "--fix_dir", fix_out], workdir, a, report)
    return report


def smoke_air(root: str, workdir: str, a) -> dict:
    report = {"task": "air"}
    d = join(root, "air")
    inputs = {
        "consolidated_answers.json": join(d, "consolidated_answers.json"),
        "val_balanced_questions.json": join(d,
                                            "val_balanced_questions.json"),
        "val_sceneGraphs.json": join(d, "val_sceneGraphs.json"),
        "fixations": join(d, "fixations"),
        "images": join(d, "images"),
        "attention": join(d, "attention"),
    }
    missing = _missing(inputs)
    if missing:
        return dict(report, skipped=True, missing=missing)
    from ..data.preprocess import preprocess_air

    fix_out = join(workdir, "air_fixations")
    preprocess_air(inputs["consolidated_answers.json"],
                   inputs["val_balanced_questions.json"],
                   inputs["val_sceneGraphs.json"], inputs["fixations"],
                   inputs["images"], fix_out)
    sizes = {}
    for s in ("train", "validation", "test"):
        with open(join(fix_out, f"AiR_fixations_{s}.json")) as f:
            sizes[s] = len(json.load(f))
    report["preprocess_records"] = sizes
    if _released(join(d, "checkpoint_best.pth"), "air", report):
        run_task_smoke("air", ["--img_dir", inputs["images"],
                               "--fix_dir", fix_out,
                               "--att_dir", inputs["attention"]],
                       workdir, a, report)
    return report


def smoke_coco(root: str, workdir: str, a) -> dict:
    report = {"task": "coco"}
    d = join(root, "coco")
    inputs = {
        "images": join(d, "images"),
        "fixations": join(d, "fixations"),
        "detector": join(d, "detectors", "coco_search18_detector.json"),
    }
    missing = _missing(inputs)
    if missing:
        return dict(report, skipped=True, missing=missing)
    report["preprocess_records"] = "n/a (COCO ships upstream splits)"
    if _released(join(d, "checkpoint_best.pth"), "coco", report):
        run_task_smoke("coco", ["--img_dir", inputs["images"],
                                "--fix_dir", inputs["fixations"],
                                "--detector_dir", join(d, "detectors")],
                       workdir, a, report)
    return report


def failed(report: dict) -> bool:
    """Whether a task's report holds a failure: an error raised, a
    released checkpoint that did not load, or a prediction schema that
    differs from the reference's."""
    return ("error" in report
            or report.get("released_checkpoint", {}).get("ok") is False
            or report.get("predict_schema_ok") is False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default="./real_data")
    ap.add_argument("--task", default="all",
                    choices=("all", "osie", "air", "coco"))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--eval_repeat_num", type=int, default=2)
    ap.add_argument("--device_eval", default="true",
                    help="validation/metric sweep on device (str2bool)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--trunk", default="",
                    help="resnet50-19c8e357.pth path (default "
                         "<root>/resnet50-19c8e357.pth)")
    ap.add_argument("--osie_mat", default="")
    ap.add_argument("--osie_stimuli", default="")
    ap.add_argument("--backbone_layers", default="3,4,6,3",
                    help="thin-trunk override for wire tests")
    ap.add_argument("--embed", type=int, default=512)
    ap.add_argument("--workdir", default="")
    ap.add_argument("--out", default="REAL_DATA_SMOKE.json")
    ap.add_argument("extra", nargs="*", default=[],
                    help="extra flags forwarded verbatim to the train/"
                         "test CLIs (geometry overrides for wire tests)")
    a = ap.parse_args(sys.argv[1:] if argv is None else argv)

    out = {"root": os.path.abspath(a.root), "tasks": []}
    a.trunk = a.trunk or join(a.root, "resnet50-19c8e357.pth")
    if exists(a.trunk):
        from ..models.resnet import verify_torchvision_sha

        out["trunk"] = {"path": a.trunk,
                        "sha_ok": verify_torchvision_sha(a.trunk)}
        if not out["trunk"]["sha_ok"]:
            print(json.dumps({"error": "trunk sha256 mismatch",
                              "path": a.trunk}))
            return 1
    else:
        out["trunk"] = {"path": a.trunk, "skipped": True,
                        "note": "absent — training starts from the "
                                "reference init scheme instead"}
        a.trunk = ""

    workdir = a.workdir or tempfile.mkdtemp(prefix="sp_real_smoke_")
    runners = {"osie": smoke_osie, "air": smoke_air, "coco": smoke_coco}
    tasks = list(runners) if a.task == "all" else [a.task]
    for t in tasks:
        try:
            out["tasks"].append(runners[t](a.root, workdir, a))
        except Exception as e:  # noqa: BLE001 — reported, and main returns 1
            out["tasks"].append({"task": t, "ok": False,
                                 "error": repr(e)[:500]})
    out["all_skipped"] = all(r.get("skipped") for r in out["tasks"])
    with open(a.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out), flush=True)
    return 1 if any(failed(r) for r in out["tasks"]) else 0


if __name__ == "__main__":
    raise SystemExit(main())
