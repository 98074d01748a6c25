"""Test entry point of the PyTorch port: load checkpoint_best, print the
human baseline, sample ``eval_repeat_num`` scanpaths per image (per
stream for AiR), write the prediction JSON, print the metric tree.

    python -m scanpaths_tpu_torch.cli.test --task osie|air|coco \\
        --evaluation_dir RUN --img_dir DIR --fix_dir DIR \\
        [--att_dir DIR (air) | --detector_dir DIR (coco)] \\
        [--device_eval true] [--half_precision true] [--device cuda]

``RUN/checkpoints/checkpoint_best.pth`` is a reference-layout torch
checkpoint; of a joint run (``--task joint`` in ``RUN/hparams.json``) the
``--task`` head is evaluated (``--task joint`` itself raises: one task at
a time).  OSIE and AiR evaluate their test split and write
``RUN/test_predicts.json``; COCO evaluates its validation split (it has
no public test split, reference COCO_Search18/test.py:67-68) and writes
``RUN/validation_predicts.json``; the log goes to ``RUN/log_test.txt``.
AiR runs one eval forward per batch and decodes both of its streams
(good, then poor) from it.  With ``--device_eval true`` every pairwise
metric is computed on the device (``metrics/device_eval.py``); otherwise
the host suite (``metrics/evaluation.py``) scores the predictions,
bucketed by answer correctness for AiR.  The loop is the trainer's
validation loop (``train/trainer.py::EvalCore.evaluate``).  ``--device`` (default ``cuda``)
is this CLI's own flag; with no card it raises unless ``--device cpu``
is given.  Every other flag is ``core/config.py::parse_opt``'s.
"""

from __future__ import annotations

import argparse
import json
from os.path import join

import numpy as np
import torch

from ..core.config import parse_opt
from ..data.datasets import EvaluationDataset, Loader
from ..train.trainer import Evaluator, data_config, log_metric_tree


def dump_record(img_name, fix_vector, trial, extra=None):
    """A prediction record in the reference schema; AiR and COCO records
    carry their ``extra`` fields and name the image ``img_names``, as the
    reference's do."""
    rec = {"img_names" if extra else "name": img_name}
    rec.update(extra or {})
    arr = np.array(fix_vector.tolist()).reshape(-1, 3)
    rec["repeat_id"] = trial + 1
    rec["X"] = list(map(float, arr[:, 0]))
    rec["Y"] = list(map(float, arr[:, 1]))
    rec["T"] = list(map(float, arr[:, 2] * 1000))
    rec["length"] = len(rec["X"])
    return rec


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    ns, rest = pre.parse_known_args(argv)
    args = parse_opt(rest)
    if args.task == "joint":
        raise ValueError(
            "evaluate a joint run one task at a time: point "
            "--evaluation_dir at the joint log dir and pass --task "
            "osie|air|coco — the Evaluator detects the joint checkpoint "
            "from the run's hparams.json and loads the matching head")
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    log_dir = args.evaluation_dir or args.resume_dir
    if not log_dir:
        raise ValueError("--evaluation_dir (the training log dir) is "
                         "required")
    evaluator = Evaluator(args, log_dir, device)
    split = "validation" if args.task == "coco" else "test"
    loader = Loader(EvaluationDataset(args.task, data_config(args),
                                      split=split),
                    batch_size=args.batch)

    human_metrics, human_std = evaluator.human_metrics(loader,
                                                       args.device_eval)
    evaluator.logger.info("The metrics for human performance are: ")
    log_metric_tree(evaluator.logger, human_metrics, human_std)

    predict_results = []

    def record(batch, flag, r, preds):
        for i, pred in enumerate(preds):
            extra = None
            if args.task == "air":
                extra = {"qid": batch["question_ids"][i], "performance": flag}
            elif args.task == "coco":
                extra = {"task": batch["task_names"][i]}
            predict_results.append(dump_record(batch["img_names"][i], pred,
                                               r, extra))
    cur_metrics, cur_std = evaluator.evaluate(loader, args.device_eval,
                                              record=record)

    with open(join(log_dir, f"{split}_predicts.json"), "w") as f:
        json.dump(predict_results, f, indent=2)

    evaluator.logger.info("The metrics for best model performance are: ")
    log_metric_tree(evaluator.logger, cur_metrics, cur_std)
    return cur_metrics


if __name__ == "__main__":
    main()
