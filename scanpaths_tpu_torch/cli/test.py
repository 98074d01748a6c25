"""Test entry point of the PyTorch port (OSIE): load checkpoint_best,
print the human baseline, sample ``eval_repeat_num`` scanpaths per
image, write the prediction JSON, print the metric tree.

    python -m scanpaths_tpu_torch.cli.test --task osie \\
        --evaluation_dir RUN --img_dir DIR --fix_dir DIR \\
        [--device_eval true] [--half_precision true] [--device cuda]

``RUN/checkpoints/checkpoint_best.pth`` is a reference-layout torch
checkpoint.  The test split is ``osie_fixations_test.json`` under
``--fix_dir``; the predictions go to ``RUN/test_predicts.json`` and the
log to ``RUN/log_test.txt``.  With ``--device_eval true`` every pairwise
metric is computed on the device (``metrics/device_eval.py``); otherwise
the host suite (``metrics/evaluation.py``) scores the predictions.
``--device`` (default ``cuda``) is this CLI's own flag; with no card it
raises unless ``--device cpu`` is given.  Every other flag is
``core/config.py::parse_opt``'s.
"""

from __future__ import annotations

import argparse
import json
from os.path import join

import numpy as np
import torch

from ..core.config import parse_opt
from ..data.datasets import EvaluationDataset, Loader
from ..metrics import evaluation as heval
from ..metrics.device_eval import DeviceSweep, human_evaluation_device
from ..ops.sampling import to_fix_vectors
from ..train.trainer import Evaluator, data_config, eval_specs, log_metric_tree


def dump_record(img_name, fix_vector, trial):
    arr = np.array(fix_vector.tolist()).reshape(-1, 3)
    rec = {"name": img_name, "repeat_id": trial + 1,
           "X": list(map(float, arr[:, 0])),
           "Y": list(map(float, arr[:, 1])),
           "T": list(map(float, arr[:, 2] * 1000))}
    rec["length"] = len(rec["X"])
    return rec


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    ns, rest = pre.parse_known_args(argv)
    args = parse_opt(rest)
    if args.task != "osie":
        raise NotImplementedError(f"--task {args.task}: only osie is ported")
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    log_dir = args.evaluation_dir or args.resume_dir
    if not log_dir:
        raise ValueError("--evaluation_dir (the training log dir) is "
                         "required")
    evaluator = Evaluator(args, log_dir, device)
    loader = Loader(EvaluationDataset(args.task, data_config(args),
                                      split="test"),
                    batch_size=args.batch)

    repeat = args.eval_repeat_num
    sweep = None
    if args.device_eval:
        spec_wd, spec_wod = eval_specs(loader.dataset, evaluator.grid)
        sweep = DeviceSweep(spec_wd, spec_wod)
        human_metrics, human_std, _ = human_evaluation_device(
            loader, spec_wd, spec_wod, task=args.task, device=device)
    else:
        human_metrics, human_std, _ = heval.human_evaluation(loader,
                                                             task=args.task)
    evaluator.logger.info("The metrics for human performance are: ")
    log_metric_tree(evaluator.logger, human_metrics, human_std)

    all_gt, all_pred, predict_results = [], [], []
    for batch in loader:
        n = len(batch["fix_vectors"])
        db, samples = evaluator.decode_batch_device(batch, repeat)
        preds = to_fix_vectors(samples)              # repeat-major [R*N]
        for r in range(repeat):
            if sweep is not None:
                # pairwise metrics stay on the device; the host only
                # aggregates (metrics/device_eval.py)
                sweep.add_batch(db["gt_fix"], db["gt_len"], db["gt_mask"],
                                samples.fix[r], samples.fix_len[r])
            else:
                all_gt.extend(batch["fix_vectors"])
                all_pred.extend(preds[r * n:(r + 1) * n])
            for i in range(n):
                predict_results.append(dump_record(
                    batch["img_names"][i], preds[r * n + i], r))

    if sweep is not None:
        cur_metrics, cur_std = sweep.result()
        sweep.log_overflow(evaluator.logger)
    else:
        cur_metrics, cur_std, _ = heval.evaluation(all_gt, all_pred)

    with open(join(log_dir, "test_predicts.json"), "w") as f:
        json.dump(predict_results, f, indent=2)

    evaluator.logger.info("The metrics for best model performance are: ")
    log_metric_tree(evaluator.logger, cur_metrics, cur_std)
    return cur_metrics


if __name__ == "__main__":
    main()
