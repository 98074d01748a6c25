"""The evaluation half of the training driver (port of the eval parts of
``scanpaths_tpu/train/trainer.py``): the geometry and data settings
from the flags, the static ScanMatch specs of the device sweep, the
reference-format metric printout, and the :class:`Evaluator` behind
``cli/test.py``.  The training classes wait for the training slice.
"""

from __future__ import annotations

import json
import os
from os.path import join

import numpy as np
import torch

from ..core.grid import GridSpec
from ..data.datasets import DataConfig
from ..metrics import torch_metrics as tm
from ..serve.predictor import Predictor
from ..utils.logger import Logger, task_log_level


def data_config(args) -> DataConfig:
    att_dir = args.att_dir if args.task == "air" else args.detector_dir
    return DataConfig(
        img_dir=args.img_dir, fix_dir=args.fix_dir, att_dir=att_dir,
        action_map=(args.map_height, args.map_width),
        resize=(args.height, args.width),
        detector_threshold=args.detector_threshold,
        coco_split=args.coco_split, cache_images=args.cache_images,
        packed_cache_dir=args.packed_cache_dir or None)


def grid_spec(args) -> GridSpec:
    return GridSpec(map_width=args.map_width, map_height=args.map_height,
                    width=args.width, height=args.height,
                    max_length=args.max_length, min_length=args.min_length)


def eval_specs(ds, grid: GridSpec):
    """Static ScanMatch specs for the device sweep, table bounds derived
    from the split: the w/-duration table holds
    ``ceil(max(wd_symbols_needed, 256) / 64) * 64`` symbols, the
    w/o-duration table ``max(T, pad_gt_len)``.  Sampled rollouts whose
    TempBin expansion passes the w/-duration bound are prefix-truncated
    (durations are unbounded LogNormals) and counted by the
    ``DeviceSweep`` overflow counter.  The bins are the FIXED evaluation
    protocol (16x12 over 320x240, reference AiR/train.py:216-218), not
    the configured image geometry, as in the host suite."""
    max_wd = int(np.ceil(max(ds.wd_symbols_needed, 256) / 64) * 64)
    spec_wd = tm.ScanMatchSpec(temp_bin=50.0, max_symbols=max_wd)
    spec_wod = tm.ScanMatchSpec(
        temp_bin=0.0, max_symbols=max(grid.max_length, ds.pad_gt_len))
    return spec_wd, spec_wod


def log_metric_tree(logger, metrics, stds):
    """Reference-format metric printout (``<group>-<metric>: m +- s``
    rows, reference OSIE/train.py:326-338)."""
    def walk(m, s, prefix):
        for k, v in m.items():
            if isinstance(v, dict):
                walk(v, s[k], prefix + [k])
            else:
                logger.info(f"{'-'.join(prefix):24}-{k:15}: {v:.4f} "
                            f"+- {s[k]:.4f}")
    walk(metrics, stds, [])


class Evaluator:
    """Inference-only driver for ``cli/test.py``: the model with the
    run's best checkpoint (``<log_dir>/checkpoints/checkpoint_best.pth``,
    reference layout, loaded by ``serve/predictor.py``) on an explicit
    device, and the logger of ``<log_dir>/log_test.txt``."""

    def __init__(self, args, log_dir: str, device):
        self.grid = grid_spec(args)
        self.device = torch.device(device)
        self.logger = Logger(join(log_dir, "log_test.txt"),
                             level=task_log_level(args.task))
        hp_path = join(log_dir, "hparams.json")
        if os.path.exists(hp_path):
            with open(hp_path) as f:
                if json.load(f).get("task", args.task) == "joint":
                    raise NotImplementedError(
                        "joint checkpoints are not ported")
        # the predictor loads the best checkpoint of --evaluation_dir
        run_args = type(args)(**{**vars(args), "evaluation_dir": log_dir})
        self.predictor = Predictor(run_args, self.device)

    def decode_batch_device(self, batch, repeat_num: int,
                            streams=(None,)):
        """One eval forward of a host batch (with its attention maps and
        task ids), then
        ``repeat_num`` stochastic decodes of each stream in ``streams``
        (``"good"``/``"poor"`` read the AiR outputs of that prefix; the
        eval forward is deterministic, so both streams come from one
        forward).  Returns the batch's GT as device tensors (``gt_fix``,
        ``gt_len``, ``gt_mask``) and the samples of each stream ([R, N,
        ...] leaves, on the device), which the device sweep consumes as
        they are."""
        db = {k: torch.as_tensor(batch[k], device=self.device)
              for k in ("gt_fix", "gt_len", "gt_mask")}
        out = self.predictor.forward(batch["images"],
                                     batch.get("attention_maps"),
                                     batch.get("tasks"))
        return db, [self.predictor.decode(out, "sample", repeat_num, stream)
                    for stream in streams]
