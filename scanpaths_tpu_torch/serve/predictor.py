"""The model and decoders that ``cli/predict.py`` serves.

:class:`Predictor` builds the OSIE :class:`ScanpathModel` from the
parsed flags on an explicit device, loads its weights from a
reference-layout torch checkpoint (``<evaluation_dir>/checkpoints/
checkpoint_best.pth``, the reference's own best-model file; of a joint
run, whose ``hparams.json`` says ``joint``, the ``--task`` head taken out
of the joint layout) or, with no ``--evaluation_dir``, makes them from
``--seed``, and decodes the eval forward's distributions greedily or by
sampling.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ..core.grid import GridSpec
from ..models.port import (load_reference_state_dict,
                           task_reference_state_dict)
from ..models.scanpath_model import init_weights, model_from_flags
from ..ops.sampling import SampleOut, greedy_sample, random_sample


def checkpoint_path(evaluation_dir: str) -> str:
    return os.path.join(evaluation_dir, "checkpoints", "checkpoint_best.pth")


def trained_task(log_dir: str, task: str) -> str:
    """The task a run directory was trained for: its ``hparams.json``'s
    ``task`` (``joint`` for a joint run), else ``task``."""
    path = os.path.join(log_dir, "hparams.json")
    if not os.path.exists(path):
        return task
    with open(path) as f:
        return json.load(f).get("task", task)


def eval_forward(model, device, ablate_attention: bool, images,
                 attention_maps=None, task_ids=None) -> dict:
    """NHWC float32 images [N, height, width, 3], attention maps
    [N, map_h, map_w, 1] (AiR, COCO; zeroed under ``ablate_attention``,
    the ``--ablate_attention_info`` flag) and task ids [N] (COCO), as
    numpy arrays -> the model's eval output dict, on ``device``."""
    if attention_maps is not None and ablate_attention:
        attention_maps = np.zeros_like(attention_maps)

    def dev(a):
        return None if a is None else torch.from_numpy(
            np.asarray(a)).to(device)
    return model(dev(images), dev(attention_maps), dev(task_ids))


class Predictor:
    def __init__(self, args, device):
        self.args = args
        self.device = torch.device(device)
        self.grid = GridSpec(map_width=args.map_width,
                             map_height=args.map_height, width=args.width,
                             height=args.height, max_length=args.max_length,
                             min_length=args.min_length)
        self.model = model_from_flags(args)
        if args.evaluation_dir:
            path = checkpoint_path(args.evaluation_dir)
            if not os.path.isfile(path):
                raise FileNotFoundError(
                    f"{path}: no reference-layout torch checkpoint (flax "
                    "msgpack checkpoints of the JAX package are not read "
                    "by the port yet)")
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
            if trained_task(args.evaluation_dir, args.task) == "joint":
                ckpt = task_reference_state_dict(ckpt, args.task)
            self.model.load_state_dict(
                load_reference_state_dict(ckpt, args.task))
        else:
            print(f"[predict] no --evaluation_dir: weights made from seed "
                  f"{args.seed}", file=sys.stderr)
            init_weights(self.model, args.seed)
        self.model.to(self.device).eval()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(args.seed)

    def forward(self, images: np.ndarray, attention_maps=None,
                task_ids=None) -> dict:
        return eval_forward(self.model, self.device,
                            self.args.ablate_attention_info, images,
                            attention_maps, task_ids)

    def decode(self, out: dict, decode: str, num_samples: int,
               stream: str | None = None) -> SampleOut:
        """Greedy (one scanpath per image) or ``num_samples`` sampled
        scanpaths per image, from the outputs of ``stream`` (the AiR
        ``good``/``poor`` prefix; None for one-stream tasks); every leaf
        leads with the [R] rollout axis."""
        pre = f"{stream}_" if stream else ""
        probs = out[pre + "all_actions_prob"]
        mu = out[pre + "log_normal_mu"]
        sigma2 = out[pre + "log_normal_sigma2"]
        if decode == "greedy":
            s = greedy_sample(probs, mu, sigma2, self.grid)
            return SampleOut(*(v[None] for v in s))
        return random_sample(probs, mu, sigma2, self.grid, self.generator,
                             rollouts=num_samples)
