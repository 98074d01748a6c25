"""The model and decoders that ``cli/predict.py`` serves.

:class:`Predictor` builds the OSIE :class:`ScanpathModel` from the
parsed flags on an explicit device, loads its weights from a
reference-layout torch checkpoint (``<evaluation_dir>/checkpoints/
checkpoint_best.pth``, the reference's own best-model file) or, with no
``--evaluation_dir``, makes them from ``--seed``, and decodes the eval
forward's distributions greedily or by sampling.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..core.grid import GridSpec
from ..models.port import load_reference_state_dict
from ..models.scanpath_model import ScanpathModel, init_weights
from ..ops.sampling import SampleOut, greedy_sample, random_sample


def checkpoint_path(evaluation_dir: str) -> str:
    return os.path.join(evaluation_dir, "checkpoints", "checkpoint_best.pth")


class Predictor:
    def __init__(self, args, device):
        self.args = args
        self.device = torch.device(device)
        self.grid = GridSpec(map_width=args.map_width,
                             map_height=args.map_height, width=args.width,
                             height=args.height, max_length=args.max_length,
                             min_length=args.min_length)
        layers = tuple(int(v) for v in str(args.backbone_layers).split(","))
        self.model = ScanpathModel(
            args.task, embed=args.embed, seq_len=args.max_length,
            map_h=args.map_height, map_w=args.map_width,
            backbone_layers=layers,
            dtype=torch.bfloat16 if args.half_precision else torch.float32)
        if args.evaluation_dir:
            path = checkpoint_path(args.evaluation_dir)
            if not os.path.isfile(path):
                raise FileNotFoundError(
                    f"{path}: no reference-layout torch checkpoint (flax "
                    "msgpack checkpoints of the JAX package are not read "
                    "by the port yet)")
            ckpt = torch.load(path, map_location="cpu", weights_only=True)
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
        """NHWC float32 images [N, height, width, 3], attention maps
        [N, map_h, map_w, 1] (AiR, COCO; zeroed under
        ``--ablate_attention_info``) and task ids [N] (COCO), as numpy
        arrays -> the eval output dict, on the device."""
        if attention_maps is not None and self.args.ablate_attention_info:
            attention_maps = np.zeros_like(attention_maps)

        def dev(a):
            return None if a is None else torch.from_numpy(
                np.asarray(a)).to(self.device)
        return self.model(dev(images), dev(attention_maps), dev(task_ids))

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
