"""Training entry point of the PyTorch port:

    python -m scanpaths_tpu_torch.cli.train --task osie|air|coco \\
        --img_dir DIR --fix_dir DIR \\
        [--att_dir DIR (air) | --detector_dir DIR (coco)] \\
        [--epoch 10 --start_rl_epoch 5] [--device_eval true] \\
        [--resume_dir RUN] [--half_precision true] [--device cuda]
    python -m scanpaths_tpu_torch.cli.train --task joint \\
        --joint_data_root ROOT [the same options]
    torchrun --nproc_per_node N -m scanpaths_tpu_torch.cli.train \\
        [the same options] --mesh_size 0

A supervised phase, then SCST from ``--start_rl_epoch``, a validation
after every epoch, and the run directory ``<log_root>/log_<date>``
(``train/trainer.py``); ``--task joint`` trains one shared trunk with the
three task heads round-robin over ``ROOT/{osie,air,coco}``
(``train/joint.py``, run directory ``<log_root>/log_joint_<date>``).
``--device`` (default ``cuda``) is this CLI's own flag; with no card it
raises unless ``--device cpu`` is given.  Under torchrun the run is data
parallel over its ranks, one process each (``train/mesh.py``):
``--mesh_size`` is 0 or torchrun's world size, ``--batch`` the global
batch, each rank on ``cuda:LOCAL_RANK`` (ranks that share a card talk
over gloo, the others over NCCL).  A failed rank or collective fails the
command.  Every other flag is
``core/config.py::parse_opt``'s (the reference opts.py flags); the ones
the port does not have raise
(``train/trainer.py::check_ported_flags``).  Returns the best selection
metric.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.config import parse_opt
from ..train import mesh
from ..train.joint import JointTrainer
from ..train.trainer import Trainer


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda")
    ns, rest = pre.parse_known_args(argv)
    args = parse_opt(rest)
    device = torch.device(ns.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but no CUDA device is available; "
                           "pass --device cpu to run on the CPU")
    m = mesh.make_mesh(args, device)
    np.random.seed(args.seed)
    trainer = (JointTrainer if args.task == "joint" else Trainer)(args,
                                                                  m.device)
    best = trainer.fit()
    trainer.logger.info(f"Training complete; best metric {best}")
    mesh.close_mesh(m)
    return best


if __name__ == "__main__":
    main()
