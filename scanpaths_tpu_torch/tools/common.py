"""What the measuring tools share: the flags, the geometry, the seeded
OSIE model, the training flags of the benchmarks and the timing.

Each tool's ``main`` turns TF32 off (:func:`no_tf32`).  Timing: every
timed iteration ends in a host read of a device scalar
that depends on the iteration's work (a loss, or
``ops/sampling.py::sample_checksum`` of a decode), so a time is the
work's and never a launch's alone.
"""

from __future__ import annotations

import argparse
import json
import math
import time
import types

import numpy as np
import torch

# the reference geometry (240x320 images, a 30x40 action map, T = 16,
# ResNet-50 and embed 512), and the tiny one the CPU tests run
FULL = dict(height=240, width=320, map_h=30, map_w=40, seq_len=16,
            embed=512, layers=(3, 4, 6, 3))
TINY = dict(height=80, width=96, map_h=10, map_w=12, seq_len=4, embed=64,
            layers=(1, 1, 1, 1))


def parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--tiny", action="store_true",
                   help="the tests' tiny geometry (80x96 images, a 10x12 "
                        "map, T = 4, embed 64, one block a stage)")
    return p


def no_tf32() -> None:
    """float32 means float32: no TF32 in cuBLAS or cuDNN (the port's
    float32 numbers are all taken so; the MFU's float32 peak is the
    plain FMA rate)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def geometry(args) -> dict:
    return dict(TINY if args.tiny else FULL)


def flop_geometry(geo: dict) -> dict:
    """``geo`` as ``flops.model_flops_parts`` takes it."""
    return dict(h=geo["height"], w=geo["width"], t=geo["seq_len"],
                embed=geo["embed"], layers=geo["layers"])


def grid_spec(geo: dict):
    from ..core.grid import GridSpec
    return GridSpec(map_width=geo["map_w"], map_height=geo["map_h"],
                    width=geo["width"], height=geo["height"],
                    max_length=geo["seq_len"])


def osie_model(geo: dict, device, dtype=torch.float32, seed: int = 0,
               calibrated: bool = False):
    """The OSIE model of ``geo`` with weights from ``seed``, on
    ``device``; ``calibrated``: with :func:`calibrate_duration_head`."""
    from ..models.scanpath_model import ScanpathModel, init_weights
    model = ScanpathModel("osie", embed=geo["embed"], seq_len=geo["seq_len"],
                          map_h=geo["map_h"], map_w=geo["map_w"],
                          backbone_layers=geo["layers"], dtype=dtype)
    init_weights(model, seed)
    if calibrated:
        calibrate_duration_head(model)
    return model.to(device)


@torch.no_grad()
def calibrate_duration_head(model, median_s: float = 0.25,
                            sigma2: float = 0.3) -> None:
    """The duration head set to emit the durations of a trained model
    (``bench.py::calibrate_duration_head``): the last conv's kernel
    zeroed and its bias set to [log(median_s), log(sigma2)].  At seed
    weights its LogNormal scale overflows float32 in the sampler; every
    shape, parameter and timed op stays the same."""
    model.head.drt_layer_2.weight.zero_()
    model.head.drt_layer_2.bias.copy_(torch.tensor(
        np.log([median_s, sigma2]), dtype=torch.float32))


def train_flags(bf16_moments: bool = False):
    """The benchmarks' training flags (the JAX tools'): lr 1e-4, clip
    12.5, weight decay 5e-4, a warmup of 1 of 10 epochs, SCST from 5."""
    return types.SimpleNamespace(
        lr=1e-4, clip=12.5, weight_decay=5e-4, warmup_epoch=1,
        start_rl_epoch=5, epoch=10, rl_lr_initial_decay=0.5,
        bf16_moments=bf16_moments)


def sync(x) -> float:
    """The host value of the device scalar ``x`` (waits for its work)."""
    return float(x.detach().float().cpu()) if torch.is_tensor(x) \
        else float(x)


def timed(fn, iters: int, warmup: int = 2, reduce=np.mean) -> float:
    """Seconds an iteration of ``fn`` (which returns a device scalar)
    takes, each iteration read on the host; ``reduce`` over the
    iterations (mean or median)."""
    for _ in range(warmup):
        sync(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        sync(fn())
        times.append(time.perf_counter() - t0)
    return float(reduce(times))


def emit(record: dict) -> dict:
    """Print ``record`` as one JSON line; raises on a non-finite
    number."""
    def walk(v):
        if isinstance(v, dict):
            return all(walk(x) for x in v.values())
        if isinstance(v, (list, tuple)):
            return all(walk(x) for x in v)
        return not isinstance(v, float) or math.isfinite(v)
    if not walk(record):
        raise ValueError(f"non-finite number in {record}")
    print(json.dumps(record), flush=True)
    return record


def random_images(n: int, geo: dict, device, seed: int = 42):
    """[n, height, width, 3] float32 standard normal images drawn on
    ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n, geo["height"], geo["width"], 3), generator=gen,
                       device=device)


def supervised_batch(images, geo: dict, seed: int = 7) -> dict:
    """A supervised batch over ``images``: one-hot target actions drawn
    uniformly, durations in [0.1, 0.6) s, every step masked in."""
    n, dev = images.shape[0], images.device
    t = geo["seq_len"]
    a = geo["map_h"] * geo["map_w"] + 1
    gen = torch.Generator(device=dev).manual_seed(seed)
    idx = torch.randint(0, a, (n, t), generator=gen, device=dev)
    return {"images": images,
            "scanpaths": torch.nn.functional.one_hot(idx, a).float(),
            "durations": 0.1 + 0.5 * torch.rand((n, t), generator=gen,
                                                device=dev),
            "action_masks": torch.ones((n, t), device=dev),
            "duration_masks": torch.ones((n, t), device=dev)}


def rl_batch(images, geo: dict, subjects: int = 15, length: int = 24,
             seed: int = 0) -> dict:
    """An SCST batch over ``images``: ``subjects`` GT scanpaths of
    ``length`` uniform fixations of 0.1-0.5 s each (the JAX tools')."""
    n = images.shape[0]
    rng = np.random.default_rng(seed)
    fix = np.zeros((n, subjects, length, 3), np.float32)
    fix[..., 0] = rng.uniform(0, geo["width"], (n, subjects, length))
    fix[..., 1] = rng.uniform(0, geo["height"], (n, subjects, length))
    fix[..., 2] = rng.uniform(0.1, 0.5, (n, subjects, length))
    dev = images.device
    return {"images": images, "gt_fix": torch.as_tensor(fix, device=dev),
            "gt_len": torch.full((n, subjects), length, dtype=torch.int32,
                                 device=dev),
            "gt_mask": torch.ones((n, subjects), device=dev)}


def is_oom(e: BaseException) -> bool:
    return isinstance(e, torch.OutOfMemoryError) or \
        "out of memory" in str(e).lower()
