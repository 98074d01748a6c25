"""Uniform ResNet bottleneck stages, BN folded (port of
``scanpaths_tpu/ops/pallas_block.py``).

A stage's uniform (non-downsample) blocks each compute

    y = relu(x + W3 . relu(conv3x3_dil(relu(W1 . x + b1)) + b2) + b3)

with BatchNorm folded into the weights (inference semantics).  Tensors
are dense NHWC.  :func:`stage_apply` runs the hand-written CUDA kernel
(``csrc/block.cu``) on CUDA tensors and :func:`stage_apply_plain`, the
same computation in plain PyTorch ops, on CPU tensors, both as the
registered op ``scanpaths_tpu_torch::stage_apply`` (:func:`stage_apply_op`),
which importing this module registers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, dil, w1, b1, w2, b2, w3, b3):
    if x.dim() != 4:
        raise ValueError(f"x must be [N, H, W, C], got {tuple(x.shape)}")
    c = x.shape[-1]
    nb, _, m = w1.shape if w1.dim() == 3 else (-1, -1, -1)
    want = {"w1": (w1, (nb, c, m)), "w2": (w2, (nb, 9 * m, m)),
            "w3": (w3, (nb, m, c)), "b1": (b1, (nb, m)), "b2": (b2, (nb, m)),
            "b3": (b3, (nb, c))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x is on {x.device}")
    if nb < 1:
        raise ValueError("a stage needs at least one block")
    if x.dtype not in _DTYPES:
        raise ValueError(f"dtype {x.dtype} not supported (float32, bfloat16)")
    for name, t in (("w1", w1), ("w2", w2), ("w3", w3)):
        if t.dtype != x.dtype:
            raise ValueError(f"{name} is {t.dtype}, x is {x.dtype}")
    for name, t in (("b1", b1), ("b2", b2), ("b3", b3)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
    if dil < 1:
        raise ValueError(f"dilation must be >= 1, got {dil}")


def stage_apply_plain(x, dil: int, w1, b1, w2, b2, w3, b3):
    """Plain PyTorch version of :func:`stage_apply` (same arguments)."""
    _check(x, dil, w1, b1, w2, b2, w3, b3)
    dt = x.dtype
    m = w1.shape[-1]
    for b in range(w1.shape[0]):
        t1 = torch.relu(torch.matmul(x, w1[b]).float() + b1[b]).to(dt)
        k2 = w2[b].reshape(3, 3, m, m).permute(3, 2, 0, 1)
        t2 = F.conv2d(t1.permute(0, 3, 1, 2), k2, padding=dil, dilation=dil)
        t2 = torch.relu(t2.permute(0, 2, 3, 1).float() + b2[b]).to(dt)
        x = torch.relu(torch.matmul(t2, w3[b]).float() + b3[b]
                       + x.float()).to(dt)
    return x


def _k_contiguous(w):
    """[B, K, N] -> [B, N, K], contiguous."""
    return w.transpose(1, 2).contiguous()


@torch.library.custom_op("scanpaths_tpu_torch::stage_apply",
                         mutates_args=(), device_types="cpu")
def stage_apply_op(x: torch.Tensor, dil: int, w1: torch.Tensor,
                   b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                   w3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    """The registered op behind :func:`stage_apply`.  Its CPU kernel is
    :func:`stage_apply_plain`, its CUDA kernel ``csrc/block.cu``; no
    other device has one.  Being an op, it is traced by
    ``torch.export`` as one node, so an exported program launches the
    CUDA kernel (``serve/export.py``)."""
    return stage_apply_plain(x, dil, w1, b1, w2, b2, w3, b3)


@stage_apply_op.register_kernel("cuda")
def _stage_apply_cuda(x, dil, w1, b1, w2, b2, w3, b3):
    n, h, w, c = x.shape
    nb, _, m = w1.shape
    if c % 32 or m % 32:
        raise ValueError(f"the stage kernel needs C % 32 == 0 and "
                         f"M % 32 == 0, got C={c}, M={m}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (x, w1, b1, w2, b2, w3, b3)):
        raise ValueError("the stage kernel needs contiguous, 16-byte "
                         "aligned tensors")
    # the kernel reads the weights K-contiguous: [B, M, C], [B, M, 9M],
    # [B, C, M]
    w1, w2, w3 = (_build.packed(t, _k_contiguous) for t in (w1, w2, w3))
    t1 = torch.empty((n, h, w, m), dtype=x.dtype, device=x.device)
    t2 = torch.empty_like(t1)
    bufs = (torch.empty_like(x), torch.empty_like(x))
    fn = _build.kernel("sp_bottleneck", 10, 7)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    src = x
    with torch.cuda.device(x.device):
        for b in range(nb):
            dst = bufs[b % 2]
            err = fn(src.data_ptr(), dst.data_ptr(), t1.data_ptr(),
                     t2.data_ptr(), w1[b].data_ptr(), b1[b].data_ptr(),
                     w2[b].data_ptr(), b2[b].data_ptr(), w3[b].data_ptr(),
                     b3[b].data_ptr(), n, h, w, c, m, dil,
                     _DTYPES[x.dtype], stream)
            _build.check("sp_bottleneck", err)
            src = dst
    # one a stage, whatever its number of blocks
    tracing.count("stage_apply.launches")
    return src


@stage_apply_op.register_fake
def _stage_apply_fake(x, dil, w1, b1, w2, b2, w3, b3):
    return torch.empty_like(x)


def stage_apply(x, dil: int, w1, b1, w2, b2, w3, b3):
    """Run a stack of uniform bottleneck blocks on a dense NHWC input.

    x: [N, H, W, C]; weights stacked per block, BN folded
    (``models.prepared.stack_stage_params``).
    Returns the stage output [N, H, W, C].  A CPU tensor runs
    :func:`stage_apply_plain`; a CUDA tensor runs ``csrc/block.cu``
    (C % 32 == 0, M % 32 == 0, contiguous and 16-byte aligned) or
    raises; both through :func:`stage_apply_op`.  Either raises under
    grad mode when an input requires grad (no backward; the training
    trunk is ``models.resnet``'s stock-op forward).  The kernel reads
    the weights transposed (K contiguous): the CUDA kernel's wrapper
    transposes each weight tensor once a version (``_build.packed``).
    """
    _build.refuse_grad("stage_apply", x, w1, b1, w2, b2, w3, b3)
    _check(x, dil, w1, b1, w2, b2, w3, b3)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no stage kernel for device {x.device}")
    return stage_apply_op(x, dil, w1, b1, w2, b2, w3, b3)


def stage_grid(n: int, h: int, w: int, c: int, m: int, dtype) -> list[int]:
    """[grid x, grid y, blocks per SM] of each of a block's three CUDA
    launches (reduce, 3x3, expand), flattened, at this shape (needs the
    card)."""
    return _build.grid_report("sp_bottleneck_grid", 9, n, h, w, c, m,
                              _DTYPES[dtype])
