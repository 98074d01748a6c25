"""Uniform ResNet bottleneck stages, BN folded (port of
``scanpaths_tpu/ops/pallas_block.py``).

A stage's uniform (non-downsample) blocks each compute

    y = relu(x + W3 . relu(conv3x3_dil(relu(W1 . x + b1)) + b2) + b3)

with BatchNorm folded into the weights (inference semantics).  Tensors
are dense NHWC.  :func:`stage_apply` runs the hand-written CUDA kernel
(``csrc/block.cu``) on CUDA tensors and :func:`stage_apply_plain`, the
same computation in plain PyTorch ops, on CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

# stage_apply calls that ran the CUDA kernel in this process (read by
# chip_smoke.py); one per stage, whatever its number of blocks
block_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def fold_bn(kernel, scale, beta, mean, var, eps: float = 1e-5):
    """Fold inference BatchNorm into the preceding bias-free conv:
    W' = W * s, b' = beta - mean * s with s = gamma / sqrt(var + eps)
    (exact; ``kernel`` is OIHW, s scales the output channels)."""
    s = scale / torch.sqrt(var + eps)
    return kernel * s.reshape(-1, *([1] * (kernel.dim() - 1))), beta - mean * s


def fold_conv_bn(conv, bn):
    """(kernel, bias) of an ``nn.Conv2d`` followed by an eval-mode
    ``nn.BatchNorm2d``, folded."""
    return fold_bn(conv.weight, bn.weight, bn.bias, bn.running_mean,
                   bn.running_var, bn.eps)


def stack_stage_params(blocks, dtype) -> dict:
    """Fold BN and stack the uniform blocks of a stage for the kernel.

    ``blocks`` are :class:`models.resnet.Bottleneck` modules with equal
    channel shapes and no downsample.  Returns w1 [B, C, M], w2 [B, 9M, M]
    (tap-major rows, the HWIO kernel flattened), w3 [B, M, C] in
    ``dtype`` and the float32 biases b1, b2 [B, M], b3 [B, C].
    """
    w1s, b1s, w2s, b2s, w3s, b3s = [], [], [], [], [], []
    for blk in blocks:
        k1, bb1 = fold_conv_bn(blk.conv1, blk.bn1)
        k2, bb2 = fold_conv_bn(blk.conv2, blk.bn2)
        k3, bb3 = fold_conv_bn(blk.conv3, blk.bn3)
        m = k1.shape[0]
        w1s.append(k1[:, :, 0, 0].t())
        w2s.append(k2.permute(2, 3, 1, 0).reshape(9 * m, m))
        w3s.append(k3[:, :, 0, 0].t())
        b1s.append(bb1)
        b2s.append(bb2)
        b3s.append(bb3)
    f32 = torch.float32
    return dict(
        w1=torch.stack(w1s).to(dtype).contiguous(),
        b1=torch.stack(b1s).to(f32).contiguous(),
        w2=torch.stack(w2s).to(dtype).contiguous(),
        b2=torch.stack(b2s).to(f32).contiguous(),
        w3=torch.stack(w3s).to(dtype).contiguous(),
        b3=torch.stack(b3s).to(f32).contiguous())


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


def stage_apply(x, dil: int, w1, b1, w2, b2, w3, b3):
    """Run a stack of uniform bottleneck blocks on a dense NHWC input.

    x: [N, H, W, C]; weights stacked per block (:func:`stack_stage_params`).
    Returns the stage output [N, H, W, C].  A CPU tensor runs
    :func:`stage_apply_plain`; a CUDA tensor runs ``csrc/block.cu``
    (C % 32 == 0, M % 32 == 0, contiguous and 16-byte aligned) or
    raises.
    """
    global block_launches
    if x.device.type == "cpu":
        return stage_apply_plain(x, dil, w1, b1, w2, b2, w3, b3)
    _check(x, dil, w1, b1, w2, b2, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"no stage kernel for device {x.device}")
    n, h, w, c = x.shape
    nb, _, m = w1.shape
    if c % 32 or m % 32:
        raise ValueError(f"the stage kernel needs C % 32 == 0 and "
                         f"M % 32 == 0, got C={c}, M={m}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (x, w1, b1, w2, b2, w3, b3)):
        raise ValueError("the stage kernel needs contiguous, 16-byte "
                         "aligned tensors")
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
    block_launches += 1
    return src
