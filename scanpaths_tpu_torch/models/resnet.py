"""Dilated ResNet-50 trunk (port of ``scanpaths_tpu/models/resnet.py``).

The structure is the reference's, not torchvision's:

* Caffe-style bottleneck: the stride sits on the 1x1 ``conv1`` of each
  block (torchvision's ``resnet50`` puts it on ``conv2``);
* the stem maxpool is kernel 3, stride 2, padding 0, ``ceil_mode=True``;
* the dilation patch removes the stride of layer2[0] and layer4[0] and
  dilates the 3x3 convs of layer3 (rate 2) and layer4 (rate 4), so a
  240x320 input gives a stride-8 grid of 30x40 with 2048 channels;
* no classifier head.

:class:`DilatedResNet50` holds the parameters under the JAX package's
names (``conv1``, ``bn1``, ``layer{s}_block{b}``).  Its ``forward`` is
the differentiable trunk in stock ops that the training steps run: BN
on batch statistics with the running statistics updated (``train``), or
on the running statistics (the eval and SCST forward), as flax's
``BatchNorm(momentum=0.9, epsilon=1e-5)`` computes it
(:func:`batch_norm`).  :func:`fused_forward` is the inference path that
serving runs: BN folded into the convs, the uniform blocks of layers 1-3
through ``ops.block.stage_apply``, on the weights ``models/prepared.py``
derives once a weight version.
"""

from __future__ import annotations

import hashlib
import math
import os
import re
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import block as block_ops
from ..train import mesh
from ..utils import tracing
from . import prepared

# (planes, first-block stride, dilation) per stage after the dilation
# patch — the JAX package's _STAGES table
_STAGES = ((64, 1, 1), (128, 1, 1), (256, 2, 2), (512, 1, 4))
BN_MOMENTUM = 0.9      # flax's: running = 0.9 running + 0.1 batch


def verify_torchvision_sha(path: str) -> bool:
    """Torchvision checkpoint filenames embed the first 8 hex chars of
    the file's sha256 (``resnet50-19c8e357.pth``).  Returns True when the
    content matches its name's digest; names without the ``-hex8``
    pattern pass (custom checkpoints)."""
    m = re.search(r"-([0-9a-f]{8})\.pth$", os.path.basename(path))
    if not m:
        return True
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest().startswith(m.group(1))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, stride=stride,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.has_downsample = has_downsample
        if has_downsample:
            self.downsample_conv = nn.Conv2d(inplanes, out, 1, stride=stride,
                                             bias=False)
            self.downsample_bn = nn.BatchNorm2d(out)

    def forward(self, x, train: bool = False):
        """NCHW in and out, in x's dtype (see :func:`batch_norm`)."""
        out = F.relu(batch_norm(_conv(self.conv1, x), self.bn1, train))
        out = F.relu(batch_norm(_conv(self.conv2, out), self.bn2, train))
        out = batch_norm(_conv(self.conv3, out), self.bn3, train)
        res = (batch_norm(_conv(self.downsample_conv, x), self.downsample_bn,
                          train) if self.has_downsample else x)
        return F.relu(out + res)


def _conv(conv: nn.Conv2d, x):
    """``conv`` in x's dtype (its float32 weight cast at use)."""
    return F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride,
                    conv.padding, conv.dilation)


def batch_norm(x, bn: nn.BatchNorm2d, train: bool):
    """``bn`` over an NCHW ``x`` as flax's ``BatchNorm(momentum=0.9,
    epsilon=1e-5)`` computes it: with ``train``, normalised by the batch
    mean and the BIASED batch variance, and the running statistics
    updated in place to ``0.9 running + 0.1 batch`` with that biased
    variance (``nn.BatchNorm2d``'s own update takes the unbiased one);
    else normalised by the running statistics.  Under data parallel the
    batch is the GLOBAL one, over the data ranks (the ranks of a model
    group share their rows), as under the JAX package's mesh
    (:func:`_global_batch_norm`).  Statistics in float32, the output in
    x's dtype."""
    if not train:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    if mesh.distributed():
        return _global_batch_norm(x, bn)
    with torch.no_grad():
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                   correction=0)
        _update_running(bn, mean, var)
    return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0, bn.eps)


def _update_running(bn: nn.BatchNorm2d, mean, var) -> None:
    with torch.no_grad():
        bn.running_mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
        bn.running_var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)


def _global_batch_norm(x, bn: nn.BatchNorm2d):
    """Training-mode BN over the global batch of every rank, in two
    passes: the per-channel sums and the pixel count, then the sums of
    squares about the global mean, each all-reduced with its gradient
    (so the backward reaches every rank's inputs), in float32 (or x's
    wider type).  The running statistics stay equal on all ranks.  One
    pass over ``E[x^2] - E[x]^2`` would cancel where a channel's mean is
    large against its spread, in the backward too (its gradient through
    the sum of squares is ``2x``, the centred ``2(x - mean)`` only after
    the cancellation); the centred sums keep the backward's terms
    centred."""
    c = x.shape[1]
    xs = x.to(torch.promote_types(x.dtype, torch.float32))
    count = torch.full((1,), x.numel() // c, dtype=xs.dtype,
                       device=x.device)
    sums = mesh.all_reduce_with_grad(torch.cat([xs.sum((0, 2, 3)), count]))
    n = sums[-1]
    mean = sums[:c] / n
    d = xs - mean[None, :, None, None]
    var = mesh.all_reduce_with_grad((d * d).sum((0, 2, 3))) / n
    _update_running(bn, mean.detach(), var.detach())
    scale = bn.weight * torch.rsqrt(var + bn.eps)
    y = d * scale[None, :, None, None] + bn.bias[None, :, None, None]
    return y.to(x.dtype)


def _ceil_maxpool(x):
    """MaxPool2d(kernel=3, stride=2, padding=0, ceil_mode=True), NCHW."""
    return F.max_pool2d(x, 3, 2, 0, ceil_mode=True)


class DilatedResNet50(nn.Module):
    """Stride-8 ResNet-50 trunk: NHWC [N, 240, 320, 3] ->
    NHWC [N, 30, 40, 2048]."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.layers = tuple(layers)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for si, ((planes, stride, dil), blocks) in enumerate(
                zip(_STAGES, self.layers), start=1):
            for bi in range(blocks):
                self.add_module(f"layer{si}_block{bi}", Bottleneck(
                    inplanes, planes, stride=stride if bi == 0 else 1,
                    dilation=dil, has_downsample=bi == 0))
                inplanes = planes * Bottleneck.expansion

    def block(self, si: int, bi: int) -> Bottleneck:
        return getattr(self, f"layer{si}_block{bi}")

    def forward(self, x, train: bool = False, dtype=torch.float32):
        """The trunk in stock ops, differentiable: NHWC in, NHWC out in
        ``dtype`` (convs in ``dtype``, float32 weights cast at use).
        ``train`` normalises by batch statistics and updates the running
        ones (:func:`batch_norm`); else BN reads the running statistics
        whatever the module's ``training`` flag."""
        x = x.to(dtype).permute(0, 3, 1, 2)
        x = _ceil_maxpool(F.relu(batch_norm(_conv(self.conv1, x), self.bn1,
                                            train)))
        for si, blocks in enumerate(self.layers, start=1):
            for bi in range(blocks):
                x = self.block(si, bi)(x, train)
        return x.permute(0, 2, 3, 1)


def _conv_nhwc(x, k, b, stride=1, pad=0, dil=1):
    out = F.conv2d(x.permute(0, 3, 1, 2), k, b, stride=stride, padding=pad,
                   dilation=dil)
    return out.permute(0, 2, 3, 1).contiguous()


def _bottleneck(x, convs, stride: int, dil: int, down=None):
    """A bottleneck block on NHWC ``x`` with its convs folded
    (``prepared.stage``): ``down`` the downsample's, else the identity
    residual."""
    (k1, b1), (k2, b2), (k3, b3) = convs
    out = F.relu(_conv_nhwc(x, k1, b1, stride=stride))
    out = F.relu(_conv_nhwc(out, k2, b2, pad=dil, dil=dil))
    out = _conv_nhwc(out, k3, b3)
    res = x if down is None else _conv_nhwc(x, *down, stride=stride)
    return F.relu(out + res)


def fused_forward(net: DilatedResNet50, images, dtype=torch.float32):
    """Inference forward of ``net`` with BN folded into the conv weights
    (exact eval semantics) and the uniform blocks of layers 1-3 run as
    whole stages by ``ops.block.stage_apply`` — the counterpart of the
    JAX package's ``fused_backbone_apply``.  The stem, the downsample
    blocks and all of layer 4 are plain folded convolutions.  The folded
    and stacked weights are ``prepared.stem`` and ``prepared.stage``'s,
    made once a weight version.

    images: NHWC [N, H, W, 3]; returns NHWC [N, H/8, W/8, 2048] in
    ``dtype``.  One span, ``trunk`` (``utils/tracing.py``)."""
    with tracing.span("trunk"):
        x = F.relu(_conv_nhwc(images.to(dtype), *prepared.stem(net, dtype),
                              stride=2, pad=3))
        x = _ceil_maxpool(x.permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).contiguous()
        for si, (_, stride, dil) in enumerate(_STAGES[:len(net.layers)],
                                              start=1):
            stage = prepared.stage(net, si, dtype)
            x = _bottleneck(x, stage["first"], stride, dil, stage["down"])
            st = stage["stack"]
            if st is not None:
                x = block_ops.stage_apply(x, dil, st["w1"], st["b1"], st["w2"],
                                          st["b2"], st["w3"], st["b3"])
            for convs in stage["rest"]:
                x = _bottleneck(x, convs, 1, dil)
        return x


def init_weights(net: DilatedResNet50, generator: torch.Generator) -> None:
    """The reference's init: He-normal convs (std sqrt(2 / (kh*kw*out))),
    unit-gamma BN with zero statistics."""
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, nn.Conv2d):
                out, _, kh, kw = mod.weight.shape
                std = math.sqrt(2.0 / (kh * kw * out))
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=generator) * std)
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()


def load_torch_state_dict(state_dict: dict,
                          layers: Sequence[int] = (3, 4, 6, 3)) -> dict:
    """Convert a torch ``resnet50`` state dict (old torchvision naming:
    conv1/bn1/layer{1-4}.{i}.{conv,bn}{1-3}/downsample.{0,1}) into a
    state dict for :class:`DilatedResNet50` (``load_state_dict`` it)."""
    out = {}

    def put_bn(dst, src):
        for key in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.{key}"] = torch.as_tensor(state_dict[f"{src}.{key}"])
        out[f"{dst}.num_batches_tracked"] = torch.as_tensor(
            state_dict.get(f"{src}.num_batches_tracked", 0))

    out["conv1.weight"] = torch.as_tensor(state_dict["conv1.weight"])
    put_bn("bn1", "bn1")
    for si, blocks in enumerate(layers, start=1):
        for bi in range(blocks):
            dst, src = f"layer{si}_block{bi}", f"layer{si}.{bi}"
            for ci in (1, 2, 3):
                out[f"{dst}.conv{ci}.weight"] = torch.as_tensor(
                    state_dict[f"{src}.conv{ci}.weight"])
                put_bn(f"{dst}.bn{ci}", f"{src}.bn{ci}")
            if f"{src}.downsample.0.weight" in state_dict:
                out[f"{dst}.downsample_conv.weight"] = torch.as_tensor(
                    state_dict[f"{src}.downsample.0.weight"])
                put_bn(f"{dst}.downsample_bn", f"{src}.downsample.1")
    return out
