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
names (``conv1``, ``bn1``, ``layer{s}_block{b}``) and its ``forward`` is
the eval-mode trunk (BN from running statistics).  :func:`fused_forward`
is the inference path that serving runs: BN folded into the convs, the
uniform blocks of layers 1-3 through ``ops.block.stage_apply``.
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

# (planes, first-block stride, dilation) per stage after the dilation
# patch — the JAX package's _STAGES table
_STAGES = ((64, 1, 1), (128, 1, 1), (256, 2, 2), (512, 1, 4))


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

    def forward(self, x):
        """NCHW in and out."""
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = (self.downsample_bn(self.downsample_conv(x))
               if self.has_downsample else x)
        return F.relu(out + res)


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

    def forward(self, x):
        """Eval-mode trunk (call ``.eval()`` first), NHWC in and out."""
        x = x.permute(0, 3, 1, 2)
        x = _ceil_maxpool(F.relu(self.bn1(self.conv1(x))))
        for si, blocks in enumerate(self.layers, start=1):
            for bi in range(blocks):
                x = self.block(si, bi)(x)
        return x.permute(0, 2, 3, 1).contiguous()


def _conv_nhwc(x, k, b, stride=1, pad=0, dil=1):
    out = F.conv2d(x.permute(0, 3, 1, 2), k, b, stride=stride, padding=pad,
                   dilation=dil)
    return out.permute(0, 2, 3, 1).contiguous()


def fused_forward(net: DilatedResNet50, images, dtype=torch.float32):
    """Inference forward of ``net`` with BN folded into the conv weights
    (exact eval semantics) and the uniform blocks of layers 1-3 run as
    whole stages by ``ops.block.stage_apply`` — the counterpart of the
    JAX package's ``fused_backbone_apply``.  The stem, the downsample
    blocks and all of layer 4 are plain folded convolutions.

    images: NHWC [N, H, W, 3]; returns NHWC [N, H/8, W/8, 2048] in
    ``dtype``."""

    def fold(conv, bn):
        k, b = block_ops.fold_conv_bn(conv, bn)
        return k.to(dtype), b.to(dtype)

    k1, b1 = fold(net.conv1, net.bn1)
    x = F.relu(_conv_nhwc(images.to(dtype), k1, b1, stride=2, pad=3))
    x = _ceil_maxpool(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()

    for si, ((_, stride, dil), blocks) in enumerate(
            zip(_STAGES, net.layers), start=1):
        blk = net.block(si, 0)
        kc1, bc1 = fold(blk.conv1, blk.bn1)
        kc2, bc2 = fold(blk.conv2, blk.bn2)
        kc3, bc3 = fold(blk.conv3, blk.bn3)
        kd, bd = fold(blk.downsample_conv, blk.downsample_bn)
        out = F.relu(_conv_nhwc(x, kc1, bc1, stride=stride))
        out = F.relu(_conv_nhwc(out, kc2, bc2, pad=dil, dil=dil))
        out = _conv_nhwc(out, kc3, bc3)
        x = F.relu(out + _conv_nhwc(x, kd, bd, stride=stride))

        rest = [net.block(si, bi) for bi in range(1, blocks)]
        if si <= 3 and rest:
            st = block_ops.stack_stage_params(rest, dtype)
            x = block_ops.stage_apply(x, dil, st["w1"], st["b1"], st["w2"],
                                      st["b2"], st["w3"], st["b3"])
        else:
            for blk in rest:
                kc1, bc1 = fold(blk.conv1, blk.bn1)
                kc2, bc2 = fold(blk.conv2, blk.bn2)
                kc3, bc3 = fold(blk.conv3, blk.bn3)
                out = F.relu(_conv_nhwc(x, kc1, bc1))
                out = F.relu(_conv_nhwc(out, kc2, bc2, pad=dil, dil=dil))
                x = F.relu(_conv_nhwc(out, kc3, bc3) + x)
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
