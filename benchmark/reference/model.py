"""The plain reference of the scanpath model's eval forward: the
published architecture (Chen et al., CVPR 2021; chenxy99/Scanpaths,
``OSIE/models/baseline_attention.py`` and the AiR variant) written out
layer by layer in stock PyTorch from the reference-layout weights of
:mod:`.weights`.  It imports nothing of the program and derives
nothing the program derives: BatchNorm runs as BatchNorm, each ConvLSTM
gate is its own conv over its own input, the task signal is the dense
outer product ``spatial (x) semantic`` under its own 3x3 convs, the
conditioner's 5x5 conv is materialised and the head's convs run on its
output, and each history is a growing list.

Departures, each of no effect on the values: the x-term of every gate
is computed once (it does not depend on the step); the spatial
attention's (map_h, map_w) scoring conv over a map of the same size is
written as the dot product it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .weights import LSTM_GATES, SIGNAL_GATES, STREAMS, TRUNK_STAGES


def _conv(x, sd, key, **kw):
    return F.conv2d(x, sd[f"{key}.weight"], sd.get(f"{key}.bias"), **kw)


def _bn(x, sd, key):
    return F.batch_norm(x, sd[f"{key}.running_mean"],
                        sd[f"{key}.running_var"], sd[f"{key}.weight"],
                        sd[f"{key}.bias"], False, 0.0, 1e-5)


def _linear(x, sd, key):
    return F.linear(x, sd[f"{key}.weight"], sd[f"{key}.bias"])


def trunk(sd, cfg, images):
    """NHWC images [N, H, W, 3] -> the dilated ResNet-50's NCHW grid
    [N, 2048, H/8, W/8]: Caffe-style bottlenecks (the stride on the 1x1
    conv1), a ceil-mode 3x3 max-pool, layer2's and layer4's strides
    removed and layers 3 and 4 dilated 2 and 4."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_bn(_conv(x, sd, "resnet.0", stride=2, padding=3), sd,
                   "resnet.1"))
    x = F.max_pool2d(x, 3, 2, 0, ceil_mode=True)
    for si, ((_, stride, dil), blocks) in enumerate(
            zip(TRUNK_STAGES, cfg["backbone_layers"])):
        for b in range(blocks):
            pre = f"resnet.{4 + si}.{b}"
            s = stride if b == 0 else 1
            out = F.relu(_bn(_conv(x, sd, f"{pre}.conv1", stride=s), sd,
                             f"{pre}.bn1"))
            out = F.relu(_bn(_conv(out, sd, f"{pre}.conv2", padding=dil,
                                   dilation=dil), sd, f"{pre}.bn2"))
            out = _bn(_conv(out, sd, f"{pre}.conv3"), sd, f"{pre}.bn3")
            res = _bn(_conv(x, sd, f"{pre}.downsample.0", stride=s), sd,
                      f"{pre}.downsample.1") if b == 0 else x
            x = F.relu(out + res)
    return x


def _entry(sd, amap, visual):
    """A history entry from a saliency map [N, H, W]: the map applied to
    the visual features, its channel mean (spatial) and spatial mean
    (semantic), each embedded."""
    feature = amap[:, None] * visual
    spatial = F.relu(feature.mean(dim=1)).flatten(1)
    semantic = F.relu(feature.mean(dim=(2, 3)))
    return (_linear(spatial, sd, "spatial_embed"),
            _linear(semantic, sd, "semantic_embed"))


def _attend(sd, history, mh, mw):
    """The spatial and semantic memories of a stream's history (a list
    of (spatial [N, HW], semantic [N, C]) entries; the current entry is
    the last)."""
    spat = torch.stack([s for s, _ in history], dim=1)          # [N, L, HW]
    sem = torch.stack([c for _, c in history], dim=1)           # [N, L, C]
    n, length, hw = spat.shape
    lists = _conv(spat.reshape(n * length, 1, mh, mw), sd,
                  "spatial_att.spatial_lists", padding=1).reshape(n, length, hw)
    cur = _conv(spat[:, -1].reshape(n, 1, mh, mw), sd,
                "spatial_att.spatial_cur", padding=1).reshape(n, 1, hw)
    score = (lists + cur) @ sd["spatial_att.spatial_attention.weight"] \
        .reshape(hw) + sd["spatial_att.spatial_attention.bias"]
    smem = (torch.softmax(score, dim=1)[..., None] * spat).sum(dim=1)
    score = _linear(_linear(sem, sd, "semantic_att.semantic_lists")
                    + _linear(sem[:, -1:], sd, "semantic_att.semantic_cur"),
                    sd, "semantic_att.semantic_attention")[..., 0]
    cmem = (torch.softmax(score, dim=1)[..., None] * sem).sum(dim=1)
    return smem.reshape(n, mh, mw), cmem


def _head(sd, cond, h):
    """The conditioner and the head on the hidden state: (logits
    [N, 1 + HW] with STOP first, mu [N], sigma2 [N], the relu saliency
    map [N, H, W])."""
    feat = _conv(h, sd, cond, padding=2)
    stop = _conv(feat, sd, "object_head.sal_layer_2").mean(dim=(1, 2, 3))
    amap = F.relu(_conv(feat, sd, "object_head.sal_layer_3"))[:, 0]
    d = _conv(feat, sd, "object_head.drt_layer_1", stride=5, padding=2)
    t = _conv(F.relu(d), sd, "object_head.drt_layer_2").flatten(1)
    logits = torch.cat([stop[:, None], amap.flatten(1)], dim=1)
    return logits, t[:, 0], torch.exp(t[:, 1]), amap


@torch.no_grad()
def forward(sd, cfg, images, attention_maps=None):
    """images NHWC [N, H, W, 3], attention maps [N, mh, mw, 1] (AiR) ->
    one dict per stream (AiR: good, then poor) of ``logits``
    [N, T, 1 + HW], ``mu`` and ``sigma2`` [N, T], in float32.  It
    computes in the dtype of ``images`` and of the weights ``sd``."""
    mh, mw, steps = cfg["map_height"], cfg["map_width"], cfg["max_length"]
    visual = F.relu(_conv(trunk(sd, cfg, images), sd, "sal_conv",
                          padding=1))
    n = visual.shape[0]
    amap0 = visual.new_zeros((n, mh, mw)) if attention_maps is None \
        else attention_maps[..., 0].to(visual.dtype)
    streams = STREAMS[cfg["task"]]
    histories = [[_entry(sd, amap0, visual)] for _ in streams]
    xterm = {g: _conv(visual, sd, f"lstm.{g}_x", padding=1)
             for g in LSTM_GATES}
    h = torch.zeros_like(visual)
    c = torch.zeros_like(visual)
    outs = [{"logits": [], "mu": [], "sigma2": []} for _ in streams]
    for _ in range(steps):
        pre = {g: xterm[g] + _conv(h, sd, f"lstm.{g}_h", padding=1)
               for g in LSTM_GATES}
        for (suffix, _), history in zip(streams, histories):
            smem, cmem = _attend(sd, history, mh, mw)
            signal = smem[:, None] * cmem[:, :, None, None]
            for g in SIGNAL_GATES:
                pre[g] = pre[g] + _conv(signal, sd, f"lstm.{g}{suffix}",
                                        padding=1)
        c = torch.sigmoid(pre["forget"]) * c \
            + torch.sigmoid(pre["input"]) * torch.tanh(pre["memory"])
        h = torch.sigmoid(pre["output"]) * c
        for (_, cond), history, out in zip(streams, histories, outs):
            logits, mu, sigma2, amap = _head(sd, cond, h)
            out["logits"].append(logits)
            out["mu"].append(mu)
            out["sigma2"].append(sigma2)
            history.append(_entry(sd, amap, visual))
    return [{k: torch.stack(v, dim=1).float() for k, v in out.items()}
            for out in outs]
