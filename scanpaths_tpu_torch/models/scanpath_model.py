"""The scanpath model's eval forward (port of
``scanpaths_tpu/models/scanpath_model.py``) with its three task plugins:

* ``osie``: free viewing, no conditioning input, one stream;
* ``air``: VQA, an attention-map input and two streams (good and poor,
  the right- and wrong-answer conditioners) driving one shared ConvLSTM
  with two task signals;
* ``coco``: visual search, a detector-map input and one stream whose
  conditioner is picked per sample from an 18-category bank.

A dilated ResNet-50 trunk feeds a T-step ConvLSTM decoder with spatial
and semantic attention over each stream's fixation history.  The T steps
are a Python loop over preallocated [N, T+1, ...] history buffers with a
masked softmax; the step invariants (visual features, their channel
mean, the x-gates with folded biases, the h-gate kernel and the composed
conditioner+head kernels) are computed once per forward.  Each step is
one ``ops.cell.cell_step`` (both AiR streams in one call); the trunk's
uniform blocks run through ``ops.block.stage_apply``.

Tensors are NHWC.  The forward returns the JAX model's eval outputs:
``all_actions_prob`` [N, T, 1 + H*W] (softmaxed, STOP at index 0),
``log_normal_mu`` / ``log_normal_sigma2`` [N, T] and ``action_map``
[N, T, H, W], all float32; for AiR each key twice, prefixed ``good_``
and ``poor_``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..data.datasets import COCO_OBJECT_NAMES
from . import resnet
from .components import (
    Conditioner,
    FusedConvLSTMCell,
    PredictHead,
    SemanticAttention,
    SpatialAttention,
    XGates,
    apply_fused_cond_head,
    conv2d,
    dense,
    fuse_bank_heads,
    fuse_cond_head,
    hwio,
    xavier_,
)

TASK_MODES = {"osie": "single", "air": "dual", "coco": "bank"}


class ScanpathModel(nn.Module):
    def __init__(self, task: str = "osie", embed: int = 512,
                 seq_len: int = 16, map_h: int = 30, map_w: int = 40,
                 backbone_layers=(3, 4, 6, 3), dtype=torch.float32):
        super().__init__()
        if task not in TASK_MODES:
            raise ValueError(f"task {task!r}: one of {sorted(TASK_MODES)}")
        self.task, self.embed, self.seq_len = task, embed, seq_len
        self.map_h, self.map_w, self.dtype = map_h, map_w, dtype
        self.streams = ("good", "poor") if task == "air" else (None,)
        hw = map_h * map_w
        self.backbone = resnet.DilatedResNet50(backbone_layers)
        self.sal_conv = nn.Conv2d(2048, embed, 3, padding=1)
        self.xgates = XGates(embed, dtype)
        self.lstm = FusedConvLSTMCell(embed, len(self.streams), dtype)
        self.semantic_embed = nn.Linear(embed, embed)
        self.spatial_embed = nn.Linear(hw, hw)
        self.semantic_att = SemanticAttention(embed, dtype)
        self.spatial_att = SpatialAttention(map_h, map_w, dtype)
        self.conditioner = Conditioner(TASK_MODES[task], embed,
                                       len(COCO_OBJECT_NAMES))
        self.head = PredictHead(map_h, map_w, embed, dtype)

    def _new_stream_entry(self, amap, visual, vismean):
        """Saliency map [N, H, W] + visual [N, H, W, C] -> the history
        entry: embedded spatial/semantic features and their attention
        projections.  The channel mean of ``amap (x) visual`` factors as
        ``amap * vismean``; the spatial mean is one contraction."""
        n = amap.shape[0]
        hw = self.map_h * self.map_w
        spatial = F.relu(amap * vismean)
        semantic = F.relu(torch.einsum("nhw,nhwc->nc", amap, visual) / hw)
        spat = dense(self.spatial_embed, spatial.reshape(n, -1), self.dtype)
        sem = dense(self.semantic_embed, semantic, self.dtype)
        return {"spat": spat, "spat_conv": self.spatial_att.project(spat),
                "sem": sem, "sem_proj": self.semantic_att.project(sem)}

    def _fused_heads(self, task_ids):
        """The composed conditioner+head per stream, once per forward:
        one dict per stream, or for COCO one with a leading [N] axis
        (each sample's bank entry)."""
        raw = self.head.raw()
        if self.task == "coco":
            if task_ids is None:
                raise ValueError("the coco model needs task_ids")
            (bank_k, bank_b), = self.conditioner.kernels()
            return [fuse_bank_heads(bank_k, bank_b, task_ids, raw,
                                    self.map_h, self.map_w)]
        return [fuse_cond_head(k, b, raw, self.map_h, self.map_w)
                for k, b in self.conditioner.kernels()]

    @torch.no_grad()
    def forward(self, images, attention_maps=None, task_ids=None):
        """images: NHWC [N, height, width, 3] float32; attention_maps:
        [N, H, W, 1] (AiR, COCO; zeros when None); task_ids: [N] int
        (COCO) -> the eval output dict (see the module docstring)."""
        dt, t_len = self.dtype, self.seq_len
        mh, mw = self.map_h, self.map_w
        x = resnet.fused_forward(self.backbone, images, dt)
        n = x.shape[0]
        k, b = hwio(self.sal_conv)
        visual = F.relu(conv2d(x, k, b, padding=((1, 1), (1, 1)), dtype=dt))
        vismean = visual.mean(dim=-1)

        if attention_maps is None:
            amap0 = torch.zeros((n, mh, mw), dtype=dt, device=x.device)
        else:
            amap0 = attention_maps[..., 0].to(dt)
        entry0 = self._new_stream_entry(amap0, visual, vismean)
        # every stream starts from the same entry, with its own history
        entries = [entry0] * len(self.streams)
        hists = []
        for _ in self.streams:
            hist = {key: v.new_zeros((n, t_len + 1) + v.shape[1:])
                    for key, v in entry0.items()}
            for key, v in entry0.items():
                hist[key][:, 0] = v
            hists.append(hist)

        xg = self.lstm.fold_bias(self.xgates(visual))
        kh = self.lstm.gate_kernel()
        h, c = torch.zeros_like(visual), torch.zeros_like(visual)
        fused = self._fused_heads(task_ids)
        slots = torch.arange(t_len + 1, device=x.device)

        outs = [{"z": [], "mu": [], "sigma2": [], "amap": []}
                for _ in self.streams]
        for step in range(t_len):
            valid = slots <= step
            signals = []
            for hist, entry in zip(hists, entries):
                smem = self.spatial_att(hist["spat"], hist["spat_conv"],
                                        entry["spat"], valid)
                cmem = self.semantic_att(hist["sem"], hist["sem_proj"],
                                         entry["sem"], valid)
                signals.append((smem.reshape(n, mh, mw), cmem))
            h, c = self.lstm(xg, h, c, signals, kh)
            for s, (fu, hist, out) in enumerate(zip(fused, hists, outs)):
                stop_logit, amap, d = apply_fused_cond_head(h, fu, dt)
                mu, sigma2 = self.head.finish_duration(d)
                out["z"].append(torch.cat([stop_logit, amap.reshape(n, -1)],
                                          dim=-1))
                out["mu"].append(mu)
                out["sigma2"].append(sigma2)
                amap = amap.to(dt)
                out["amap"].append(amap)
                entries[s] = self._new_stream_entry(amap, visual, vismean)
                for key, v in entries[s].items():
                    hist[key][:, step + 1] = v

        result = {}
        for stream, out in zip(self.streams, outs):
            pre = f"{stream}_" if stream else ""
            result.update({
                pre + "all_actions_prob": torch.softmax(
                    torch.stack(out["z"], dim=1), dim=-1),
                pre + "log_normal_mu": torch.stack(out["mu"], dim=1),
                pre + "log_normal_sigma2": torch.stack(out["sigma2"], dim=1),
                pre + "action_map": torch.stack(out["amap"], dim=1).float()})
        return result


def init_weights(model: ScanpathModel, seed: int) -> None:
    """Weights from ``seed`` with the reference's init schemes: He-normal
    trunk convs with unit-gamma BN, Xavier-normal decoder convs (per gate
    group for the fused gate convs, per head for the COCO bank),
    normal(0.01) Linear layers, zero biases.  Drawn on the CPU, so a seed
    gives the same weights on every device."""
    gen = torch.Generator().manual_seed(seed)
    resnet.init_weights(model.backbone, gen)
    groups = {"xgates.gates_x": 4, "lstm.gates_h": 4, "lstm.gates_s0": 3,
              "lstm.gates_s1": 3}
    with torch.no_grad():
        for name, mod in model.named_modules():
            if name.startswith("backbone"):
                continue
            if isinstance(mod, nn.Linear):
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=gen) * 0.01)
            elif isinstance(mod, nn.Conv2d) or name in ("lstm.gates_s0",
                                                        "lstm.gates_s1"):
                xavier_(mod.weight, gen, groups.get(name, 1))
            elif isinstance(mod, Conditioner) and mod.mode == "bank":
                kh, kw, cin, cout = mod.bank_kernel.shape[1:]
                std = math.sqrt(2.0 / (kh * kw * (cin + cout)))
                mod.bank_kernel.copy_(torch.randn(
                    mod.bank_kernel.shape, generator=gen) * std)
                mod.bank_bias.zero_()
                continue
            else:
                continue
            mod.bias.zero_()
