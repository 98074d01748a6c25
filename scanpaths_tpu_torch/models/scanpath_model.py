"""The scanpath model's eval forward (port of
``scanpaths_tpu/models/scanpath_model.py``), OSIE task.

A dilated ResNet-50 trunk feeds a T-step ConvLSTM decoder with spatial
and semantic attention over the fixation history.  The T steps are a
Python loop over preallocated [N, T+1, ...] history buffers with a
masked softmax; the step invariants (visual features, their channel
mean, the x-gates with folded biases, the h-gate kernel and the composed
conditioner+head kernels) are computed once per forward.  Each step is
one ``ops.cell.cell_step``; the trunk's uniform blocks run through
``ops.block.stage_apply``.

Tensors are NHWC.  The forward returns the JAX model's eval outputs:
``all_actions_prob`` [N, T, 1 + H*W] (softmaxed, STOP at index 0),
``log_normal_mu`` / ``log_normal_sigma2`` [N, T] and ``action_map``
[N, T, H, W], all float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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
    fuse_cond_head,
    hwio,
    xavier_,
)


class ScanpathModel(nn.Module):
    def __init__(self, task: str = "osie", embed: int = 512,
                 seq_len: int = 16, map_h: int = 30, map_w: int = 40,
                 backbone_layers=(3, 4, 6, 3), dtype=torch.float32):
        super().__init__()
        if task != "osie":
            raise NotImplementedError(
                f"task {task!r}: only the OSIE model is ported so far")
        self.task, self.embed, self.seq_len = task, embed, seq_len
        self.map_h, self.map_w, self.dtype = map_h, map_w, dtype
        hw = map_h * map_w
        self.backbone = resnet.DilatedResNet50(backbone_layers)
        self.sal_conv = nn.Conv2d(2048, embed, 3, padding=1)
        self.xgates = XGates(embed, dtype)
        self.lstm = FusedConvLSTMCell(embed, 1, dtype)
        self.semantic_embed = nn.Linear(embed, embed)
        self.spatial_embed = nn.Linear(hw, hw)
        self.semantic_att = SemanticAttention(embed, dtype)
        self.spatial_att = SpatialAttention(map_h, map_w, dtype)
        self.conditioner = Conditioner(embed)
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

    @torch.no_grad()
    def forward(self, images):
        """images: NHWC [N, height, width, 3] float32 -> the eval output
        dict (see the module docstring)."""
        dt, t_len = self.dtype, self.seq_len
        mh, mw = self.map_h, self.map_w
        x = resnet.fused_forward(self.backbone, images, dt)
        n = x.shape[0]
        k, b = hwio(self.sal_conv)
        visual = F.relu(conv2d(x, k, b, padding=((1, 1), (1, 1)), dtype=dt))
        vismean = visual.mean(dim=-1)

        entry = self._new_stream_entry(
            torch.zeros((n, mh, mw), dtype=dt, device=x.device), visual,
            vismean)
        hist = {key: v.new_zeros((n, t_len + 1) + v.shape[1:])
                for key, v in entry.items()}
        for key, v in entry.items():
            hist[key][:, 0] = v

        xg = self.lstm.fold_bias(self.xgates(visual))
        kh = self.lstm.gate_kernel()
        h, c = torch.zeros_like(visual), torch.zeros_like(visual)
        (k1, b1), = self.conditioner.kernels()
        fused = fuse_cond_head(k1, b1, self.head.raw(), mh, mw)
        slots = torch.arange(t_len + 1, device=x.device)

        zs, mus, sigma2s, amaps = [], [], [], []
        for step in range(t_len):
            valid = slots <= step
            smem = self.spatial_att(hist["spat"], hist["spat_conv"],
                                    entry["spat"], valid)
            cmem = self.semantic_att(hist["sem"], hist["sem_proj"],
                                     entry["sem"], valid)
            h, c = self.lstm(xg, h, c, [(smem.reshape(n, mh, mw), cmem)], kh)
            stop_logit, amap, d = apply_fused_cond_head(h, fused, dt)
            mu, sigma2 = self.head.finish_duration(d)
            zs.append(torch.cat([stop_logit, amap.reshape(n, -1)], dim=-1))
            mus.append(mu)
            sigma2s.append(sigma2)
            amap = amap.to(dt)
            amaps.append(amap)
            entry = self._new_stream_entry(amap, visual, vismean)
            for key, v in entry.items():
                hist[key][:, step + 1] = v

        z = torch.stack(zs, dim=1)
        return {"all_actions_prob": torch.softmax(z, dim=-1),
                "log_normal_mu": torch.stack(mus, dim=1),
                "log_normal_sigma2": torch.stack(sigma2s, dim=1),
                "action_map": torch.stack(amaps, dim=1).float()}


def init_weights(model: ScanpathModel, seed: int) -> None:
    """Weights from ``seed`` with the reference's init schemes: He-normal
    trunk convs with unit-gamma BN, Xavier-normal decoder convs (per gate
    group for the fused gate convs), normal(0.01) Linear layers, zero
    biases.  Drawn on the CPU, so a seed gives the same weights on every
    device."""
    gen = torch.Generator().manual_seed(seed)
    resnet.init_weights(model.backbone, gen)
    groups = {"xgates.gates_x": 4, "lstm.gates_h": 4, "lstm.gates_s0": 3}
    with torch.no_grad():
        for name, mod in model.named_modules():
            if name.startswith("backbone"):
                continue
            if isinstance(mod, nn.Linear):
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=gen) * 0.01)
            elif isinstance(mod, nn.Conv2d) or name == "lstm.gates_s0":
                xavier_(mod.weight, gen, groups.get(name, 1))
            else:
                continue
            mod.bias.zero_()
