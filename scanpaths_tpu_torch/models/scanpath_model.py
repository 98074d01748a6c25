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
uniform blocks run through ``ops.block.stage_apply``.  That is the eval
forward (:meth:`ScanpathModel.forward`, no gradients).  The training
steps differentiate :meth:`ScanpathModel.forward_train`, the same
decoder in stock ops over the trunk's stock-op forward (the kernels
define no backward).

A head built with ``trunk=False`` holds no trunk: its ``forward`` and
``forward_train`` take the trunk's grid [N, H, W, 2048] as ``features``.
:class:`JointScanpathModel` is one trunk feeding three such heads (the
OSIE, AiR and COCO plugins), and :class:`TaskView` the single-task
interface of one of its heads, which the training steps and the
evaluation loop drive.

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
from ..ops.compose import compose_bank_heads, cond_compose
from ..utils import tracing
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
    hwio,
    xavier_,
)

TASK_MODES = {"osie": "single", "air": "dual", "coco": "bank"}


class ScanpathModel(nn.Module):
    def __init__(self, task: str = "osie", embed: int = 512,
                 seq_len: int = 16, map_h: int = 30, map_w: int = 40,
                 backbone_layers=(3, 4, 6, 3), dtype=torch.float32,
                 trunk: bool = True):
        super().__init__()
        if task not in TASK_MODES:
            raise ValueError(f"task {task!r}: one of {sorted(TASK_MODES)}")
        self.task, self.embed, self.seq_len = task, embed, seq_len
        self.map_h, self.map_w, self.dtype = map_h, map_w, dtype
        self.streams = ("good", "poor") if task == "air" else (None,)
        hw = map_h * map_w
        self.backbone = (resnet.DilatedResNet50(backbone_layers) if trunk
                         else None)
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

    def composed_heads(self, differentiable: bool = False) -> list[dict]:
        """The composed conditioner+head of every stream, from the
        weights alone, by one :func:`ops.compose.cond_compose` call over
        every conditioner entry (OSIE's one, AiR's two, COCO's bank), or
        with ``differentiable`` (the training forward's) by its plain
        version in stock ops, :func:`ops.compose.compose_bank_heads`: the
        kernel has no backward.  One dict per stream, or for COCO one
        whose fields lead with the bank's [K] axis.  A caller that keeps
        them passes them to :meth:`forward` as ``heads``."""
        compose = compose_bank_heads if differentiable else cond_compose
        raw = self.head.raw()
        pairs = self.conditioner.kernels()
        if self.task == "coco":
            (bank_k, bank_b), = pairs
            return [compose(bank_k, bank_b, raw, self.map_h, self.map_w)]
        bank = compose([k for k, _ in pairs], [b for _, b in pairs], raw,
                       self.map_h, self.map_w)
        return [{key: v[s] for key, v in bank.items()}
                for s in range(len(pairs))]

    def _fused_heads(self, task_ids, heads=None, differentiable=False):
        """The composed conditioner+head per stream, once per forward:
        one dict per stream, or for COCO one with a leading [N] axis
        (each sample's bank entry, :func:`fuse_bank_heads`).  ``heads``
        (:meth:`composed_heads`) replaces the composition: COCO's are
        gathered by task id.  ``differentiable``: the training forward's
        composition, in stock ops."""
        if self.task != "coco":
            return heads if heads is not None else \
                self.composed_heads(differentiable)
        if task_ids is None:
            raise ValueError("the coco model needs task_ids")
        if heads is not None:
            return [{k: v[task_ids] for k, v in heads[0].items()}]
        (bank_k, bank_b), = self.conditioner.kernels()
        return [fuse_bank_heads(bank_k, bank_b, task_ids, self.head.raw(),
                                self.map_h, self.map_w, differentiable)]

    def _decode(self, x, attention_maps, task_ids, differentiable: bool,
                heads=None):
        """The decoder from the trunk's grid ``x`` [N, H, W, 2048]: one
        (z [N, T, A] logits, mu, sigma2 [N, T], amap [N, T, H, W]) per
        stream, all float32.  Each step's cell is ``ops.cell.cell_step``
        and each stream's head ``ops.head.cond_head``, or with
        ``differentiable`` the stock-op ``FusedConvLSTMCell.step`` and
        ``ops.head.cond_head_plain``, with the histories then written out
        of place (each step's attention saved the earlier versions for
        backward).  Its spans (``utils/tracing.py``): ``decode.hoist``
        over the step invariants, holding ``decode.hoist.compose`` (the
        conditioner+head compositions, :meth:`_fused_heads`), then one
        ``decode.step`` a step holding ``.attend`` (every stream's
        attentions), ``.cell`` and ``.head`` (every stream's head and next
        history entry)."""
        dt, t_len = self.dtype, self.seq_len
        mh, mw = self.map_h, self.map_w
        n = x.shape[0]
        with tracing.span("decode.hoist"):
            k, b = hwio(self.sal_conv)
            visual = F.relu(conv2d(x, k, b, padding=((1, 1), (1, 1)),
                                   dtype=dt))
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
            if differentiable:
                kh = self.lstm.gates_h.weight.to(dt)
            else:
                kh = self.lstm.gate_kernel()
            h, c = torch.zeros_like(visual), torch.zeros_like(visual)
            with tracing.span("decode.hoist.compose"):
                fused = self._fused_heads(task_ids, heads, differentiable)
            slots = torch.arange(t_len + 1, device=x.device)

        outs = [{"z": [], "mu": [], "sigma2": [], "amap": []}
                for _ in self.streams]
        for step in range(t_len):
            with tracing.span("decode.step"):
                with tracing.span("decode.step.attend"):
                    valid = slots <= step
                    signals = []
                    for hist, entry in zip(hists, entries):
                        smem = self.spatial_att(hist["spat"],
                                                hist["spat_conv"],
                                                entry["spat"], valid)
                        cmem = self.semantic_att(hist["sem"],
                                                 hist["sem_proj"],
                                                 entry["sem"], valid)
                        signals.append((smem.reshape(n, mh, mw), cmem))
                with tracing.span("decode.step.cell"):
                    if differentiable:
                        h, c = self.lstm.step(xg, h, c, signals, kh)
                    else:
                        h, c = self.lstm(xg, h, c, signals, kh)
                with tracing.span("decode.step.head"):
                    for s, (fu, hist, out) in enumerate(zip(fused, hists,
                                                            outs)):
                        stop_logit, amap, d = apply_fused_cond_head(
                            h, fu, dt, differentiable)
                        mu, sigma2 = self.head.finish_duration(d)
                        out["z"].append(torch.cat(
                            [stop_logit, amap.reshape(n, -1)], dim=-1))
                        out["mu"].append(mu)
                        out["sigma2"].append(sigma2)
                        amap = amap.to(dt)
                        out["amap"].append(amap)
                        entries[s] = self._new_stream_entry(amap, visual,
                                                            vismean)
                        for key, v in entries[s].items():
                            if differentiable:
                                hist[key] = hist[key].clone()
                            hist[key][:, step + 1] = v
        return [tuple(torch.stack(out[k], dim=1)
                      for k in ("z", "mu", "sigma2", "amap"))
                for out in outs]

    def _eval_outputs(self, outs) -> dict:
        """The eval output dict (module docstring) of ``_decode``'s
        streams."""
        result = {}
        for stream, (z, mu, sigma2, amap) in zip(self.streams, outs):
            pre = f"{stream}_" if stream else ""
            result.update({
                pre + "all_actions_prob": torch.softmax(z, dim=-1),
                pre + "log_normal_mu": mu, pre + "log_normal_sigma2": sigma2,
                pre + "action_map": amap.float()})
        return result

    def _trunk(self) -> resnet.DilatedResNet50:
        if self.backbone is None:
            raise ValueError("a head without a trunk takes features")
        return self.backbone

    @torch.no_grad()
    def forward(self, images=None, attention_maps=None, task_ids=None,
                features=None, heads=None):
        """images: NHWC [N, height, width, 3] float32; attention_maps:
        [N, H, W, 1] (AiR, COCO; zeros when None); task_ids: [N] int
        (COCO) -> the eval output dict (see the module docstring).  The
        serving path: no gradients, the trunk BN-folded through
        ``ops.block.stage_apply`` and each decode step through
        ``ops.cell.cell_step``.  ``features`` [N, H, W, 2048], the
        trunk's grid, replaces the trunk (a head without one needs
        them); ``heads``, :meth:`composed_heads` kept by the caller,
        replaces the per-forward composition of the conditioner and
        head."""
        return self.eval_forward(images, attention_maps, task_ids, features,
                                 heads)

    def eval_forward(self, images=None, attention_maps=None, task_ids=None,
                     features=None, heads=None):
        """:meth:`forward` without its ``no_grad`` context, for a caller
        that holds one: the serving export traces this (a switch of grad
        mode inside a traced region splits the exported graph)."""
        x = features if features is not None else resnet.fused_forward(
            self._trunk(), images, self.dtype)
        with tracing.span("decode"):
            return self._eval_outputs(self._decode(
                x, attention_maps, task_ids, differentiable=False,
                heads=heads))

    def forward_train(self, images=None, attention_maps=None,
                      task_ids=None, performances=None, train: bool = True,
                      features=None):
        """The forward the training steps differentiate, in stock ops
        (the cell and stage kernels have no backward); the JAX model's
        ``apply(..., train=train)`` with the XLA cell.

        ``train`` (the supervised step): BN on batch statistics, its
        running statistics updated; raw logits under ``actions`` with
        ``log_normal_mu`` / ``log_normal_sigma2`` (OSIE, COCO), and for
        AiR, which needs ``performances`` [N], the stream each sample's
        subject answered with (good where true), selected per sample, its
        logits under ``all_actions_prob`` (the JAX model's key).  Not
        ``train`` (the SCST forward): BN on the running statistics and
        the eval output dict of :meth:`forward`, softmaxed.  ``features``
        as in :meth:`forward` (the trunk's stock-op grid, with its
        gradient)."""
        if train and self.task == "air" and performances is None:
            raise ValueError("the AiR training forward needs performances")
        x = features if features is not None else self._trunk()(
            images, train=train, dtype=self.dtype)
        with tracing.span("decode"):
            outs = self._decode(x, attention_maps, task_ids,
                                differentiable=True)
        if not train:
            return self._eval_outputs(outs)
        if self.task != "air":
            z, mu, sigma2, _ = outs[0]
            return {"actions": z, "log_normal_mu": mu,
                    "log_normal_sigma2": sigma2}
        (gz, gmu, gs2, _), (pz, pmu, ps2, _) = outs
        sel = torch.as_tensor(performances, device=gz.device).bool()
        return {"all_actions_prob": torch.where(sel[:, None, None], gz, pz),
                "log_normal_mu": torch.where(sel[:, None], gmu, pmu),
                "log_normal_sigma2": torch.where(sel[:, None], gs2, ps2)}


class JointScanpathModel(nn.Module):
    """One dilated ResNet-50 trunk feeding the three task heads
    (``osie``, ``air``, ``coco``: :class:`ScanpathModel` heads without a
    trunk), the JAX package's ``JointScanpathModel``.  The trunk is
    shared and learns from every task; each head is its task's own.
    ``task`` picks the head of a call."""

    def __init__(self, embed: int = 512, seq_len: int = 16, map_h: int = 30,
                 map_w: int = 40, backbone_layers=(3, 4, 6, 3),
                 dtype=torch.float32):
        super().__init__()
        self.embed, self.seq_len = embed, seq_len
        self.map_h, self.map_w, self.dtype = map_h, map_w, dtype
        self.backbone = resnet.DilatedResNet50(backbone_layers)
        for task in TASK_MODES:
            self.add_module(task, ScanpathModel(
                task, embed=embed, seq_len=seq_len, map_h=map_h, map_w=map_w,
                dtype=dtype, trunk=False))

    def task_head(self, task: str) -> ScanpathModel:
        if task not in TASK_MODES:
            raise ValueError(f"task {task!r}: one of {sorted(TASK_MODES)}")
        return getattr(self, task)

    @torch.no_grad()
    def forward(self, images, task: str = "osie", attention_maps=None,
                task_ids=None):
        """The eval forward of ``task``'s head (``ScanpathModel.forward``)
        on the shared trunk, BN-folded through ``ops.block.stage_apply``."""
        x = resnet.fused_forward(self.backbone, images, self.dtype)
        return self.task_head(task).forward(attention_maps=attention_maps,
                                       task_ids=task_ids, features=x)

    def forward_train(self, images, task: str = "osie", attention_maps=None,
                      task_ids=None, performances=None, train: bool = True):
        """``ScanpathModel.forward_train`` of ``task``'s head on the shared
        trunk's stock-op forward (with ``train``, BN on batch statistics
        and the trunk's running statistics updated)."""
        x = self.backbone(images, train=train, dtype=self.dtype)
        return self.task_head(task).forward_train(
            attention_maps=attention_maps, task_ids=task_ids,
            performances=performances, train=train, features=x)


class TaskView(nn.Module):
    """The single-task interface of one head of a
    :class:`JointScanpathModel` (the JAX package's ``TaskView``):
    ``task``, ``forward``, ``forward_train``, ``train()``/``eval()`` and
    ``parameters()``, which cover the whole joint model, so one optimizer
    over a view steps every parameter (the heads a step does not reach
    get a zero gradient, and decay)."""

    def __init__(self, joint: JointScanpathModel, task: str):
        super().__init__()
        joint.task_head(task)
        self.joint, self.task = joint, task
        self.map_h, self.map_w, self.dtype = joint.map_h, joint.map_w, \
            joint.dtype

    def forward(self, images, attention_maps=None, task_ids=None):
        return self.joint(images, self.task, attention_maps, task_ids)

    def forward_train(self, images, attention_maps=None, task_ids=None,
                      performances=None, train: bool = True):
        return self.joint.forward_train(images, self.task, attention_maps,
                                        task_ids, performances, train)


def model_from_flags(args):
    """The model the flags describe (``--task``, ``--embed``,
    ``--max_length``, ``--map_height``/``--map_width``,
    ``--backbone_layers``; bfloat16 compute under ``--half_precision``,
    with float32 parameters), its weights not yet set: a
    :class:`JointScanpathModel` for ``--task joint``."""
    kw = dict(embed=args.embed, seq_len=args.max_length,
              map_h=args.map_height, map_w=args.map_width,
              backbone_layers=tuple(
                  int(v) for v in str(args.backbone_layers).split(",")),
              dtype=torch.bfloat16 if args.half_precision else torch.float32)
    if args.task == "joint":
        return JointScanpathModel(**kw)
    return ScanpathModel(args.task, **kw)


def _init_head(model: ScanpathModel, gen: torch.Generator) -> None:
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


def init_weights(model, seed: int) -> None:
    """Weights from ``seed`` with the reference's init schemes: He-normal
    trunk convs with unit-gamma BN, Xavier-normal decoder convs (per gate
    group for the fused gate convs, per head for the COCO bank),
    normal(0.01) Linear layers, zero biases.  A
    :class:`JointScanpathModel` draws its trunk once, then each head as
    its task's.  Drawn on the CPU, so a seed gives the same weights on
    every device."""
    gen = torch.Generator().manual_seed(seed)
    if model.backbone is not None:
        resnet.init_weights(model.backbone, gen)
    heads = ([model.task_head(t) for t in TASK_MODES]
             if isinstance(model, JointScanpathModel) else [model])
    for head in heads:
        _init_head(head, gen)
