"""Decoder building blocks (port of ``scanpaths_tpu/models/components.py``):
the hoisted x-gates, the fused ConvLSTM cell with factorized task-signal
gates, the history attentions, the prediction head, the task
conditioners (OSIE's single conv, AiR's dual streams, COCO's per-category
bank) and the exact conditioner+head composition.

Parameters are held in torch layouts (``nn.Conv2d`` OIHW, ``nn.Linear``
[out, in]) under the JAX package's names; activations are NHWC at every
public function, as in the JAX package.  Each module computes in its
``dtype`` (float32 or bfloat16) with float32 parameters cast at use, as
flax's ``dtype`` does.

Under row-parallel tensor parallelism (``train/tp_step.py``) the h-gate
and x-gate kernels hold this rank's block of their input channels; the
training forward then contracts that block and sums the partial results
over the model group (:func:`tp_row_conv`, the JAX package's
``tp_row_conv``).  The eval forward's cell kernel fuses the whole
contraction with its epilogue, so it takes the gathered kernel
(``tp_step.gathered``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import cell as cell_ops
from ..ops import head as head_ops
from ..train import mesh
from ..utils import tracing

NEG_INF = -1e9


def hwio(conv: nn.Conv2d):
    """(kernel HWIO view, bias) of a conv — the JAX package's layout."""
    return conv.weight.permute(2, 3, 1, 0), conv.bias


def xavier_(weight, generator: torch.Generator, groups: int = 1) -> None:
    """Xavier-normal on an OIHW kernel, per gate group: each of the
    ``groups`` output-channel groups keeps the fan of a separate
    per-gate conv (the reference's init)."""
    cout, cin, kh, kw = weight.shape
    std = math.sqrt(2.0 / (kh * kw * cin + kh * kw * cout // groups))
    with torch.no_grad():
        weight.copy_(torch.randn(weight.shape, generator=generator) * std)


def conv2d(x, kernel, bias=None, strides=(1, 1), padding=((0, 0), (0, 0)),
           dtype=None):
    """NHWC input, HWIO kernel, NHWC output — the JAX package's
    ``conv2d`` helper (inputs and kernel cast to ``dtype`` when given,
    asymmetric padding allowed)."""
    if dtype is not None:
        x = x.to(dtype)
        kernel = kernel.to(dtype)
    (pt, pb), (pl, pr) = padding
    xin = x.permute(0, 3, 1, 2)
    if pt == pb and pl == pr:
        pad = (pt, pl)
    else:
        xin = F.pad(xin, (pl, pr, pt, pb))
        pad = 0
    out = F.conv2d(xin, kernel.permute(3, 2, 0, 1), stride=strides,
                   padding=pad).permute(0, 2, 3, 1)
    if bias is not None:
        out = out + (bias.to(out.dtype) if dtype is not None else bias)
    return out


def tp_row_conv(x, weight):
    """The 3x3 'same' conv (no bias) of an NHWC ``x``, replicated over the
    model group, with an OIHW ``weight`` that holds this rank's contiguous
    block of ``x``'s channels: the block's partial contraction, summed
    over the model group (``mesh.tp_enter`` on the input, ``mesh.tp_exit``
    on the output, so the gradients of ``x`` and of the replicated layers
    around the block are whole on every rank).  In ``weight``'s dtype."""
    shard = weight.shape[1]
    xs = mesh.tp_enter(x).narrow(-1, mesh.model_index() * shard, shard)
    out = F.conv2d(xs.permute(0, 3, 1, 2).to(weight.dtype), weight,
                   padding=1)
    return mesh.tp_exit(out).permute(0, 2, 3, 1)


def sliced(weight, x) -> bool:
    """Whether a conv ``weight`` holds a block of ``x``'s channels (the TP
    layout of ``train/tp_step.py``) rather than all of them."""
    return weight.shape[1] != x.shape[-1]


def dense(lin: nn.Linear, x, dtype):
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


class XGates(nn.Module):
    """The x-dependent ConvLSTM gate pre-activations (gate order i, f, o,
    g), computed once per forward outside the decode loop."""

    def __init__(self, embed: int = 512, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.gates_x = nn.Conv2d(embed, 4 * embed, 3, padding=1)

    def forward(self, visual):
        if sliced(self.gates_x.weight, visual):
            out = tp_row_conv(visual, self.gates_x.weight.to(self.dtype))
            return out + self.gates_x.bias.to(self.dtype)
        k, b = hwio(self.gates_x)
        return conv2d(visual, k, b, padding=((1, 1), (1, 1)),
                      dtype=self.dtype)


class SignalGates(nn.Module):
    """The 3x3 conv over the rank-1 task signal ``s (x) cv``, factorized:
    the semantic vector is contracted into the kernel first (:meth:`kp`),
    and the cell correlates the scalar spatial map with the result."""

    def __init__(self, features: int, in_features: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))

    def kp(self, cv):
        """Per-sample contracted kernels [N, 9, G] (taps row-major, bias
        not included)."""
        k = self.weight.to(self.dtype)
        out = torch.einsum("ochw,nc->nhwo", k, cv.to(self.dtype))
        return out.reshape(cv.shape[0], 9, self.weight.shape[0])


class FusedConvLSTMCell(nn.Module):
    """ConvLSTM over the feature grid with task-signal gate injection:
    i, f, o = sigm(Wx*x + Wh*h + Ws*ss), g = tanh(Wx*x + Wh*h),
    c' = f*c + i*g, h' = o*c' (no tanh on c', the reference's quirk).

    The x-term arrives hoisted (:class:`XGates`) with the constant biases
    folded in once per forward (:meth:`fold_bias`); each step of the
    eval forward is one ``ops.cell.cell_step`` (:meth:`forward`), each
    step of the training forward one :meth:`step` in stock ops."""

    def __init__(self, embed: int = 512, num_signals: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.embed, self.num_signals, self.dtype = embed, num_signals, dtype
        self.gates_h = nn.Conv2d(embed, 4 * embed, 3, padding=1)
        self.gates_s0 = SignalGates(3 * embed, embed, dtype)
        if num_signals == 2:
            self.gates_s1 = SignalGates(3 * embed, embed, dtype)

    def _sgate(self, idx: int) -> SignalGates:
        return self.gates_s0 if idx == 0 else self.gates_s1

    def gate_kernel(self):
        """The h-gate kernel in the cell's layout: HWIO [3, 3, C, 4C]."""
        if self.gates_h.weight.shape[1] != self.embed:
            raise ValueError("the cell kernel takes the whole h-gate kernel: "
                             "gather the sliced kernels first "
                             "(train/tp_step.py::gathered)")
        return hwio(self.gates_h)[0].to(self.dtype).contiguous()

    def fold_bias(self, xg):
        """xg + the h-gate bias + the summed signal biases (i/f/o)."""
        sb = sum(self._sgate(i).bias for i in range(self.num_signals))
        bias = self.gates_h.bias + F.pad(sb, (0, self.embed))
        return (xg + bias.to(self.dtype)).contiguous()

    def forward(self, xg, h, c, signals, kh=None):
        """xg: folded x-gates [N, H, W, 4C]; h, c: [N, H, W, C];
        signals: one (spatial [N, H, W], semantic [N, C]) pair per
        stream; kh: :meth:`gate_kernel`, hoisted by the caller.  Returns
        (h', c') — ``c`` is updated in place."""
        smaps = torch.stack([s for s, _ in signals], dim=-1).to(self.dtype)
        kps = torch.stack([self._sgate(i).kp(cv)
                           for i, (_, cv) in enumerate(signals)], dim=1)
        if kh is None:
            kh = self.gate_kernel()
        return cell_ops.cell_step(h, c, xg, smaps.contiguous(),
                                  kps.contiguous(), kh)

    def step(self, xg, h, c, signals, weight):
        """The differentiable step, out of place, in stock ops: the maths
        of ``ops.cell.cell_step_plain`` (the gate conv and signal taps in
        the compute dtype, the nonlinearities and state update in float32,
        h' and c' stored in h's dtype).  ``weight`` is the h-gate kernel
        OIHW in the compute dtype (``gates_h.weight``, cast once per
        forward by the caller), or its block of h's channels under TP
        (:func:`tp_row_conv`; the bias is folded in ``xg``, the signal
        taps are added after the sum).  Returns (h', c')."""
        n, hh, ww, ch = h.shape
        if sliced(weight, h):
            acc = tp_row_conv(h, weight).float()
        else:
            acc = F.conv2d(h.permute(0, 3, 1, 2), weight, padding=1)
            acc = acc.permute(0, 2, 3, 1).float()
        smaps = torch.stack([s for s, _ in signals], dim=-1).to(self.dtype)
        kps = torch.stack([self._sgate(i).kp(cv)
                           for i, (_, cv) in enumerate(signals)], dim=1)
        spad = F.pad(smaps, (0, 0, 1, 1, 1, 1)).float()
        taps = torch.stack([spad[:, dy:dy + hh, dx:dx + ww]
                            for dy in range(3) for dx in range(3)], dim=-1)
        sig = torch.einsum("nyxst,nsto->nyxo", taps, kps.float())
        pre = acc + xg.float() + F.pad(sig, (0, ch))
        i, f, o, g = pre.split(ch, dim=-1)
        c_next = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
        h_next = torch.sigmoid(o) * c_next
        return h_next.to(h.dtype), c_next.to(h.dtype)


class SemanticAttention(nn.Module):
    """Additive attention over the channel-semantic history; ``project``
    runs once per entry when it is written."""

    def __init__(self, embed: int = 512, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.lists = nn.Linear(embed, embed)
        self.cur = nn.Linear(embed, embed)
        self.att = nn.Linear(embed, 1)

    def project(self, feat):
        return dense(self.lists, feat, self.dtype)

    def forward(self, hist_feat, hist_proj, cur_feat, valid):
        """hist_feat/hist_proj: [N, T1, E]; cur_feat: [N, E]; valid: [T1]."""
        cur = dense(self.cur, cur_feat, self.dtype)[:, None, :]
        scores = dense(self.att, hist_proj + cur, self.dtype)[..., 0]
        w = torch.softmax(scores.masked_fill(~valid[None, :], NEG_INF), dim=1)
        return torch.einsum("nt,nte->ne", w, hist_feat)


class SpatialAttention(nn.Module):
    """Attention over the spatial-map history.  The reference's
    (map_h, map_w)-kernel scoring conv is a Linear [HW -> 1] over the
    row-major flattened map."""

    def __init__(self, map_h: int = 30, map_w: int = 40,
                 dtype=torch.float32):
        super().__init__()
        self.map_h, self.map_w, self.dtype = map_h, map_w, dtype
        self.lists_conv = nn.Conv2d(1, 1, 3, padding=1)
        self.cur_conv = nn.Conv2d(1, 1, 3, padding=1)
        self.att = nn.Linear(map_h * map_w, 1)

    def _conv(self, conv, flat):
        n = flat.shape[0]
        m = flat.reshape(n, 1, self.map_h, self.map_w).to(self.dtype)
        out = F.conv2d(m, conv.weight.to(self.dtype),
                       conv.bias.to(self.dtype), padding=1)
        return out.reshape(n, -1)

    def project(self, feat_flat):
        """[N, HW] -> 3x3-conv'd [N, HW]."""
        return self._conv(self.lists_conv, feat_flat)

    def forward(self, hist_feat, hist_conv, cur_feat, valid):
        """hist_*: [N, T1, HW]; cur_feat: [N, HW]; valid: [T1]."""
        n, _, hw = hist_feat.shape
        cur = self._conv(self.cur_conv, cur_feat).reshape(n, 1, hw)
        scores = dense(self.att, hist_conv + cur, self.dtype)[..., 0]
        w = torch.softmax(scores.masked_fill(~valid[None, :], NEG_INF), dim=1)
        return torch.einsum("nt,nth->nh", w, hist_feat)


class PredictHead(nn.Module):
    """Action logits + LogNormal duration head.  Only its parameters and
    the duration tail are used directly: the per-step evaluation is the
    composed conditioner+head (:func:`apply_fused_cond_head`)."""

    def __init__(self, map_h: int = 30, map_w: int = 40, embed: int = 512,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.sal_layer_2 = nn.Conv2d(embed, 1, 1)
        self.drt_layer_1 = nn.Conv2d(embed, 1, 7)
        self.drt_layer_2 = nn.Conv2d(1, 2, (map_h // 5, map_w // 5))
        self.sal_layer_3 = nn.Conv2d(embed, 1, 1)

    def raw(self) -> dict:
        """Every head parameter as (kernel HWIO, bias)."""
        return {"w2": hwio(self.sal_layer_2), "kd": hwio(self.drt_layer_1),
                "kd2": hwio(self.drt_layer_2), "w3": hwio(self.sal_layer_3)}

    def finish_duration(self, d):
        """relu -> drt_layer_2 -> (mu, sigma2), both float32 [N]; ``d``
        [N, h5, w5] is the raw drt_layer_1 output."""
        n = d.shape[0]
        k2, b2 = hwio(self.drt_layer_2)
        t = conv2d(F.relu(d)[..., None], k2, b2, dtype=self.dtype)
        t = t.reshape(n, 2).float()
        return t[:, 0], torch.exp(t[:, 1])


class Conditioner(nn.Module):
    """The task-conditioned 5x5 C->C conv ahead of the shared head:

    * ``single`` (OSIE): one conv, the reference's ``performance_sal_layer``;
    * ``dual`` (AiR): the right- and wrong-answer convs
      (``performance_sal_layer.{True,False}``), one per stream;
    * ``bank`` (COCO): one conv per search-target category, held as one
      HWIO kernel [K, 5, 5, C, C] and bias [K, C] and picked per sample
      by task id (the reference's ``object_sal_layer.<category>``).
    """

    def __init__(self, mode: str = "single", embed: int = 512,
                 num_heads: int = 18):
        super().__init__()
        self.mode = mode
        if mode == "single":
            self.sal_layer = nn.Conv2d(embed, embed, 5, padding=2)
        elif mode == "dual":
            self.sal_layer_true = nn.Conv2d(embed, embed, 5, padding=2)
            self.sal_layer_false = nn.Conv2d(embed, embed, 5, padding=2)
        elif mode == "bank":
            self.bank_kernel = nn.Parameter(
                torch.empty(num_heads, 5, 5, embed, embed))
            self.bank_bias = nn.Parameter(torch.zeros(num_heads, embed))
        else:
            raise ValueError(f"conditioner mode {mode!r}")

    def kernels(self):
        """[(kernel HWIO, bias)] per stream — the fusion inputs; stream
        order good, then poor, for ``dual``; the whole bank for ``bank``."""
        if self.mode == "single":
            return [hwio(self.sal_layer)]
        if self.mode == "dual":
            return [hwio(self.sal_layer_true), hwio(self.sal_layer_false)]
        return [(self.bank_kernel, self.bank_bias)]


# ---------------------------------------------------------------------------
# Fused conditioner+head evaluation
#
# The conditioner's 5x5 conv output feeds the head with no nonlinearity
# in between, and every head consumer of it is a linear C->1 conv, so
# the chain composes exactly: contract the conditioner kernel with each
# head kernel once per forward and apply only C->1 convs per step.  The
# drt composition (7x7 stride 5 after 5x5, both zero-padded) is an 11x11
# stride-5 conv on the zero-extended input plus corrections for the
# windows that overlap the conditioner's zero padding (output row 0 and
# column 0 when H and W are divisible by 5).
# ---------------------------------------------------------------------------


def _rowcomp(k1row, kdrow):
    """1-D kernel composition: out[q, i] = sum_{b+dx=q} kdrow[b, o] *
    k1row[dx, i, o], with dx in 0..4, b in 0..6, q in 0..10."""
    parts = torch.einsum("xio,bo->bxi", k1row, kdrow)   # [7, 5, C]
    out = k1row.new_zeros((11, k1row.shape[1]))
    for b in range(7):
        out[b:b + 5] += parts[b]
    return out


def fuse_cond_head(k1, b1, head_raw: dict, map_h: int, map_w: int) -> dict:
    """Compose a [5, 5, C, C] HWIO conditioner kernel/bias with the
    head's three C->1 convs (``PredictHead.raw``).  All maths in the
    parameters' dtype.  Returns the tensors
    :func:`apply_fused_cond_head` consumes.  While spans are on
    (``utils/tracing.py``) each call adds one to ``cond_head.composed``."""
    if tracing.active():
        tracing.count("cond_head.composed")
    c = k1.shape[2]
    w2k, w2b = head_raw["w2"]
    w3k, w3b = head_raw["w3"]
    kdk, kdb = head_raw["kd"]
    w2 = w2k[0, 0, :, 0]
    w3 = w3k[0, 0, :, 0]
    kd = kdk[..., 0]                                    # [7, 7, Co]

    # 1x1 head convs compose exactly (stop map + action map)
    k_sa = torch.stack([torch.einsum("yxco,o->yxc", k1, w2),
                        torch.einsum("yxco,o->yxc", k1, w3)], dim=-1)
    b_sa = torch.stack([b1 @ w2 + w2b[0], b1 @ w3 + w3b[0]])

    # drt main term: the 11x11 composite kernel, a "full" correlation of
    # the conditioner kernel (as C images of 5x5xCo) with the flipped drt
    # kernel
    lhs = k1.permute(2, 0, 1, 3)                        # [C, 5, 5, Co]
    rhsf = kd.flip(0, 1)[..., None]                     # [7, 7, Co, 1]
    keff = conv2d(lhs, rhsf, padding=((6, 6), (6, 6)))  # [C, 11, 11, 1]
    keff = keff[..., 0].permute(1, 2, 0)[..., None]     # [11, 11, C, 1]

    # border corrections: virtual conditioner rows/cols -2 and -1 that
    # the zero-extended main term wrongly includes
    wr = torch.stack([_rowcomp(k1[4], kd[0]) + _rowcomp(k1[3], kd[1]),
                      _rowcomp(k1[4], kd[1])])          # [2(y), 11(q), C]
    wc0 = _rowcomp(k1[:, 4], kd[:, 0]) + _rowcomp(k1[:, 3], kd[:, 1])
    wc1 = _rowcomp(k1[:, 4], kd[:, 1])
    wc = torch.stack([wc0, wc1], dim=1)                 # [11(p), 2(x), C]

    # the corner is subtracted twice above: add it back once
    def cc_term(y, x):
        acc = k1.new_zeros((c,))
        for j in range(y, 2):
            for k in range(x, 2):
                acc = acc + torch.einsum("o,io->i", kd[j, k],
                                         k1[y + 4 - j, x + 4 - k])
        return acc
    wcc = torch.stack([torch.stack([cc_term(0, 0), cc_term(0, 1)]),
                       torch.stack([cc_term(1, 0), cc_term(1, 1)])])

    # conditioner bias through the drt window, clipped to the image: a
    # geometry-dependent [h5, w5] constant map
    k2b1 = torch.einsum("abo,o->ab", kd, b1)
    ones = k1.new_ones((1, map_h, map_w, 1))
    b1map = conv2d(ones, k2b1[..., None, None], strides=(5, 5),
                   padding=((2, 2), (2, 2)))[0, ..., 0]

    return {"k_sa": k_sa, "b_sa": b_sa, "keff": keff, "wr": wr, "wc": wc,
            "wcc": wcc, "b1map": b1map, "bd": kdb[0]}


def fuse_bank_heads(bank_k, bank_b, task_ids, head_raw: dict, map_h: int,
                    map_w: int) -> dict:
    """The composed conditioner+head of each sample's bank entry: every
    field of :func:`fuse_cond_head` with a leading [N] axis.  Only the
    entries whose ids occur in ``task_ids`` [N] are composed, once each
    (the same values as composing all K entries and gathering)."""
    ids, inv = torch.unique(task_ids, return_inverse=True)
    ids = ids.tolist()
    if ids[0] < 0 or ids[-1] >= bank_k.shape[0]:
        raise ValueError(f"task ids {ids} outside the bank of "
                         f"{bank_k.shape[0]} heads")
    parts = [fuse_cond_head(bank_k[i], bank_b[i], head_raw, map_h, map_w)
             for i in ids]
    return {key: torch.stack([p[key] for p in parts])[inv]
            for key in parts[0]}


def compose_bank_heads(bank_k, bank_b, head_raw: dict, map_h: int,
                       map_w: int) -> dict:
    """Every bank entry's composed conditioner+head, each composed once
    on its own: the fields of :func:`fuse_cond_head` with a leading [K]
    axis.  Gathered by task id, ``{k: v[task_ids]}``, they are
    :func:`fuse_bank_heads`'s values exactly, with no data-dependent
    shape (the serving export keeps them and gathers per call)."""
    parts = [fuse_cond_head(bank_k[i], bank_b[i], head_raw, map_h, map_w)
             for i in range(bank_k.shape[0])]
    return {key: torch.stack([p[key] for p in parts]) for key in parts[0]}


def apply_fused_cond_head(h, fused: dict, dtype,
                          differentiable: bool = False):
    """Apply the composed conditioner+head to the ConvLSTM state ``h``
    [N, H, W, C], cast to ``dtype``: one :func:`fuse_cond_head` dict for
    the whole batch, or one per sample with a leading [N] axis on every
    field (:func:`fuse_bank_heads`).  Returns (stop_logit [N, 1], amap
    [N, H, W], drt_raw [N, h5, w5]) in float32 (float64 when ``h`` is),
    drt_raw being the pre-relu drt_layer_1 output for
    :meth:`PredictHead.finish_duration`.

    ``ops.head.cond_head`` computes it: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU one.  ``differentiable`` (the
    training forward) takes the plain version, in stock ops, on either:
    the kernel has no backward."""
    h = h.to(dtype)
    if differentiable:
        return head_ops.cond_head_plain(h, fused)
    return head_ops.cond_head(h, fused)
