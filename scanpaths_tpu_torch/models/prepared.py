"""The weights the eval forward's kernels read, derived from the
parameters once per weight version: the trunk's convs with BatchNorm
folded in and layers 1-3 stacked for ``ops.block.stage_apply``, the
h-gate kernel and constant gate bias of ``ops.cell.cell_step``, and the
conditioner of every stream composed with the head
(``ops.compose.cond_compose``).  Each is kept by ``ops._build.cached``
and made anew after an optimizer step, a ``load_state_dict``, a BN
statistics update or a ``.to()``; under ``torch.export`` it is traced
into the program and nothing is kept.  ``differentiable`` (the training
forward's) derives them each call in stock ops, with their gradients.
COCO's heads are gathered by task id in one place, :func:`gather_heads`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops._build import cached
from ..ops.compose import compose_bank_heads, cond_compose
from .components import hwio

def fold_bn(kernel, scale, beta, mean, var, eps: float = 1e-5):
    """Fold inference BatchNorm into the preceding bias-free conv:
    W' = W * s, b' = beta - mean * s with s = gamma / sqrt(var + eps)
    (exact; ``kernel`` is OIHW, s scales the output channels)."""
    s = scale / torch.sqrt(var + eps)
    return kernel * s.reshape(-1, *([1] * (kernel.dim() - 1))), beta - mean * s


def stack_stage_params(blocks, dtype) -> dict:
    """Fold BN and stack the uniform blocks of a stage for the kernel.

    ``blocks`` are :class:`models.resnet.Bottleneck` modules with equal
    channel shapes and no downsample.  Returns w1 [B, C, M], w2 [B, 9M, M]
    (tap-major rows, the HWIO kernel flattened), w3 [B, M, C] in
    ``dtype`` and the float32 biases b1, b2 [B, M], b3 [B, C].
    """
    convs = [_block(blk, torch.float32) for blk in blocks]
    m = convs[0][0][0].shape[0]
    layouts = (lambda k: k[:, :, 0, 0].t(),
               lambda k: k.permute(2, 3, 1, 0).reshape(9 * m, m),
               lambda k: k[:, :, 0, 0].t())
    out = {}
    for i, layout in enumerate(layouts):
        out[f"w{i + 1}"] = torch.stack([layout(c[i][0]) for c in convs]
                                       ).to(dtype).contiguous()
        out[f"b{i + 1}"] = torch.stack([c[i][1] for c in convs]).contiguous()
    return out


def _folded(conv, bn, dtype):
    """(kernel OIHW, bias) of a conv and the eval-mode BN after it, in
    ``dtype``."""
    k, b = fold_bn(conv.weight, bn.weight, bn.bias, bn.running_mean,
                   bn.running_var, bn.eps)
    return k.to(dtype), b.to(dtype)


def _block(blk, dtype) -> list:
    """A bottleneck's three convs, folded."""
    return [_folded(getattr(blk, f"conv{i}"), getattr(blk, f"bn{i}"), dtype)
            for i in (1, 2, 3)]


def _tensors(*modules) -> list:
    """Every parameter and buffer of ``modules``, read from the modules'
    own tables: a third of the host time of ``parameters()`` and
    ``buffers()``, which a forward would pay on every call."""
    return [t for mod in modules for m in mod.modules()
            for d in (m._parameters, m._buffers) for t in d.values()
            if t is not None]


def stem(net, dtype):
    """The folded (kernel OIHW, bias) of the first conv of ``net`` (a
    ``DilatedResNet50``) in ``dtype``."""
    return cached(net, ("stem", dtype), _tensors(net.conv1, net.bn1),
                  lambda: _folded(net.conv1, net.bn1, dtype))


def stage(net, si: int, dtype) -> dict:
    """The weights of stage ``si`` (1-4) of ``net`` for
    ``resnet.fused_forward`` in ``dtype``: ``first``, the first block's
    three folded convs, and ``down``, its downsample; ``stack``, the
    other blocks stacked for ``ops.block.stage_apply`` (layers 1-3), else
    None and ``rest``, their folded convs (layer 4: its 3x3 dilated at
    rate 4 is left to cuDNN).  A stage at a time, so that a traced
    program folds a stage's weights while the card runs the stage
    before it."""
    blocks = [net.block(si, bi) for bi in range(net.layers[si - 1])]

    def build():
        first, rest = blocks[0], blocks[1:]
        stack = stack_stage_params(rest, dtype) if si <= 3 and rest \
            else None
        return {"first": _block(first, dtype),
                "down": _folded(first.downsample_conv, first.downsample_bn,
                                dtype),
                "stack": stack,
                "rest": [] if stack else [_block(b, dtype) for b in rest]}

    return cached(net, ("stage", si, dtype), _tensors(*blocks), build)


def cell(lstm, differentiable: bool = False):
    """(h-gate kernel, gate bias) of a ``FusedConvLSTMCell``, in its
    dtype.  The kernel is HWIO [3, 3, C, 4C], contiguous, as
    ``ops.cell.cell_step`` takes it, or with ``differentiable`` the OIHW
    weight, as ``FusedConvLSTMCell.step`` takes it (a row-parallel block
    of it under TP).  The bias [4C] is the h-gate bias plus the summed
    signal biases (i/f/o), added to the hoisted x-gates."""
    gh = lstm.gates_h
    sbias = [lstm._sgate(i).bias for i in range(lstm.num_signals)]

    def build():
        bias = gh.bias + F.pad(sum(sbias), (0, lstm.embed))
        if differentiable:
            return gh.weight.to(lstm.dtype), bias.to(lstm.dtype)
        if gh.weight.shape[1] != lstm.embed:
            raise ValueError("the cell kernel takes the whole h-gate kernel: "
                             "gather the sliced kernels first "
                             "(train/tp_step.py::gathered)")
        return (hwio(gh)[0].to(lstm.dtype).contiguous(),
                bias.to(lstm.dtype))

    if differentiable:
        return build()
    return cached(lstm, ("cell", lstm.dtype), [gh.weight, gh.bias, *sbias],
                  build)


def composed(bank_k, bank_b, head_raw: dict, map_h: int, map_w: int,
             differentiable: bool = False) -> dict:
    """Every entry of ``bank_k`` (a [K, 5, 5, C, C] stack or a sequence
    of HWIO kernels) and ``bank_b`` composed with the head
    (``PredictHead.raw``): the fields of ``ops.compose.fuse_cond_head``
    with a leading [K] axis.  ``ops.compose.cond_compose``, one kernel
    launch on the card, once per weight version; with ``differentiable``
    its plain version in stock ops, each call."""
    if differentiable:
        return compose_bank_heads(bank_k, bank_b, head_raw, map_h, map_w)
    entries = [bank_k, bank_b] if torch.is_tensor(bank_k) else \
        [*bank_k, *bank_b]
    sources = entries + [t for key in ("w2", "w3", "kd")
                         for t in head_raw[key]]
    first = entries[0] if entries[0]._base is None else entries[0]._base
    return cached(first, ("composed", map_h, map_w), sources,
                  lambda: cond_compose(bank_k, bank_b, head_raw, map_h,
                                       map_w))


def heads(model, differentiable: bool = False) -> list[dict]:
    """The composed conditioner+head of every stream of ``model`` (a
    ``ScanpathModel``), by :func:`composed`: one dict a stream, or for
    COCO one whose fields lead with the bank's [K] axis (gathered per
    sample by :func:`gather_heads`)."""
    raw = model.head.raw()
    pairs = model.conditioner.kernels()
    if model.conditioner.mode == "bank":
        (bank_k, bank_b), = pairs
        return [composed(bank_k, bank_b, raw, model.map_h, model.map_w,
                         differentiable)]
    bank = composed([k for k, _ in pairs], [b for _, b in pairs], raw,
                    model.map_h, model.map_w, differentiable)
    return [{key: v[s] for key, v in bank.items()}
            for s in range(len(pairs))]


def gather_heads(bank: dict, task_ids) -> dict:
    """Each sample's entry of a composed bank (fields with a leading [K]
    axis): every field gathered by ``task_ids`` [N] on the bank's
    device, with no host sync.  Ids in a host tensor are checked on the
    host (ValueError); ids on the card, or under tracing, by an
    asynchronous device assert."""
    k = bank["bd"].shape[0]
    if task_ids.device.type == "cpu" and not torch.compiler.is_compiling():
        if task_ids.numel() and not (0 <= int(task_ids.min())
                                     and int(task_ids.max()) < k):
            raise ValueError(f"task ids {sorted(set(task_ids.tolist()))} "
                             f"outside the bank of {k} heads")
    else:
        torch._assert_async(((task_ids >= 0) & (task_ids < k)).all(),
                            f"task ids outside the bank of {k} heads")
    ids = task_ids.to(bank["bd"].device)
    return {key: v.index_select(0, ids) for key, v in bank.items()}


def fuse_bank_heads(bank_k, bank_b, task_ids, head_raw: dict, map_h: int,
                    map_w: int, differentiable: bool = False) -> dict:
    """The composed conditioner+head of each sample's bank entry: every
    field of ``ops.compose.fuse_cond_head`` with a leading [N] axis, the
    whole bank composed (:func:`composed`) and gathered by ``task_ids``
    (:func:`gather_heads`)."""
    return gather_heads(composed(bank_k, bank_b, head_raw, map_h, map_w,
                                 differentiable), task_ids)
