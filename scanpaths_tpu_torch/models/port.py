"""Weights carried into the port's :class:`ScanpathModel` (every task).

* :func:`load_reference_state_dict` — a state dict in the reference's
  torch layout (the reference's own checkpoints, or what
  ``scanpaths_tpu/models/port.py::export_reference_state_dict`` writes)
  -> the port's state dict.  The per-gate convs of the ConvLSTM are
  concatenated into its fused convs here, at load time.
* :func:`from_jax_params` — the JAX package's flax trees (nested dicts
  of numpy arrays) -> the port's state dict, through the reference
  layout: HWIO -> OIHW, Dense [in, out] -> Linear [out, in].

Both return a dict for ``ScanpathModel.load_state_dict``;
:func:`to_reference_state_dict` goes back to the reference layout.

The joint model (``JointScanpathModel``) is stored in the joint layout:
its trunk once, under the reference's trunk keys (``resnet.*``), and
each head's reference-layout keys under ``<task>.``
(:func:`to_joint_reference_state_dict`).
:func:`load_joint_reference_state_dict` reads the whole joint model
back; :func:`task_reference_state_dict` takes out one task's
single-task reference layout (the trunk and that head), which
:func:`load_reference_state_dict` and the single-task ``ScanpathModel``
read as they read a single-task run's.  :func:`joint_from_jax_params`
carries the JAX package's joint flax trees (``{backbone, osie, air,
coco}``) over.

The task-specific names (reference AiR/COCO variants):

  reference                              port (ScanpathModel)
  -------------------------------------  ------------------------------
  lstm.{input,forget,output}             lstm.gates_s0 (OSIE, COCO)
  lstm.{input,forget,output}_pos         lstm.gates_s0 (AiR, good stream)
  lstm.{input,forget,output}_neg         lstm.gates_s1 (AiR, poor stream)
  performance_sal_layer                  conditioner.sal_layer (OSIE)
  performance_sal_layer.{True,False}     conditioner.sal_layer_{true,false}
  object_sal_layer.<category>            conditioner.bank_{kernel,bias}[k],
                                         k in COCO_OBJECT_NAMES order
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.datasets import COCO_OBJECT_NAMES

GATES_XH = ("input", "forget", "output", "memory")   # fused order i,f,o,g
GATES_S = ("input", "forget", "output")              # fused order i,f,o
_STAGE_INDEX = {"4": 1, "5": 2, "6": 3, "7": 4}      # resnet.<i> -> layer
_HEAD = ("sal_layer_2", "sal_layer_3", "drt_layer_1", "drt_layer_2")
# the reference's signal-gate suffixes, one per stream (gates_s0, gates_s1)
_SIGNAL_SUFFIXES = {"osie": ("",), "air": ("_pos", "_neg"), "coco": ("",)}
_DUAL = (("true", "True"), ("false", "False"))


def _check_task(task: str) -> None:
    if task not in _SIGNAL_SUFFIXES:
        raise ValueError(f"task {task!r}: one of {sorted(_SIGNAL_SUFFIXES)}")


def load_reference_state_dict(sd: dict, task: str = "osie") -> dict:
    """Reference-layout state dict (a bare state dict or a
    ``{"model": state_dict, ...}`` checkpoint, optional ``module.``
    prefixes) -> the port's ``ScanpathModel(task)`` state dict."""
    _check_task(task)
    sd = sd.get("model", sd)
    sd = {k.removeprefix("module."): (v if isinstance(v, torch.Tensor)
                                      else torch.tensor(np.array(v)))
          for k, v in sd.items()}
    out: dict[str, torch.Tensor] = {}

    # trunk: the reference strips resnet50 into an nn.Sequential whose
    # children 0, 1, 4..7 are conv1, bn1, layer1..layer4
    for key, v in sd.items():
        if not key.startswith("resnet."):
            continue
        idx, rest = key[len("resnet."):].split(".", 1)
        if idx == "0":
            name = f"conv1.{rest}"
        elif idx == "1":
            name = f"bn1.{rest}"
        else:
            bi, rest = rest.split(".", 1)
            rest = rest.replace("downsample.0.", "downsample_conv.") \
                       .replace("downsample.1.", "downsample_bn.")
            name = f"layer{_STAGE_INDEX[idx]}_block{bi}.{rest}"
        out[f"backbone.{name}"] = v
    for key in [k for k in out if k.endswith(".running_var")]:
        nbt = key.replace(".running_var", ".num_batches_tracked")
        out.setdefault(nbt, torch.tensor(0, dtype=torch.long))

    def copy(dst, src):
        out[f"{dst}.weight"] = sd[f"{src}.weight"]
        out[f"{dst}.bias"] = sd[f"{src}.bias"]

    def stack(dst, srcs):
        out[f"{dst}.weight"] = torch.cat([sd[f"{s}.weight"] for s in srcs])
        out[f"{dst}.bias"] = torch.cat([sd[f"{s}.bias"] for s in srcs])

    copy("sal_conv", "sal_conv")
    stack("xgates.gates_x", [f"lstm.{g}_x" for g in GATES_XH])
    stack("lstm.gates_h", [f"lstm.{g}_h" for g in GATES_XH])
    for i, suffix in enumerate(_SIGNAL_SUFFIXES[task]):
        stack(f"lstm.gates_s{i}", [f"lstm.{g}{suffix}" for g in GATES_S])
    copy("semantic_embed", "semantic_embed")
    copy("spatial_embed", "spatial_embed")
    copy("semantic_att.lists", "semantic_att.semantic_lists")
    copy("semantic_att.cur", "semantic_att.semantic_cur")
    copy("semantic_att.att", "semantic_att.semantic_attention")
    copy("spatial_att.lists_conv", "spatial_att.spatial_lists")
    copy("spatial_att.cur_conv", "spatial_att.spatial_cur")
    # the (map_h, map_w)-kernel scoring conv is a Linear over the
    # row-major flattened map: [1, 1, H, W] -> [1, H*W]
    copy("spatial_att.att", "spatial_att.spatial_attention")
    out["spatial_att.att.weight"] = out["spatial_att.att.weight"].reshape(
        1, -1)
    if task == "osie":
        copy("conditioner.sal_layer", "performance_sal_layer")
    elif task == "air":
        for ours, ref in _DUAL:
            copy(f"conditioner.sal_layer_{ours}",
                 f"performance_sal_layer.{ref}")
    else:
        out["conditioner.bank_kernel"] = torch.stack(
            [sd[f"object_sal_layer.{c}.weight"].permute(2, 3, 1, 0)
             for c in COCO_OBJECT_NAMES])
        out["conditioner.bank_bias"] = torch.stack(
            [sd[f"object_sal_layer.{c}.bias"] for c in COCO_OBJECT_NAMES])
    for name in _HEAD:
        copy(f"head.{name}", f"object_head.{name}")
    return out


def to_reference_state_dict(sd: dict, task: str, map_h: int,
                            map_w: int) -> dict:
    """The port's ``ScanpathModel(task)`` state dict -> the reference's
    torch layout, the inverse of :func:`load_reference_state_dict` (the
    fused gate convs split back per gate, the spatial scoring Linear back
    to its (map_h, map_w) conv)."""
    _check_task(task)
    stage_child = {v: k for k, v in _STAGE_INDEX.items()}
    out: dict[str, torch.Tensor] = {}
    for key, v in sd.items():
        if not key.startswith("backbone.") or \
                key.endswith(".num_batches_tracked"):
            continue
        name, rest = key[len("backbone."):].split(".", 1)
        if name == "conv1":
            out[f"resnet.0.{rest}"] = v
        elif name == "bn1":
            out[f"resnet.1.{rest}"] = v
        else:
            stage, block = name[len("layer"):].split("_block")
            rest = rest.replace("downsample_conv.", "downsample.0.") \
                       .replace("downsample_bn.", "downsample.1.")
            out[f"resnet.{stage_child[int(stage)]}.{block}.{rest}"] = v

    def copy(src, dst):
        out[f"{dst}.weight"] = sd[f"{src}.weight"]
        out[f"{dst}.bias"] = sd[f"{src}.bias"]

    def split(src, dsts):
        for name, w, b in zip(dsts, sd[f"{src}.weight"].chunk(len(dsts)),
                              sd[f"{src}.bias"].chunk(len(dsts))):
            out[f"{name}.weight"], out[f"{name}.bias"] = w, b

    copy("sal_conv", "sal_conv")
    split("xgates.gates_x", [f"lstm.{g}_x" for g in GATES_XH])
    split("lstm.gates_h", [f"lstm.{g}_h" for g in GATES_XH])
    for i, suffix in enumerate(_SIGNAL_SUFFIXES[task]):
        split(f"lstm.gates_s{i}", [f"lstm.{g}{suffix}" for g in GATES_S])
    copy("semantic_embed", "semantic_embed")
    copy("spatial_embed", "spatial_embed")
    copy("semantic_att.lists", "semantic_att.semantic_lists")
    copy("semantic_att.cur", "semantic_att.semantic_cur")
    copy("semantic_att.att", "semantic_att.semantic_attention")
    copy("spatial_att.lists_conv", "spatial_att.spatial_lists")
    copy("spatial_att.cur_conv", "spatial_att.spatial_cur")
    copy("spatial_att.att", "spatial_att.spatial_attention")
    out["spatial_att.spatial_attention.weight"] = \
        out["spatial_att.spatial_attention.weight"].reshape(
            1, 1, map_h, map_w)
    if task == "osie":
        copy("conditioner.sal_layer", "performance_sal_layer")
    elif task == "air":
        for ours, ref in _DUAL:
            copy(f"conditioner.sal_layer_{ours}",
                 f"performance_sal_layer.{ref}")
    else:
        for k, c in enumerate(COCO_OBJECT_NAMES):
            out[f"object_sal_layer.{c}.weight"] = \
                sd["conditioner.bank_kernel"][k].permute(3, 2, 0, 1)
            out[f"object_sal_layer.{c}.bias"] = sd["conditioner.bank_bias"][k]
    for name in _HEAD:
        copy(f"head.{name}", f"object_head.{name}")
    return {k: v.detach().clone() for k, v in out.items()}


def _flax_to_reference(params: dict, batch_stats: dict, task: str,
                       map_h: int, map_w: int) -> dict:
    """The JAX model's flax trees of ``task`` -> reference-layout numpy
    state dict, at any map geometry."""
    _check_task(task)
    sd: dict[str, np.ndarray] = {}
    a = np.asarray

    def conv(name, leaf):
        sd[f"{name}.weight"] = np.transpose(a(leaf["kernel"]), (3, 2, 0, 1))
        if "bias" in leaf:
            sd[f"{name}.bias"] = a(leaf["bias"])

    def lin(name, leaf):
        sd[f"{name}.weight"] = np.transpose(a(leaf["kernel"]), (1, 0))
        sd[f"{name}.bias"] = a(leaf["bias"])

    def bn(name, p, s):
        sd[f"{name}.weight"] = a(p["scale"])
        sd[f"{name}.bias"] = a(p["bias"])
        sd[f"{name}.running_mean"] = a(s["mean"])
        sd[f"{name}.running_var"] = a(s["var"])

    bp, bs = params["backbone"], batch_stats["backbone"]
    conv("resnet.0", bp["conv1"])
    bn("resnet.1", bp["bn1"], bs["bn1"])
    stage_child = {v: k for k, v in _STAGE_INDEX.items()}
    for key in bp:
        if not key.startswith("layer"):
            continue
        stage, block = key[len("layer"):].split("_block")
        pre = f"resnet.{stage_child[int(stage)]}.{block}"
        for ci in (1, 2, 3):
            conv(f"{pre}.conv{ci}", bp[key][f"conv{ci}"])
            bn(f"{pre}.bn{ci}", bp[key][f"bn{ci}"], bs[key][f"bn{ci}"])
        if "downsample_conv" in bp[key]:
            conv(f"{pre}.downsample.0", bp[key]["downsample_conv"])
            bn(f"{pre}.downsample.1", bp[key]["downsample_bn"],
               bs[key]["downsample_bn"])

    conv("sal_conv", params["sal_conv"])

    def split_gates(leaf, names, suffix):
        ks = np.split(a(leaf["kernel"]), len(names), axis=-1)
        bs_ = np.split(a(leaf["bias"]), len(names))
        for g, k, b in zip(names, ks, bs_):
            sd[f"lstm.{g}{suffix}.weight"] = np.transpose(k, (3, 2, 0, 1))
            sd[f"lstm.{g}{suffix}.bias"] = b

    split_gates(params["xgates"]["gates_x"], GATES_XH, "_x")
    split_gates(params["lstm"]["gates_h"], GATES_XH, "_h")
    for i, suffix in enumerate(_SIGNAL_SUFFIXES[task]):
        split_gates(params["lstm"][f"gates_s{i}"], GATES_S, suffix)
    lin("semantic_embed", params["semantic_embed"])
    lin("spatial_embed", params["spatial_embed"])
    for ours, ref in (("lists", "semantic_lists"), ("cur", "semantic_cur"),
                      ("att", "semantic_attention")):
        lin(f"semantic_att.{ref}", params["semantic_att"][ours])
    conv("spatial_att.spatial_lists", params["spatial_att"]["lists_conv"])
    conv("spatial_att.spatial_cur", params["spatial_att"]["cur_conv"])
    att = params["spatial_att"]["att"]
    sd["spatial_att.spatial_attention.weight"] = \
        a(att["kernel"]).T.reshape(1, 1, map_h, map_w)
    sd["spatial_att.spatial_attention.bias"] = a(att["bias"])
    cond = params["conditioner"]
    if task == "osie":
        conv("performance_sal_layer", cond["sal_layer"])
    elif task == "air":
        for ours, ref in _DUAL:
            conv(f"performance_sal_layer.{ref}", cond[f"sal_layer_{ours}"])
    else:
        for k, c in enumerate(COCO_OBJECT_NAMES):
            sd[f"object_sal_layer.{c}.weight"] = np.transpose(
                a(cond["bank_kernel"][k]), (3, 2, 0, 1))
            sd[f"object_sal_layer.{c}.bias"] = a(cond["bank_bias"][k])
    for name in _HEAD:
        conv(f"object_head.{name}", params["head"][name])
    return sd


def from_jax_params(params: dict, batch_stats: dict, task: str = "osie",
                    map_h: int = 30, map_w: int = 40) -> dict:
    """The JAX package's (params, batch_stats) flax trees, as nested
    dicts of numpy arrays -> the port's ``ScanpathModel(task)`` state
    dict."""
    return load_reference_state_dict(
        _flax_to_reference(params, batch_stats, task, map_h, map_w), task)


JOINT_TASKS = ("osie", "air", "coco")


def _is_trunk(key: str) -> bool:
    return key.startswith("resnet.")


def to_joint_reference_state_dict(sd: dict, map_h: int, map_w: int) -> dict:
    """The port's ``JointScanpathModel`` state dict -> the joint layout:
    the trunk once under ``resnet.*``, each head's reference-layout keys
    under ``<task>.``."""
    trunk = {k: v for k, v in sd.items() if k.startswith("backbone.")}
    out: dict[str, torch.Tensor] = {}
    for task in JOINT_TASKS:
        pre = task + "."
        head = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
        ref = to_reference_state_dict({**trunk, **head}, task, map_h, map_w)
        for key, v in ref.items():
            out[key if _is_trunk(key) else pre + key] = v
    return out


def task_reference_state_dict(sd: dict, task: str) -> dict:
    """One task's single-task reference-layout state dict (the trunk and
    that head) from a joint-layout one (a bare state dict or a
    ``{"model": ...}`` checkpoint)."""
    _check_task(task)
    sd = sd.get("model", sd)
    pre = task + "."
    out = {k: v for k, v in sd.items() if _is_trunk(k)}
    out.update({k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)})
    return out


def load_joint_reference_state_dict(sd: dict) -> dict:
    """Joint-layout state dict (or ``{"model": ...}`` checkpoint) -> the
    port's ``JointScanpathModel`` state dict."""
    out: dict[str, torch.Tensor] = {}
    for task in JOINT_TASKS:
        for key, v in load_reference_state_dict(
                task_reference_state_dict(sd, task), task).items():
            out[key if key.startswith("backbone.") else f"{task}.{key}"] = v
    return out


def joint_from_jax_params(params: dict, batch_stats: dict, map_h: int = 30,
                          map_w: int = 40) -> dict:
    """The JAX package's ``JointScanpathModel`` trees (``{backbone, osie,
    air, coco}``, nested dicts of numpy arrays) -> the port's
    ``JointScanpathModel`` state dict; each task's trunk-plus-head tree
    goes through :func:`from_jax_params`."""
    out: dict[str, torch.Tensor] = {}
    for task in JOINT_TASKS:
        single = from_jax_params(
            {"backbone": params["backbone"], **params[task]},
            {"backbone": batch_stats["backbone"]}, task, map_h, map_w)
        for key, v in single.items():
            out[key if key.startswith("backbone.") else f"{task}.{key}"] = v
    return out
