"""Serving export (port of ``scanpaths_tpu/serve/export.py``): the whole
decode path (trunk -> ConvLSTM decoder -> head -> decoder of the
scanpaths) as one ``torch.export.ExportedProgram`` with the trained
weights inside.

Bundle layout (a directory):

    serve.pt2       the program, saved by ``torch.export.save`` (its
                    tensors stored on the CPU)
    manifest.json   task / decode / geometry / signature / versions

The cell and stage kernels are the registered ops
``scanpaths_tpu_torch::cell_step`` and ``::stage_apply``, so the program
launches the hand-written CUDA kernels on the card and their plain
versions on the CPU.  A serving host imports ``scanpaths_tpu_torch.ops``
(which registers them) and torch, and nothing of the port's models,
training or CLIs; :func:`load_bundle` needs no more.

The callable :func:`load_bundle` returns takes the JAX bundle's
positional signature:

    osie:  (images,)                        greedy
           (seed, images)                   sample
    air:   (images, attention_maps)         + seed first when sampling
    coco:  (images, attention_maps, tasks)  + seed first when sampling

with ``images`` [B, H, W, 3] float32 (ImageNet-normalized,
``data.transforms.load_image``), ``attention_maps`` [B, mh, mw, 1]
float32 max-normalized, ``tasks`` [B] int32 category ids and ``seed`` an
integer.  The random draws stay outside the program: a sampled
program takes the Gumbel and normal noise ([R, B, T, 1+HW], [R, B, T];
the manifest's ``noise``) ahead of the images, and the callable draws
them from a ``torch.Generator`` on the bundle's device seeded with
``seed`` (``ops.sampling.sample_noise``), so one seed gives one output.
Outputs are a dict of ``fix`` [(R,) B, T, 3] pixel fixations (x, y,
duration in seconds), ``fix_len`` [(R,) B] and ``action_probs``
[(R,) B, T].

The batch is a fixed int or symbolic (``batch="sym"``): one program then
serves any batch size.
"""

from __future__ import annotations

import copy
import json
import os
from os.path import join
from typing import Any, Sequence

import torch
from torch import nn
from torch.export.passes import move_to_device_pass
from torch.overrides import TorchFunctionMode

from .. import ops  # noqa: F401  (registers the kernels' ops)
from ..core.grid import GridSpec
from ..ops.sampling import greedy_sample, random_sample_from_noise, \
    sample_noise

_PROGRAM = "serve.pt2"
_MANIFEST = "manifest.json"
DEVICES = ("cuda", "cpu")


class ServeModule(nn.Module):
    """The eval forward and decoder of ``model`` (a
    ``models.scanpath_model.ScanpathModel``; a joint run's head is one,
    ``serve/predictor.py``) as one module, the counterpart of the JAX
    package's ``build_serve_fn``.  ``stream`` picks the AiR stream
    ("good": the right-answer one, as ``cli/predict.py`` serves).

    COCO's bank of conditioners is composed with the head once here,
    every entry, into buffers gathered per call by task id
    (``model.composed_heads``), where the live forward composes the
    whole bank in each call.  The module then holds the model without
    its conditioner, so the bank's weights stay out of a bundle.  The
    other tasks compose in the forward, as the live model does, so a
    bundle moved to another device computes what the live model computes
    there (a COCO bundle keeps the composition of the device it was
    exported on).  Greedy:
    ``forward(images[, attention_maps[, tasks]])``; sampled:
    ``forward(gumbel, normal, images, ...)`` with the noise of
    :func:`ops.sampling.sample_noise` at ``rollouts=R``.  Call it under
    ``torch.no_grad()``.
    """

    def __init__(self, model, grid: GridSpec, decode: str = "greedy",
                 stream: str = "good"):
        super().__init__()
        if decode not in ("greedy", "sample"):
            raise ValueError(f"decode {decode!r}: greedy or sample")
        self.decode, self.grid = decode, grid
        self.prefix = f"{stream}_" if model.task == "air" else ""
        self.model, self.bank_keys = model, []
        if model.task == "coco":
            with torch.no_grad():
                bank, = model.composed_heads()
            self.bank_keys = sorted(bank)
            for key in self.bank_keys:
                self.register_buffer(f"bank_{key}", bank[key].clone())
            # a shallow copy sharing every submodule but the conditioner
            self.model = copy.copy(model)
            self.model._modules = {k: v for k, v in model._modules.items()
                                   if k != "conditioner"}

    def forward(self, *inputs):
        if self.decode == "sample":
            gumbel, normal, *inputs = inputs
        images, maps, tasks = (list(inputs) + [None, None])[:3]
        heads = None
        if self.bank_keys:
            heads = [{k: getattr(self, f"bank_{k}") for k in self.bank_keys}]
        out = self.model.eval_forward(images, maps, tasks, heads=heads)
        probs = out[self.prefix + "all_actions_prob"]
        mu = out[self.prefix + "log_normal_mu"]
        sigma2 = out[self.prefix + "log_normal_sigma2"]
        if self.decode == "greedy":
            s = greedy_sample(probs, mu, sigma2, self.grid)
        else:
            s = random_sample_from_noise(probs, mu, sigma2, self.grid,
                                         gumbel, normal)
        return {"fix": s.fix, "fix_len": s.fix_len,
                "action_probs": s.action_probs}


class _SkipNoopCasts(TorchFunctionMode):
    """Under export: ``t.to(dtype)`` of a tensor already in ``dtype``
    returns ``t`` untraced.  It is a no-op at run time, but the trace
    records it with a metadata assert: hundreds of nodes a serving graph,
    which the export, the save, the load and every call pay for."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (func is torch.Tensor.to and len(args) == 2 and not kwargs
                and isinstance(args[1], torch.dtype)
                and args[0].dtype == args[1]):
            return args[0]
        return func(*args, **(kwargs or {}))


def _drop_metadata_asserts(program) -> None:
    """Erase the metadata asserts the trace records beside every cast (a
    bfloat16 program keeps hundreds of real casts): checks of what the
    trace already fixed, one op call each at run time."""
    graph = program.graph_module.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
    program.graph_module.recompile()


def _signature(task: str, decode: str, batch, grid: GridSpec, map_h: int,
               map_w: int, num_samples: int) -> tuple[list, list]:
    """(the callable's inputs, the sampled program's noise inputs), each
    a list of dicts of name, shape (``"b"`` for a symbolic batch) and
    dtype."""
    b = "b" if batch == "sym" else int(batch)
    inputs = [{"name": "images", "shape": [b, grid.height, grid.width, 3],
               "dtype": "float32"}]
    if task in ("air", "coco"):
        inputs.append({"name": "attention_maps",
                       "shape": [b, map_h, map_w, 1], "dtype": "float32"})
    if task == "coco":
        inputs.append({"name": "tasks", "shape": [b], "dtype": "int32"})
    noise = []
    if decode == "sample":
        inputs.insert(0, {"name": "seed", "shape": [], "dtype": "int64"})
        r, t = num_samples, grid.max_length
        noise = [{"name": "gumbel", "shape": [r, b, t, grid.num_actions],
                  "dtype": "float32"},
                 {"name": "normal", "shape": [r, b, t],
                  "dtype": "float32"}]
    return inputs, noise


def _example(spec: dict, n: int, device) -> torch.Tensor:
    shape = [n if d == "b" else d for d in spec["shape"]]
    return torch.zeros(shape, dtype=getattr(torch, spec["dtype"]),
                       device=device)


def export_bundle(out_dir: str, model, grid: GridSpec, *,
                  decode: str = "greedy", num_samples: int = 1,
                  stream: str = "good", batch: Any = 1,
                  platforms: Sequence[str] | None = None,
                  map_h: int = 30, map_w: int = 40) -> dict:
    """Export the serving path of ``model`` and write the bundle.
    Returns the manifest dict (with the program's ``bytes``).  ``batch``
    is an int or "sym"; ``platforms`` are the torch devices the bundle
    is for (``cuda``, ``cpu``; default: the model's device, then the
    other), the program is exported on the first, which must be the
    model's.  A symbolic batch is traced at batch 2, so that it is not
    specialised to 1."""
    device = next(model.parameters()).device
    platforms = list(platforms or [device.type] + [
        d for d in DEVICES if d != device.type])
    unknown = sorted(set(platforms) - set(DEVICES))
    if unknown:
        raise ValueError(f"platforms {unknown}: the port serves on "
                         f"{', '.join(DEVICES)}")
    if platforms[0] != device.type:
        raise ValueError(f"the program is exported on {platforms[0]!r} "
                         f"(the first platform), the model is on {device}")
    serve = ServeModule(model, grid, decode, stream).eval()
    inputs, noise = _signature(model.task, decode, batch, grid, map_h,
                               map_w, num_samples)
    specs = noise + [i for i in inputs if i["name"] != "seed"]
    n = 2 if batch == "sym" else int(batch)
    args = tuple(_example(s, n, device) for s in specs)
    dynamic = None
    if batch == "sym":
        b = torch.export.Dim("b", min=1)
        # one entry for forward's *inputs
        dynamic = (tuple({s["shape"].index("b"): b} for s in specs),)
    with torch.no_grad(), _SkipNoopCasts():
        program = torch.export.export(serve, args, dynamic_shapes=dynamic)
    _drop_metadata_asserts(program)
    if device.type != "cpu":
        program = move_to_device_pass(program, "cpu")

    manifest = {
        "format": "scanpaths_tpu_torch.serve/1",
        "task": model.task,
        "decode": decode,
        "num_samples": num_samples if decode == "sample" else 1,
        "stream": stream if model.task == "air" else None,
        "batch": "sym" if batch == "sym" else int(batch),
        "platforms": platforms,
        # the compute dtype inside the program: the serving process
        # cannot change it
        "model_dtype": str(model.dtype).removeprefix("torch."),
        "geometry": {"height": grid.height, "width": grid.width,
                     "map_height": map_h, "map_width": map_w,
                     "max_length": grid.max_length,
                     "min_length": grid.min_length},
        "inputs": inputs,
        "noise": noise,
        "outputs": ["fix", "fix_len", "action_probs"],
        "torch_version": torch.__version__,
    }
    if model.task == "coco":
        manifest["num_task_ids"] = int(serve.bank_b_sa.shape[0])
    os.makedirs(out_dir, exist_ok=True)
    tmp = join(out_dir, "serve.tmp.pt2")
    torch.export.save(program, tmp)
    os.replace(tmp, join(out_dir, _PROGRAM))
    with open(join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    manifest["bytes"] = os.path.getsize(join(out_dir, _PROGRAM))
    return manifest


def serving_fn(module, manifest: dict, device):
    """The callable of the JAX bundle's signature (module docstring)
    over ``module``, a loaded program's module or a live
    :class:`ServeModule` of the same manifest: inputs (numpy arrays or
    tensors) go to ``device``; a sampled bundle's noise is drawn there
    from a generator seeded with ``seed``.  ``fn.module`` is ``module``."""
    device = torch.device(device)
    names = [i["name"] for i in manifest["inputs"]]
    geo = manifest["geometry"]
    n_ids = manifest.get("num_task_ids")

    def fn(*inputs):
        if len(inputs) != len(names):
            raise TypeError(f"the bundle takes ({', '.join(names)}), got "
                            f"{len(inputs)} inputs")
        feed = dict(zip(names, inputs))
        seed = feed.pop("seed", None)
        feed = {k: torch.as_tensor(v) for k, v in feed.items()}
        ids = feed.get("tasks")
        if ids is not None and bool(((ids < 0) | (ids >= n_ids)).any()):
            raise ValueError(f"task ids outside the bank of {n_ids} heads")
        args = [v.to(device) for v in feed.values()]
        if seed is not None:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(seed))
            b, t = args[0].shape[0], geo["max_length"]
            a = geo["map_height"] * geo["map_width"] + 1
            args = list(sample_noise(
                torch.empty((b, t, a), device=device),
                torch.empty((b, t), device=device), gen,
                manifest["num_samples"])) + args
        with torch.no_grad():
            return module(*args)

    fn.module = module
    return fn


def load_bundle(bundle_dir: str, device=None):
    """Load an exported bundle onto ``device`` (default: the first of
    the manifest's platforms).  Returns ``(fn, manifest)``: ``fn`` is
    :func:`serving_fn` over the loaded program, called with the
    positional signature of ``manifest["inputs"]``; no model code or
    checkpoint is needed."""
    with open(join(bundle_dir, _MANIFEST)) as f:
        manifest = json.load(f)
    device = torch.device(device or manifest["platforms"][0])
    if device.type not in manifest["platforms"]:
        raise ValueError(f"the bundle was exported for "
                         f"{manifest['platforms']}, not {device.type}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a cuda bundle but no CUDA device is available; "
                           "load it with device='cpu'")
    program = torch.export.load(join(bundle_dir, _PROGRAM))
    if device.type != "cpu":
        program = move_to_device_pass(program, device)
    return serving_fn(program.module(), manifest, device), manifest
