"""Row-parallel tensor parallelism over the model group (port of
``scanpaths_tpu/train/tp_step.py``).

The layout is the JAX package's ``TP_SHARDED``: the two heavy decode
kernels, the h-gate conv (``lstm.gates_h``) and the hoisted x-gate conv
(``xgates.gates_x``), are sliced along their input channels over the
``--model_parallel`` ranks of a model group (``train/mesh.py``); every
other parameter, and the BN statistics, are replicated.  Adam's moments
follow their parameter: the optimizer is built over the sliced
parameters, so each rank holds the moments of its slice.  A kernel whose
input channels do not divide by the model size stays whole, as the JAX
``_tp_spec`` leaves it replicated.

The steps are ``train/steps.py``'s ``supervised_step`` and ``rl_step``
driven on a :class:`TPTrainState` (the JAX ``make_tp_supervised_step``
and ``make_tp_rl_step``): the training forward contracts each sliced
kernel row-parallel (``models/components.py::tp_row_conv``, the f/g pair
``mesh.tp_enter`` / ``mesh.tp_exit``), so the activations and the
replicated parameters' gradients are whole and equal on every model
rank, while a sliced kernel's gradient is its rank's disjoint slice.
Every gradient is then summed over the data group alone, BN reduces
over the data group alone (the model ranks share their rows), and the
SCST noise is drawn for the global batch and sliced by data index, so
the ranks of one model group draw the same rollouts (the JAX step folds
only ``axis_index("data")`` into its key).  The global-norm clip sums the
replicated gradients' squares once and the sliced ones' over the model
group (:func:`global_norm`), the norm the JAX update takes over the
logical arrays.

The eval forward is not sharded in compute: the cell kernel
(``ops/cell.py``) fuses the whole 3x3 contraction with its epilogue
(``c' = f c + i g``), which a partial contraction cannot feed, so an
evaluation gathers the two kernels whole once (:func:`gathered`) and
runs the kernels' path on every rank.  Checkpoints hold the full
reference layout (:func:`full_state_dict`, :func:`full_optimizer_state`,
gathered on every rank, written by rank 0); a resume under TP slices
the full arrays on load (:meth:`TPTrainState.create`), so TP runs and
single-card runs load each other's checkpoints.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn

from . import mesh, steps

# the JAX package's TP_SHARDED, under the port's parameter names
TP_SHARDED = ("lstm.gates_h.weight", "xgates.gates_x.weight")
# the sliced dim of an OIHW kernel: its input channels
DIM = 1


def is_sliced(p: torch.Tensor) -> bool:
    """Whether ``p`` is this rank's slice of a TP-sharded kernel."""
    return getattr(p, "tp_sliced", False)


def _owner(model: nn.Module, name: str):
    mod, attr = name.rsplit(".", 1)
    return model.get_submodule(mod), attr


def shard_model(model: nn.Module) -> list[str]:
    """Replaces each ``TP_SHARDED`` kernel of ``model`` (every head's, for
    the joint model) by this model rank's block of its input channels, a
    new parameter in the old one's place (before an optimizer is built
    over them).  Returns the names sliced."""
    t = mesh.model_size()
    names = []
    if t == 1:
        return names
    for name, p in list(model.named_parameters()):
        if not any(name == pat or name.endswith("." + pat)
                   for pat in TP_SHARDED) or p.shape[DIM] % t:
            continue
        n = p.shape[DIM] // t
        part = nn.Parameter(p.detach().narrow(
            DIM, mesh.model_index() * n, n).clone())
        part.tp_sliced = True
        mod, attr = _owner(model, name)
        setattr(mod, attr, part)
        names.append(name)
    return names


@contextlib.contextmanager
def gathered(model: nn.Module):
    """Within the block, each sliced kernel of ``model`` is whole (a
    gather over the model group); after it, the slices are back in
    place.  The identity when nothing is sliced."""
    swaps = []
    for name, p in list(model.named_parameters()):
        if is_sliced(p):
            mod, attr = _owner(model, name)
            swaps.append((mod, attr, p))
            setattr(mod, attr, nn.Parameter(mesh.gather_full(p, DIM),
                                            requires_grad=False))
    try:
        yield
    finally:
        for mod, attr, p in swaps:
            setattr(mod, attr, p)


def full_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` with each sliced kernel gathered whole; every
    rank of a model group calls it."""
    sd = model.state_dict()
    for name, p in model.named_parameters():
        if is_sliced(p):
            sd[name] = mesh.gather_full(p, DIM)
    return sd


def _params(optimizer) -> list:
    return [p for group in optimizer.param_groups for p in group["params"]]


def full_optimizer_state(optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()`` with the moments of each sliced
    parameter gathered whole (the reference layout's); every rank of a
    model group calls it."""
    sd = optimizer.state_dict()
    state = dict(sd["state"])
    for i, p in enumerate(_params(optimizer)):
        if is_sliced(p) and i in state:
            state[i] = {k: mesh.gather_full(v, DIM)
                        if torch.is_tensor(v) and v.shape == p.shape else v
                        for k, v in state[i].items()}
    return {**sd, "state": state}


def slice_optimizer_state(opt_state: dict, model: nn.Module) -> dict:
    """A saved Adam ``state_dict`` of the full layout with the moments of
    each sliced parameter of ``model`` sliced like it (a resume)."""
    state = dict(opt_state["state"])
    for i, p in enumerate(model.parameters()):
        if is_sliced(p) and i in state:
            n = p.shape[DIM]
            state[i] = {k: v.narrow(DIM, mesh.model_index() * n, n).clone()
                        if torch.is_tensor(v) and v.dim() == p.dim() else v
                        for k, v in state[i].items()}
    return {**opt_state, "state": state}


def global_norm(params) -> torch.Tensor:
    """The L2 norm of the logical gradient of ``params``: the replicated
    gradients' squares once, the sliced ones' summed over the model
    group."""
    def sq(grads):
        if not grads:
            return torch.zeros((), dtype=params[0].grad.dtype,
                               device=params[0].grad.device)
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads])) ** 2
    rep = sq([p.grad for p in params if not is_sliced(p)])
    part = sq([p.grad for p in params if is_sliced(p)])
    return torch.sqrt(rep + mesh.tp_exit(part))


@dataclasses.dataclass
class TPTrainState(steps.TrainState):
    """A :class:`steps.TrainState` over a model whose ``TP_SHARDED``
    kernels are sliced over the model group, clipped by the global norm
    of the logical gradient."""

    @classmethod
    def create(cls, model, args, steps_sup: int, steps_rl: int,
               step: int = 0, device="cuda",
               opt_state: dict | None = None) -> "TPTrainState":
        """``steps.TrainState.create`` after slicing ``model``
        (:func:`shard_model`, which ``model`` holds whole) and, on a
        resume, the saved moments of the full layout."""
        shard_model(model)
        if opt_state is not None:
            opt_state = slice_optimizer_state(opt_state, model)
        return super().create(model, args, steps_sup, steps_rl, step=step,
                              device=device, opt_state=opt_state)

    @torch.no_grad()
    def clip_gradients(self, params) -> torch.Tensor:
        norm = global_norm(params)
        if self.clip > 0:
            # clip_grad_norm_'s scale
            coef = torch.clamp(self.clip / (norm + 1e-6), max=1.0)
            for p in params:
                p.grad.mul_(coef)
        return norm


def train_state_class():
    """The state class of this run: :class:`TPTrainState` under a model
    group of more than one rank, else ``steps.TrainState``."""
    return TPTrainState if mesh.model_size() > 1 else steps.TrainState
