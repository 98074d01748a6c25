"""The data x model mesh over ranks: one process per rank under
``torchrun`` (port of ``scanpaths_tpu/train/mesh.py`` and of the
collectives of ``scanpaths_tpu/train/tp_step.py``).

The JAX package runs its mesh in one process: the batch is sharded over
the ``data`` axis, the two decode kernels over the ``model`` axis, and
XLA (or the hand-written ``shard_map`` step) inserts the collectives.
The port runs one process per rank, as PyTorch does, and makes the
collectives explicit.  Rank ``r`` of a ``D x T`` mesh (``T`` =
``--model_parallel``) sits at data index ``r // T`` and model index
``r % T``, as the JAX ``make_mesh`` lays out ``(data, model)``; the
ranks of one model index form a *data group*, the ranks of one data
index a *model group*.  The JAX functions and their counterparts:

* ``make_mesh(n_devices, model_parallel)`` -> :func:`make_mesh`
  ``(args, device)``: reads torchrun's ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, initialises the process group,
  builds the data and model groups and returns a :class:`Mesh`.
  ``--mesh_size`` is 0 (the ranks torchrun launched) or exactly
  ``WORLD_SIZE``; ``--mesh_size N > 1`` outside torchrun raises, and so
  does a ``--model_parallel`` that does not divide the world;
* ``shard_batch`` -> the ``Loader``'s per-rank slice
  (``data/datasets.py``, ``Loader(process_index, process_count)``, given
  the data index and size: the ranks of a model group load the same
  rows);
* ``state_sharding`` / ``tp_state_sharding`` -> ``train/tp_step.py``
  (the two decode kernels sliced over the model group, the rest
  replicated);
* the reductions over ``data`` -> :func:`global_sum` and
  :func:`global_mean` (loss and metric denominators),
  :func:`all_reduce_with_grad` (BN's global batch statistics,
  ``models/resnet.py::batch_norm``), :func:`reduce_gradients` (one flat
  bucket a dtype, summed: every loss is a local numerator over a global
  denominator, so the rank gradients add up to the global one), and
  :func:`slice_rows` (a data rank's rows of a draw made for the global
  batch, so the SCST and evaluation noise equal one process's);
* the f/g pair ``components.tp_enter`` / ``tp_exit`` -> :func:`tp_enter`
  (identity forward, all-reduce backward over the model group) and
  :func:`tp_exit` (all-reduce forward, identity backward), and
  :func:`gather_full`, a sliced tensor in its full shape (checkpoints,
  the eval forward);
* evaluation over ranks (the JAX ``Evaluator`` shards each eval batch
  over its mesh) -> :func:`counts_rows`, :func:`gather_to_primary` and
  :func:`broadcast_object`: each rank scores its rows, rank 0 gathers
  them in one process's order and aggregates, every rank takes its
  result.

The gradient all-reduce is explicit, not a ``DistributedDataParallel``
wrapper: the joint model leaves two heads idle on every step, whose
zero-filled gradients must still be reduced and stepped as optax does,
and a wrapper would rename every state-dict key, which is the checkpoint
layout.

No other module of the port calls ``torch.distributed``.  A helper whose
group holds one rank is the identity and calls no collective, so one
process, with a process group or without, runs the code path of a
single-card run.  The helpers use only ``all_reduce``, ``broadcast``,
``barrier`` and ``new_group``, which gloo takes on CUDA tensors (ranks
that share one card).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle

import torch
import torch.distributed as dist

# how long a rank waits in a collective: rank 0 aggregates the gathered
# rows of an evaluation and writes the checkpoints while the others wait
TIMEOUT = datetime.timedelta(hours=2)
LAUNCH = ("--mesh_size {n}: the port runs one process per rank; launch "
          "it under torchrun: torchrun --nproc_per_node {n} -m "
          "scanpaths_tpu_torch.cli.{cli} ... --mesh_size 0 (--batch is "
          "the global batch)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the run: its ``rank`` of ``world``, its
    ``device``, the process group's ``backend`` (None: one process, no
    group), whether :func:`make_mesh` initialised the group
    (:func:`close_mesh` then destroys it) and the mesh's model-parallel
    factor ``model`` (``--model_parallel``)."""
    rank: int
    world: int
    device: torch.device
    backend: str | None = None
    owner: bool = False
    note: str = ""
    model: int = 1

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def describe(self) -> str:
        if self.backend is None:
            return f"one process on {self.device}"
        return (f"mesh {self.world // self.model} (data) x {self.model} "
                f"(model): rank {self.rank} of {self.world} on "
                f"{self.device}, backend {self.backend}"
                + (f" ({self.note})" if self.note else ""))


@dataclasses.dataclass(frozen=True)
class _Layout:
    """The data and model groups of this rank (None: the world, or a
    group of one rank that no collective uses) under ``world``, the
    default group they were built in."""
    world: object
    data_group: object
    model_group: object
    data_size: int
    model_size: int
    data_index: int
    model_index: int


_layout: _Layout | None = None


def active() -> bool:
    """Whether a process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def _current() -> _Layout:
    """This rank's layout: the groups :func:`set_model_parallel` built in
    the current process group; else every rank of the group a data rank
    (the model group of one rank)."""
    if _layout is not None and active() and _layout.world is dist.group.WORLD:
        return _layout
    return _Layout(None, None, None, world_size(), 1, rank(), 0)


def data_size() -> int:
    return _current().data_size


def data_index() -> int:
    return _current().data_index


def model_size() -> int:
    return _current().model_size


def model_index() -> int:
    return _current().model_index


def distributed() -> bool:
    """Whether the data helpers reduce over more than one rank."""
    return data_size() > 1


def current(device) -> Mesh:
    """The :class:`Mesh` of this process on ``device``."""
    if not active():
        return Mesh(0, 1, torch.device(device))
    return Mesh(rank(), world_size(), torch.device(device),
                dist.get_backend(), model=model_size())


def launched_world() -> int | None:
    """The world torchrun launched (its ``WORLD_SIZE``), else None."""
    w = os.environ.get("WORLD_SIZE")
    return int(w) if w else None


def check_mesh_size(mesh_size: int, cli: str = "train") -> int:
    """The number of ranks of this run, ``--mesh_size`` checked against
    the launch: outside torchrun (and with no process group) 0 or 1;
    under it 0 or exactly its world size.  ``cli`` names the entry point
    in the message."""
    world = world_size() if active() else launched_world()
    if world is None:
        if mesh_size > 1:
            raise ValueError(LAUNCH.format(n=mesh_size, cli=cli))
        return 1
    if mesh_size not in (0, world):
        raise ValueError(
            f"--mesh_size {mesh_size} but torchrun launched {world} ranks "
            f"(WORLD_SIZE); pass --mesh_size 0 or {world}")
    return world


def check_model_parallel(model_parallel: int, world: int,
                         cli: str = "train") -> int:
    """``--model_parallel`` checked against the ``world`` of the run: it
    must divide it."""
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(
            f"--model_parallel {model_parallel} does not divide the {world} "
            f"rank(s) of this launch; launch it under torchrun: torchrun "
            f"--nproc_per_node {max(model_parallel, 1)} -m "
            f"scanpaths_tpu_torch.cli.{cli} ... --mesh_size 0 "
            f"--model_parallel {model_parallel} (or any multiple of "
            f"{model_parallel} ranks)")
    return model_parallel


def set_model_parallel(t: int) -> None:
    """Builds the data and model groups of a ``(world / t) x t`` mesh in
    the current process group (every rank calls it, with the same ``t``;
    nothing to build at ``t`` = 1: the world is the data group)."""
    global _layout
    world = world_size()
    check_model_parallel(t, world)
    if t == 1:
        _layout = None
        return
    me = rank()
    # every rank creates every group, in one order (new_group's contract)
    data = [dist.new_group([i * t + j for i in range(world // t)])
            for j in range(t)]
    model = [dist.new_group(list(range(i * t, (i + 1) * t)))
             for i in range(world // t)]
    _layout = _Layout(dist.group.WORLD, data[me % t], model[me // t],
                      world // t, t, me // t, me % t)


def make_mesh(args, device, cli: str = "train") -> Mesh:
    """The mesh of a run of ``cli`` on ``device`` (its type: ``cuda`` or
    ``cpu``), ``args.mesh_size`` and ``args.model_parallel`` checked
    against the launch.  Outside torchrun: one process on ``device``.
    Under it: the process group, initialised from torchrun's environment
    (unless the caller has initialised one), each rank on
    ``cuda:LOCAL_RANK``, or on a card shared by ``LOCAL_WORLD_SIZE /
    device_count`` ranks, and its data and model groups.  The backend is
    NCCL when each rank has its own card, gloo when ranks share one (NCCL
    refuses two ranks on one device) or on the CPU.  Nothing falls back:
    a failed initialisation raises."""
    world = check_mesh_size(args.mesh_size, cli)
    tp = check_model_parallel(getattr(args, "model_parallel", 1), world, cli)
    device = torch.device(device)
    if active():
        set_model_parallel(tp)
        return current(device)
    if launched_world() is None:
        return Mesh(0, 1, device)
    rank_ = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank_))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    note = ""
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("--device cuda but no CUDA device is "
                               "available")
        device = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(device)
        shared = local_world > cards
        backend = "gloo" if shared else "nccl"
        if shared:
            note = (f"{local_world} ranks share {cards} card(s): NCCL "
                    "refuses two ranks on one device")
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank_,
                            world_size=world, timeout=TIMEOUT)
    if active():
        set_model_parallel(tp)
    return Mesh(rank_, world, device, backend, owner=True, note=note,
                model=tp)


def close_mesh(mesh: Mesh) -> None:
    """Destroys the process group if :func:`make_mesh` initialised it."""
    global _layout
    if mesh.owner and active():
        _layout = None
        dist.destroy_process_group()


def _comm_device() -> torch.device:
    """Where a tensor for a collective lives: the current card for NCCL,
    the host for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# ---------------------------------------------------------------------------
# the data group (each the identity when it holds one rank)
# ---------------------------------------------------------------------------

def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data ranks, without gradient (denominators
    and metrics)."""
    if not distributed():
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=_current().data_group)
    return y


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the global batch, without gradient; every
    data rank holds the same number of rows."""
    if not distributed():
        return x.mean()
    return global_sum(x.detach().sum()) / (x.numel() * data_size())


def all_reduce_with_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data ranks, differentiably: the backward
    sums the incoming gradient over them, so it reaches every rank's
    inputs."""
    if not distributed():
        return x
    from torch.distributed.nn.functional import all_reduce
    group = _current().data_group
    return all_reduce(x, group=dist.group.WORLD if group is None else group)


def reduce_gradients(params) -> None:
    """Sums every parameter's gradient over the data ranks, one flat
    bucket a dtype (a sliced parameter's over the ranks that hold the same
    slice)."""
    if not distributed():
        return
    by_dtype: dict = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=_current().data_group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def slice_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This data rank's contiguous rows along ``dim`` of a tensor made for
    the global batch (the ``Loader``'s slice)."""
    if not distributed():
        return x
    n_ranks = data_size()
    if x.shape[dim] % n_ranks:
        raise ValueError(f"{x.shape[dim]} rows do not divide over "
                         f"{n_ranks} ranks")
    n = x.shape[dim] // n_ranks
    return x.narrow(dim, data_index() * n, n)


# ---------------------------------------------------------------------------
# the model group: the f/g pair of row-parallel tensor parallelism
# ---------------------------------------------------------------------------

def _model_all_reduce(x: torch.Tensor) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=_current().model_group)
    return y


class _Enter(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over the model
    group (each rank's channel slice gives part of it)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_all_reduce(g)


class _Exit(torch.autograd.Function):
    """The forward sums the row-parallel partial contractions over the
    model group; identity backward (the cotangent is replicated)."""

    @staticmethod
    def forward(ctx, x):
        return _model_all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g


def tp_enter(x: torch.Tensor) -> torch.Tensor:
    """A replicated tensor entering a row-parallel block
    (``components.tp_enter``)."""
    return _Enter.apply(x) if model_size() > 1 else x


def tp_exit(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel block's partial result, summed over the model group
    (``components.tp_exit``)."""
    return _Exit.apply(x) if model_size() > 1 else x


def gather_full(part: torch.Tensor, dim: int) -> torch.Tensor:
    """The full tensor of which each model rank holds the ``model_index``-th
    contiguous block along ``dim``: an all-reduce of zero-filled full
    tensors, without gradient."""
    if model_size() == 1:
        return part
    shape = list(part.shape)
    n = shape[dim]
    shape[dim] = n * model_size()
    full = part.new_zeros(shape)
    full.narrow(dim, model_index() * n, n).copy_(part.detach())
    dist.all_reduce(full, group=_current().model_group)
    return full


# ---------------------------------------------------------------------------
# the world: rank 0 gathers and aggregates, every rank takes its result
# ---------------------------------------------------------------------------

def counts_rows(sliced: bool) -> bool:
    """Whether this rank's rows of a batch count in a gathered result:
    ranks of one model group hold the same rows and model index 0 alone
    gives them; a batch that every rank holds whole (not ``sliced``: the
    ``Loader``'s partial last batch) counts on data index 0 alone."""
    return model_index() == 0 and (sliced or data_index() == 0)


def row_offset(sliced: bool, n: int) -> int:
    """The global index of this rank's first row in a batch of ``n`` rows
    a rank."""
    return data_index() * n if sliced else 0


def _broadcast_bytes(data: bytes | None, src: int) -> bytes:
    dev = _comm_device()
    size = torch.tensor([len(data) if rank() == src else 0],
                        dtype=torch.int64, device=dev)
    dist.broadcast(size, src)
    buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
           if rank() == src else
           torch.empty(int(size), dtype=torch.uint8, device=dev))
    dist.broadcast(buf, src)
    return buf.cpu().numpy().tobytes()


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` (picklable) on every rank."""
    if world_size() == 1:
        return obj
    data = pickle.dumps(obj) if rank() == src else None
    return pickle.loads(_broadcast_bytes(data, src))


def broadcast_str(text: str, src: int = 0) -> str:
    """Rank ``src``'s ``text``."""
    return broadcast_object(text, src)


def gather_to_primary(items: list) -> list | None:
    """Every rank's ``(key, value)`` items on rank 0, sorted by key (so
    a key that orders the rows as one process visits them gives one
    process's order); None on the other ranks.  Each rank broadcasts its
    items in turn."""
    if world_size() == 1:
        return sorted(items, key=lambda kv: kv[0])
    mine = pickle.dumps(items)
    out = []
    for src in range(world_size()):
        got = _broadcast_bytes(mine if src == rank() else None, src)
        if rank() == 0:
            out.extend(pickle.loads(got))
    return sorted(out, key=lambda kv: kv[0]) if rank() == 0 else None


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()
