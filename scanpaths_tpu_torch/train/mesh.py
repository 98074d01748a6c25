"""Data parallel over ranks: one process per rank under ``torchrun``
(port of the data axis of ``scanpaths_tpu/train/mesh.py``).

The JAX package runs its mesh in one process: the batch is sharded over
the ``data`` axis and XLA inserts the collectives.  The port runs one
process per rank, as PyTorch does, each holding the whole model and
``batch / world`` rows of every global batch, and makes the collectives
explicit.  The JAX functions and their counterparts:

* ``make_mesh(n_devices, model_parallel)`` -> :func:`make_mesh`
  ``(args, device)``: reads torchrun's ``RANK``, ``WORLD_SIZE``,
  ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, initialises the process group
  and returns a :class:`Mesh`.  ``--mesh_size`` is 0 (the ranks torchrun
  launched) or exactly ``WORLD_SIZE``; ``--mesh_size N > 1`` outside
  torchrun raises.  Row-parallel TP (``--model_parallel``) is not ported;
  the trainer refuses it;
* ``shard_batch`` -> the ``Loader``'s per-rank slice
  (``data/datasets.py``, ``Loader(process_index, process_count)``);
* ``batch_sharding``, ``replicated``, ``state_sharding``, ``gather_spec``
  -> no counterpart: every rank holds the whole state;
* the reductions XLA inserts -> :func:`global_sum` and
  :func:`global_mean` (loss and metric denominators),
  :func:`all_reduce_with_grad` (BN's global batch statistics,
  ``models/resnet.py::batch_norm``), :func:`reduce_gradients` (one flat
  bucket a dtype, summed: every loss is a local numerator over a global
  denominator, so the rank gradients add up to the global one), and
  :func:`slice_rows` (a rank's rows of a draw made for the global batch,
  so the SCST noise equals one process's).

The gradient all-reduce is explicit, not a ``DistributedDataParallel``
wrapper: the joint model leaves two heads idle on every step, whose
zero-filled gradients must still be reduced and stepped as optax does,
and a wrapper would rename every state-dict key, which is the checkpoint
layout.

No other module of the port calls ``torch.distributed``.  With no
process group every helper is the identity, so one process runs the
code path of a single-card run.  The helpers use only ``all_reduce``,
``broadcast`` and ``barrier``, the collectives gloo takes on CUDA
tensors.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

# how long a rank waits in a collective: the other ranks wait for rank 0's
# human baseline and validations, which take minutes on a full split
TIMEOUT = datetime.timedelta(hours=2)
LAUNCH = ("--mesh_size {n}: the port trains one process per rank; launch "
          "it under torchrun: torchrun --nproc_per_node {n} -m "
          "scanpaths_tpu_torch.cli.train ... --mesh_size 0 (--batch is "
          "the global batch)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the run: its ``rank`` of ``world``, its
    ``device``, the process group's ``backend`` (None: one process, no
    group) and whether :func:`make_mesh` initialised the group
    (:func:`close_mesh` then destroys it)."""
    rank: int
    world: int
    device: torch.device
    backend: str | None = None
    owner: bool = False
    note: str = ""

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def describe(self) -> str:
        if self.backend is None:
            return f"one process on {self.device}"
        return (f"data parallel: rank {self.rank} of {self.world} on "
                f"{self.device}, backend {self.backend}"
                + (f" ({self.note})" if self.note else ""))


def active() -> bool:
    """Whether a process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def current(device) -> Mesh:
    """The :class:`Mesh` of this process on ``device``."""
    if not active():
        return Mesh(0, 1, torch.device(device))
    return Mesh(rank(), world_size(), torch.device(device),
                dist.get_backend())


def launched_world() -> int | None:
    """The world torchrun launched (its ``WORLD_SIZE``), else None."""
    w = os.environ.get("WORLD_SIZE")
    return int(w) if w else None


def check_mesh_size(mesh_size: int) -> int:
    """The number of ranks of this run, ``--mesh_size`` checked against
    the launch: outside torchrun (and with no process group) 0 or 1;
    under it 0 or exactly its world size."""
    world = world_size() if active() else launched_world()
    if world is None:
        if mesh_size > 1:
            raise ValueError(LAUNCH.format(n=mesh_size))
        return 1
    if mesh_size not in (0, world):
        raise ValueError(
            f"--mesh_size {mesh_size} but torchrun launched {world} ranks "
            f"(WORLD_SIZE); pass --mesh_size 0 or {world}")
    return world


def make_mesh(args, device) -> Mesh:
    """The mesh of a training run on ``device`` (its type: ``cuda`` or
    ``cpu``).  Outside torchrun: one process on ``device``.  Under it:
    the process group, initialised from torchrun's environment (unless
    the caller has initialised one), each rank on ``cuda:LOCAL_RANK``,
    or on a card shared by ``LOCAL_WORLD_SIZE / device_count`` ranks.
    The backend is NCCL when each rank has its own card, gloo when ranks
    share one (NCCL refuses two ranks on one device) or on the CPU.
    Nothing falls back: a failed initialisation raises."""
    world = check_mesh_size(args.mesh_size)
    device = torch.device(device)
    if active():
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
    return Mesh(rank_, world, device, backend, owner=True, note=note)


def close_mesh(mesh: Mesh) -> None:
    """Destroys the process group if :func:`make_mesh` initialised it."""
    if mesh.owner and active():
        dist.destroy_process_group()


def _comm_device() -> torch.device:
    """Where a tensor for a collective lives: the current card for NCCL,
    the host for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# ---------------------------------------------------------------------------
# collectives (each the identity with no process group)
# ---------------------------------------------------------------------------

def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, without gradient (denominators and
    metrics)."""
    if not active():
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the global batch, without gradient; every
    rank holds the same number of rows."""
    if not active():
        return x.mean()
    return global_sum(x.detach().sum()) / (x.numel() * world_size())


def all_reduce_with_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiably: the backward sums the
    incoming gradient over the ranks, so it reaches every rank's
    inputs."""
    if not active():
        return x
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x)


def reduce_gradients(params) -> None:
    """Sums every parameter's gradient over the ranks, one flat bucket a
    dtype."""
    if not active():
        return
    by_dtype: dict = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def slice_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's contiguous rows along ``dim`` of a tensor made for the
    global batch (the ``Loader``'s slice)."""
    if not active():
        return x
    world = world_size()
    if x.shape[dim] % world:
        raise ValueError(f"{x.shape[dim]} rows do not divide over {world} "
                         "ranks")
    n = x.shape[dim] // world
    return x.narrow(dim, rank() * n, n)


def broadcast_generator(generator: torch.Generator, src: int = 0) -> None:
    """Sets ``generator`` to rank ``src``'s state."""
    if not active():
        return
    state = generator.get_state().to(_comm_device())
    dist.broadcast(state, src)
    generator.set_state(state.cpu())


def broadcast_str(text: str, src: int = 0) -> str:
    """Rank ``src``'s ``text``."""
    if not active():
        return text
    dev = _comm_device()
    data = torch.tensor(list(text.encode()), dtype=torch.uint8, device=dev)
    size = torch.tensor([data.numel()], dtype=torch.int64, device=dev)
    dist.broadcast(size, src)
    if rank() != src:
        data = torch.empty(int(size), dtype=torch.uint8, device=dev)
    dist.broadcast(data, src)
    return bytes(data.cpu().tolist()).decode()


def barrier() -> None:
    if active():
        dist.barrier()
