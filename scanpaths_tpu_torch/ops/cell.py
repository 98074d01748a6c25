"""One fused ConvLSTM decode step (port of
``scanpaths_tpu/ops/pallas_cell.py::cell_step``).

The step computes the 3x3 C->4C gate conv of the hidden state, adds the
factorized task-signal taps into the i/f/o pre-activations
(``components.SignalGates``), adds the hoisted x-gate pre-activations
(with every constant bias folded in), and runs the state update in
float32:

    i, f, o = sigmoid(.), g = tanh(.), c' = f*c + i*g, h' = o*c'

(no tanh on c' — the reference's quirk, kept).  Tensors are dense NHWC;
the TPU kernel's flat padded-row layout is not carried over.

:func:`cell_step` runs the hand-written CUDA kernel (``csrc/cell.cu``)
on CUDA tensors and :func:`cell_step_plain`, the same computation in
plain PyTorch ops, on CPU tensors.  Both update ``c`` in place and
return the new hidden state in a separate tensor.  Both run as the
registered op ``scanpaths_tpu_torch::cell_step`` (:func:`cell_step_op`),
which importing this module registers.  The kernel reads the
gate kernel packed K-contiguous (:func:`pack_gate_kernel`); the wrapper
packs each ``kh`` tensor once a version (``_build.packed``), so the eval
forward, whose ``kh`` is prepared once a weight version
(``models/prepared.py``), packs it once a weight version.

The float32 kernel is persistent: one wave of CTAs walks a static list
of work (:func:`cell_schedule`, :func:`cell_work`), cutting the tiles
of a ragged last round along K; the pieces meet in a workspace that the
wrapper keeps per device, stream and schedule (:func:`_workspace`).  Each
launch adds the tiles it cuts to the counter ``cell_step.split_tiles``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the plain version also runs in float64, as a reference for the others
_PLAIN_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def _check(h, c, xg, smaps, kps, kh, dtypes=tuple(_DTYPES)):
    if h.dim() != 4:
        raise ValueError(f"h must be [N, H, W, C], got {tuple(h.shape)}")
    n, hh, ww, ch = h.shape
    s = smaps.shape[-1] if smaps.dim() == 4 else -1
    want = {"c": (c, (n, hh, ww, ch)), "xg": (xg, (n, hh, ww, 4 * ch)),
            "smaps": (smaps, (n, hh, ww, s)), "kps": (kps, (n, s, 9, 3 * ch)),
            "kh": (kh, (3, 3, ch, 4 * ch))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if s not in (1, 2):
        raise ValueError(f"1 or 2 signal streams supported, got {s}")
    for name, t in (("c", c), ("xg", xg), ("smaps", smaps), ("kps", kps),
                    ("kh", kh)):
        if t.dtype != h.dtype:
            raise ValueError(f"{name} is {t.dtype}, h is {h.dtype}")
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h is on {h.device}")
    if h.dtype not in dtypes:
        raise ValueError(f"dtype {h.dtype} not supported "
                         f"({', '.join(str(d)[6:] for d in dtypes)})")


def pack_gate_kernel(kh):
    """The HWIO gate kernel [3, 3, C, 4C] as the kernel reads it:
    [4C, 9C], row g*C + c holding output column g*C + c over the taps
    and input channels, tap-major (K contiguous)."""
    return kh.reshape(-1, kh.shape[-1]).t().contiguous()


def unpack_gate_kernel(kt):
    """The inverse of :func:`pack_gate_kernel`: [4C, 9C] -> [3, 3, C, 4C]."""
    return kt.t().reshape(3, 3, kt.shape[0] // 4, kt.shape[0]).contiguous()


def cell_step_plain(h, c, xg, smaps, kps, kh):
    """Plain PyTorch version of :func:`cell_step` (same arguments; also
    in float64)."""
    _check(h, c, xg, smaps, kps, kh, _PLAIN_DTYPES)
    n, hh, ww, ch = h.shape
    acc = F.conv2d(h.permute(0, 3, 1, 2), kh.permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1).float()
    spad = F.pad(smaps, (0, 0, 1, 1, 1, 1)).float()
    taps = torch.stack([spad[:, dy:dy + hh, dx:dx + ww]
                        for dy in range(3) for dx in range(3)], dim=-1)
    sig = torch.einsum("nyxst,nsto->nyxo", taps, kps.float())
    acc = acc + F.pad(sig, (0, ch))
    pre = acc + xg.float()
    i, f, o, g = pre.split(ch, dim=-1)
    cn = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    hn = torch.sigmoid(o) * cn
    c.copy_(cn)
    return hn.to(h.dtype), c


@torch.library.custom_op("scanpaths_tpu_torch::cell_step",
                         mutates_args=("c",), device_types="cpu")
def cell_step_op(h: torch.Tensor, c: torch.Tensor, xg: torch.Tensor,
                 smaps: torch.Tensor, kps: torch.Tensor,
                 kh: torch.Tensor) -> torch.Tensor:
    """The registered op behind :func:`cell_step`: returns h' and updates
    ``c`` in place.  Its CPU kernel is :func:`cell_step_plain`, its CUDA
    kernel ``csrc/cell.cu``; no other device has one.  Being an op, it
    is traced by ``torch.export`` as one node, so an exported program
    launches the CUDA kernel (``serve/export.py``)."""
    return cell_step_plain(h, c, xg, smaps, kps, kh)[0]


# the float32 kernel's tile: 128 pixels x 64 channels (32 when C % 64 != 0)
# x 4 gates, its K (9 taps x C) in chunks of 32
TILE_PIXELS, CHUNK = 128, 32


class Schedule(NamedTuple):
    """The float32 kernel's persistent schedule at one shape: ``ctas``
    CTAs over ``tiles`` tiles of ``chunks`` K chunks each; ``rounds``
    rounds of whole tiles, after the first ``cut`` tiles, whose
    (tile, chunk) units are dealt in ``ctas`` equal ranges; ``split_tiles``
    of those are cut inside; ``most`` is the largest CTA's units, of
    ``units`` in all."""
    ctas: int
    tiles: int
    split_tiles: int
    most: int
    units: int
    width: int
    chunks: int
    rounds: int
    cut: int

    def bound(self, r: int) -> int:
        """The first unit of range ``r`` (0 .. ctas)."""
        return self.cut * self.chunks * r // self.ctas

    @property
    def max_over_mean(self) -> float:
        return self.most * self.ctas / self.units


@functools.lru_cache(maxsize=64)
def cell_schedule(n: int, hh: int, ww: int, ch: int, slots: int) -> Schedule:
    """The schedule of the float32 kernel at [n, hh, ww, ch] on a card
    that holds ``slots`` CTAs at once (SMs x CTAs an SM), as
    ``csrc/cell.cu`` (``Sched``) computes it: ``min(slots, units)`` CTAs;
    when the tiles do not fill whole rounds, the ragged round and the
    one before it are cut along K, so every range spans at least a tile
    and every CTA ends with the same work to within one chunk."""
    width = 64 if ch % 64 == 0 else 32
    tiles = -(-(n * hh * ww) // TILE_PIXELS) * (ch // width)
    chunks = 9 * ch // CHUNK
    ctas = min(slots, tiles * chunks)
    rounds = tiles // ctas
    if tiles % ctas and rounds:
        rounds -= 1
    cut = tiles - rounds * ctas
    units = cut * chunks
    bounds = [units * r // ctas for r in range(ctas + 1)]
    split = len({b // chunks for b in bounds[1:-1] if b % chunks})
    most = rounds * chunks + max(b - a for a, b in zip(bounds, bounds[1:]))
    return Schedule(ctas, tiles, split, most, tiles * chunks, width, chunks,
                    rounds, cut)


def cell_work(sched: Schedule) -> list[list[tuple[int, int, int]]]:
    """Each CTA's items in the order it walks them, (tile, first chunk,
    end chunk): CTA b takes range ctas - 1 - b of the cut units, then the
    whole tiles cut + b + ctas i."""
    out = []
    for b in range(sched.ctas):
        r = sched.ctas - 1 - b
        items, u, hi = [], sched.bound(r), sched.bound(r + 1)
        while u < hi:
            t, k0 = divmod(u, sched.chunks)
            k1 = min(sched.chunks, k0 + hi - u)
            items.append((t, k0, k1))
            u += k1 - k0
        items += [(sched.cut + b + sched.ctas * i, 0, sched.chunks)
                  for i in range(sched.rounds)]
        out.append(items)
    return out


@functools.lru_cache(maxsize=None)
def _slots(device: int, width: int) -> int:
    """CTAs of the float32 kernel the card holds at once."""
    with torch.cuda.device(device):
        rep = cell_grid(1, 1, 1, width, torch.float32)
    return rep["sms"] * rep["per_sm"]


_WORKSPACES: dict = {}


def _workspace(device: torch.device, stream: int, sched: Schedule):
    """(partial sums, flags) for the cut pieces of a launch, kept per
    device, stream and schedule: a slot of 256 x 2 x width floats a CTA
    (each thread's 16 x 4 x width / 32 sums), and a flag a CTA, zeroed
    here once and left zero by every launch."""
    key = (device, stream, sched.ctas, sched.width)
    hit = _WORKSPACES.get(key)
    if hit is None:
        hit = _WORKSPACES[key] = (
            torch.empty(sched.ctas * 256 * 2 * sched.width,
                        dtype=torch.float32, device=device),
            torch.zeros(sched.ctas, dtype=torch.int32, device=device))
    return hit


@cell_step_op.register_kernel("cuda")
def _cell_step_cuda(h, c, xg, smaps, kps, kh):
    n, hh, ww, ch = h.shape
    if ch % 32:
        raise ValueError(f"the cell kernel needs C % 32 == 0, got C={ch}")
    ts = (h, c, xg, smaps, kps, _build.packed(kh, pack_gate_kernel))
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError("the cell kernel needs contiguous, 16-byte "
                         "aligned tensors")
    h_out = torch.empty_like(h)
    fn = _build.kernel("sp_cell_step", 9, 7)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        ws = flags = ctas = 0
        if h.dtype == torch.float32:
            sched = cell_schedule(n, hh, ww, ch, _slots(
                h.device.index, 64 if ch % 64 == 0 else 32))
            ctas = sched.ctas
            if sched.split_tiles:
                ws, flags = (t.data_ptr() for t in
                             _workspace(h.device, stream, sched))
            tracing.count("cell_step.split_tiles", sched.split_tiles)
        err = fn(*(t.data_ptr() for t in ts), h_out.data_ptr(), ws, flags,
                 n, hh, ww, ch, smaps.shape[-1], _DTYPES[h.dtype], ctas,
                 stream)
    _build.check("sp_cell_step", err)
    tracing.count("cell_step.launches")
    return h_out


@cell_step_op.register_fake
def _cell_step_fake(h, c, xg, smaps, kps, kh):
    return torch.empty_like(h)


def cell_step(h, c, xg, smaps, kps, kh):
    """One ConvLSTM step; returns ``(h', c)`` with ``c`` updated in place.

    h, c:   [N, H, W, C]     hidden and cell state
    xg:     [N, H, W, 4C]    x-gate pre-activations, gate order i, f, o, g,
                             with the h-gate and signal biases folded in
    smaps:  [N, H, W, S]     spatial signal maps, one channel per stream
    kps:    [N, S, 9, 3C]    per-sample contracted signal kernels
                             (``SignalGates.kp``), taps row-major
    kh:     [3, 3, C, 4C]    h-gate conv kernel, HWIO

    All in one dtype (float32 or bfloat16) on one device.  A CPU tensor
    runs :func:`cell_step_plain`; a CUDA tensor runs ``csrc/cell.cu``
    (C % 32 == 0, S in {1, 2}, contiguous and 16-byte aligned) or
    raises; both through :func:`cell_step_op`.  Either raises under grad
    mode when an input requires grad (no backward;
    ``components.FusedConvLSTMCell.step`` is the differentiable step).
    """
    _build.refuse_grad("cell_step", h, c, xg, smaps, kps, kh)
    _check(h, c, xg, smaps, kps, kh)
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no cell kernel for device {h.device}")
    return cell_step_op(h, c, xg, smaps, kps, kh), c


def cell_grid(n: int, hh: int, ww: int, ch: int, dtype) -> dict:
    """What the CUDA kernel's launch at this shape looks like (needs the
    card): for float32 its persistent schedule, {"ctas", "tiles",
    "split_tiles", "most", "units", "per_sm", "sms"} (``most`` the
    largest CTA's (tile, chunk) units, of ``units``; it agrees with
    :func:`cell_schedule`); for bfloat16 {"grid": [x, y], "per_sm"}."""
    if dtype == torch.float32:
        keys = ("ctas", "tiles", "split_tiles", "most", "units", "per_sm",
                "sms")
        return dict(zip(keys, _build.grid_report("sp_cell_grid", 7, n, hh,
                                                 ww, ch, _DTYPES[dtype])))
    gx, gy, per_sm = _build.grid_report("sp_cell_grid", 3, n, hh, ww, ch,
                                        _DTYPES[dtype])
    return {"grid": [gx, gy], "per_sm": per_sm}
