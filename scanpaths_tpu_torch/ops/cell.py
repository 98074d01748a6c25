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
return the new hidden state in a separate tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

# launches of the CUDA kernel in this process (read by chip_smoke.py)
cell_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(h, c, xg, smaps, kps, kh):
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
    if h.dtype not in _DTYPES:
        raise ValueError(f"dtype {h.dtype} not supported (float32, bfloat16)")


def cell_step_plain(h, c, xg, smaps, kps, kh):
    """Plain PyTorch version of :func:`cell_step` (same arguments)."""
    _check(h, c, xg, smaps, kps, kh)
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
    raises.
    """
    global cell_launches
    if h.device.type == "cpu":
        return cell_step_plain(h, c, xg, smaps, kps, kh)
    _check(h, c, xg, smaps, kps, kh)
    if h.device.type != "cuda":
        raise ValueError(f"no cell kernel for device {h.device}")
    n, hh, ww, ch = h.shape
    if ch % 32:
        raise ValueError(f"the cell kernel needs C % 32 == 0, got C={ch}")
    ts = (h, c, xg, smaps, kps, kh)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError("the cell kernel needs contiguous, 16-byte "
                         "aligned tensors")
    h_out = torch.empty_like(h)
    fn = _build.kernel("sp_cell_step", 7, 6)
    with torch.cuda.device(h.device):
        err = fn(*(t.data_ptr() for t in ts), h_out.data_ptr(),
                 n, hh, ww, ch, smaps.shape[-1], _DTYPES[h.dtype],
                 torch.cuda.current_stream(h.device).cuda_stream)
    _build.check("sp_cell_step", err)
    cell_launches += 1
    return h_out, c
