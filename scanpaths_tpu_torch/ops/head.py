"""The decoder's per-step composed conditioner+head.

The conditioner's 5x5 C->C conv composes exactly with the head's C->1
convs (``models/components.py::fuse_cond_head``), so each decode step
applies only thin convs to the ConvLSTM state ``h`` [N, H, W, C]: the
5x5 C->2 conv ``k_sa`` (the stop map and the action map), the 11x11
stride-5 C->1 conv ``keff`` (the duration map) and the border
corrections ``wr``, ``wc``, ``wcc`` of the latter.  It returns

    stop_logit [N, 1]     the stop map's mean, its bias included
    amap       [N, H, W]  relu of the action map
    d          [N, h5, w5] the raw drt_layer_1 output
                          (``PredictHead.finish_duration`` finishes it)

in float32 (float64 when ``h`` is).  The fields are one
``fuse_cond_head`` dict for the whole batch, or one per sample with a
leading [N] axis on every field (COCO's bank,
``models.prepared.gather_heads``).

:func:`cond_head` runs the hand-written CUDA kernel (``csrc/head.cu``) on
CUDA tensors and :func:`cond_head_plain`, the same computation in plain
PyTorch ops, on CPU tensors, both as the registered op
``scanpaths_tpu_torch::cond_head`` (:func:`cond_head_op`), so an
exported program launches the kernel.  The kernel has no backward: the
training forward calls :func:`cond_head_plain` itself
(``components.apply_fused_cond_head``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import _build

FIELDS = ("k_sa", "b_sa", "keff", "wr", "wc", "wcc", "b1map", "bd")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the plain version also runs in float64, as a reference for the kernel
_PLAIN_DTYPES = (torch.float32, torch.bfloat16, torch.float64)


def _windows(size: int) -> int:
    """Outputs of the 11x11 stride-5 conv over ``size`` pixels, zero
    padding 4 before and 2 after."""
    return (size + 6 - 11) // 5 + 1


def _check(h, fused, dtypes=tuple(_DTYPES)):
    """Raises unless ``h`` [N, H, W, C] and the ``fuse_cond_head`` fields
    agree; returns whether the fields are per sample."""
    if h.dim() != 4:
        raise ValueError(f"h must be [N, H, W, C], got {tuple(h.shape)}")
    if h.dtype not in dtypes:
        raise ValueError(f"dtype {h.dtype} not supported "
                         f"({', '.join(str(d)[6:] for d in dtypes)})")
    missing = [k for k in FIELDS if k not in fused]
    if missing:
        raise ValueError(f"fused head lacks {missing}")
    n, hh, ww, ch = h.shape
    per_sample = fused["k_sa"].dim() == 5
    lead = (n,) if per_sample else ()
    want = {"k_sa": (5, 5, ch, 2), "b_sa": (2,), "keff": (11, 11, ch, 1),
            "wr": (2, 11, ch), "wc": (11, 2, ch), "wcc": (2, 2, ch),
            "b1map": (_windows(hh), _windows(ww)), "bd": ()}
    for key, shape in want.items():
        t = fused[key]
        if tuple(t.shape) != lead + shape:
            raise ValueError(f"{key} must be {lead + shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != h.device:
            raise ValueError(f"{key} is on {t.device}, h is on {h.device}")
    return per_sample


def _sample_conv(x, kernel, strides=(1, 1), padding=((0, 0), (0, 0))):
    """An NHWC conv with one HWIO kernel per sample (``kernel`` [N, kh,
    kw, C, O]), no bias: one grouped conv with the batch folded into the
    channels (groups = N)."""
    n, hh, ww, c = x.shape
    o = kernel.shape[-1]
    (pt, pb), (pl, pr) = padding
    xin = F.pad(x.permute(0, 3, 1, 2).reshape(1, n * c, hh, ww),
                (pl, pr, pt, pb))
    k = kernel.permute(0, 4, 3, 1, 2).reshape(n * o, c, *kernel.shape[1:3])
    out = F.conv2d(xin, k, stride=strides, groups=n)
    return out.reshape(n, o, *out.shape[2:]).permute(0, 2, 3, 1)


def _shared_conv(x, kernel, strides=(1, 1), padding=((0, 0), (0, 0))):
    """An NHWC conv with one HWIO kernel, no bias: the ops of
    ``components.conv2d``, which this module cannot import (a host that
    runs an exported bundle imports the ops and none of the models)."""
    (pt, pb), (pl, pr) = padding
    xin = x.permute(0, 3, 1, 2)
    if pt == pb and pl == pr:
        pad = (pt, pl)
    else:
        xin = F.pad(xin, (pl, pr, pt, pb))
        pad = 0
    # the OIHW weight contiguous: torch's float64 CPU conv cannot take the
    # gradient of a channels-last weight (a contiguous HWIO kernel's view)
    return F.conv2d(xin, kernel.permute(3, 2, 0, 1).contiguous(),
                    stride=strides, padding=pad).permute(0, 2, 3, 1)


def cond_head_plain(h, fused):
    """Plain PyTorch version of :func:`cond_head` (same arguments; also
    in float64): the two convs in ``h``'s dtype, the border corrections
    in full precision.  Differentiable: the training forward's head."""
    per_sample = _check(h, fused, _PLAIN_DTYPES)
    dtype = h.dtype
    n = h.shape[0]
    hi_t = torch.promote_types(torch.float32, h.dtype)
    conv = _sample_conv if per_sample else _shared_conv
    ns = "n" if per_sample else ""
    sa = conv(h, fused["k_sa"].to(dtype), padding=((2, 2), (2, 2)))
    sa = sa.to(hi_t) + fused["b_sa"][..., None, None, :]
    main = conv(h, fused["keff"].to(dtype), strides=(5, 5),
                padding=((4, 2), (4, 2)))[..., 0].to(hi_t)
    stop_logit = sa[..., 0].reshape(n, -1).mean(dim=-1, keepdim=True)
    amap = F.relu(sa[..., 1])
    # the corrections run on thin border strips, in full precision: the
    # 1-wide strided convs over the 2-row / 2-column strips, as windows
    # (unfold, 11 wide, stride 5, zero padding 4 / 2) contracted in one
    # einsum each
    h32 = h.to(hi_t)
    rows = F.pad(h32[:, :2], (0, 0, 4, 2)).unfold(2, 11, 5)  # [N,2,w5,C,11]
    crow = torch.einsum(f"nyjcq,{ns}yqc->nj", rows, fused["wr"].to(hi_t))
    cols = F.pad(h32[:, :, :2], (0, 0, 0, 0, 4, 2)).unfold(1, 11, 5)
    ccol = torch.einsum(f"nixcp,{ns}pxc->ni", cols, fused["wc"].to(hi_t))
    ccorn = torch.einsum(f"nyxc,{ns}yxc->n", h32[:, :2, :2], fused["wcc"])
    d = main + fused["b1map"] + fused["bd"][..., None, None]
    d[:, 0, :] -= crow
    d[:, :, 0] -= ccol
    d[:, 0, 0] += ccorn
    return stop_logit, amap, d


@torch.library.custom_op("scanpaths_tpu_torch::cond_head", mutates_args=(),
                         device_types="cpu")
def cond_head_op(h: torch.Tensor, k_sa: torch.Tensor, b_sa: torch.Tensor,
                 keff: torch.Tensor, wr: torch.Tensor, wc: torch.Tensor,
                 wcc: torch.Tensor, b1map: torch.Tensor, bd: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The registered op behind :func:`cond_head`, the fields in
    :data:`FIELDS` order.  Its CPU kernel is :func:`cond_head_plain`, its
    CUDA kernel ``csrc/head.cu``; no other device has one.  Being an op,
    it is traced by ``torch.export`` as one node (``serve/export.py``).
    Its outputs are contiguous, as the CUDA kernel's are."""
    fields = (k_sa, b_sa, keff, wr, wc, wcc, b1map, bd)
    return tuple(t.contiguous()
                 for t in cond_head_plain(h, dict(zip(FIELDS, fields))))


def _copy(t):
    return t.clone(memory_format=torch.contiguous_format)


@functools.lru_cache(maxsize=None)
def _plan(n, hh, ww, ch, h5, w5):
    """[blocks of the first kernel, blocks per SM, scratch floats]."""
    return _build.grid_report("sp_cond_head_plan", 3, n, hh, ww, ch, h5, w5)


@cond_head_op.register_kernel("cuda")
def _cond_head_cuda(h, k_sa, b_sa, keff, wr, wc, wcc, b1map, bd):
    n, hh, ww, ch = h.shape
    if ch % 16:
        raise ValueError(f"the head kernel needs C % 16 == 0, got C={ch}")
    if h.dtype not in _DTYPES:
        raise ValueError(f"the head kernel takes float32 or bfloat16 h, "
                         f"got {h.dtype}")
    if not n <= 65535:
        raise ValueError(f"the head kernel takes N <= 65535, got {n}")
    fields = (k_sa, b_sa, keff, wr, wc, wcc, b1map, bd)
    if any(t.dtype != torch.float32 for t in fields):
        raise ValueError("the head kernel takes float32 fields")
    if not (h.is_contiguous() and h.data_ptr() % 16 == 0):
        raise ValueError("the head kernel needs a contiguous, 16-byte "
                         "aligned h")
    # the kernel reads the fields 16 bytes at a time: a field that is a
    # view (keff is one) or unaligned is copied, once a tensor version
    fields = [t if t.is_contiguous() and t.data_ptr() % 16 == 0
              else _build.packed(t, _copy) for t in fields]
    h5, w5 = b1map.shape[-2:]
    stop = h.new_empty((n, 1), dtype=torch.float32)
    amap = h.new_empty((n, hh, ww), dtype=torch.float32)
    d = h.new_empty((n, h5, w5), dtype=torch.float32)
    scratch = h.new_empty((_plan(n, hh, ww, ch, h5, w5)[2],),
                          dtype=torch.float32)
    fn = _build.kernel("sp_cond_head", 13, 8)
    with torch.cuda.device(h.device):
        err = fn(h.data_ptr(), *(t.data_ptr() for t in fields),
                 stop.data_ptr(), amap.data_ptr(), d.data_ptr(),
                 scratch.data_ptr(), n, hh, ww, ch, h5, w5,
                 int(k_sa.dim() == 5), _DTYPES[h.dtype],
                 torch.cuda.current_stream(h.device).cuda_stream)
    _build.check("sp_cond_head", err)
    tracing.count("cond_head.launches")
    return stop, amap, d


@cond_head_op.register_fake
def _cond_head_fake(h, k_sa, b_sa, keff, wr, wc, wcc, b1map, bd):
    n, hh, ww, _ = h.shape
    out_t = torch.promote_types(torch.float32, h.dtype)
    return (h.new_empty((n, 1), dtype=out_t),
            h.new_empty((n, hh, ww), dtype=out_t),
            h.new_empty((n, *b1map.shape[-2:]), dtype=out_t))


def cond_head(h, fused):
    """The composed conditioner+head of one stream and step (module
    docstring).  A CPU tensor runs :func:`cond_head_plain`; a CUDA tensor
    runs ``csrc/head.cu`` (float32 or bfloat16 ``h``, contiguous and
    16-byte aligned, C % 16 == 0, float32 fields) or raises; both through
    :func:`cond_head_op`.  Either raises under grad mode when an input
    requires grad (no backward: :func:`cond_head_plain` is the
    differentiable head)."""
    _check(h, fused, _PLAIN_DTYPES if h.device.type == "cpu" else _DTYPES)
    _build.refuse_grad("cond_head", h, *(fused[k] for k in FIELDS))
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no head kernel for device {h.device}")
    return cond_head_op(h, *(fused[k] for k in FIELDS))


def head_plan(n: int, hh: int, ww: int, ch: int) -> list[int]:
    """[blocks of the first kernel, blocks per SM, scratch floats] of the
    CUDA kernel at this shape (needs the card)."""
    return list(_plan(n, hh, ww, ch, _windows(hh), _windows(ww)))
