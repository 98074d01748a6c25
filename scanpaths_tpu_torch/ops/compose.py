"""The conditioner+head compositions.

The conditioner's 5x5 C->C conv output feeds the head with no
nonlinearity in between, and every head consumer of it is a linear C->1
conv, so the chain composes exactly (:func:`fuse_cond_head`): contract
the conditioner kernel with each head kernel once per forward and apply
only C->1 convs per step (``ops/head.py``).  The drt composition (7x7
stride 5 after 5x5, both zero-padded) is an 11x11 stride-5 conv on the
zero-extended input plus corrections for the windows that overlap the
conditioner's zero padding (output row 0 and column 0 when H and W are
divisible by 5).

:func:`cond_compose` composes a stack of K conditioner entries with the
head at once: OSIE's one conv, AiR's two, COCO's whole bank of 18.  On
CUDA tensors it runs the hand-written kernel (``csrc/compose.cu``), one
launch per :data:`MAXK` entries and no host sync; on CPU tensors
:func:`compose_bank_heads`, the per-entry :func:`fuse_cond_head` in plain
PyTorch ops; both as the registered op
``scanpaths_tpu_torch::cond_compose`` (:func:`cond_compose_op`), so an
exported program launches the kernel.
The kernel has no backward: the training forward composes with
:func:`compose_bank_heads` itself (``models/prepared.py``).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils import tracing
from . import _build
from .head import FIELDS

_PLAIN_DTYPES = (torch.float32, torch.float64)
MAXK = 32  # entries a kernel launch (csrc/compose.cu's MAXK)


def _conv(x, kernel, stride, pad):
    """NHWC ``x``, HWIO ``kernel``, ``pad`` zero rows and columns on
    every side, no bias."""
    return F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                    stride=stride, padding=pad).permute(0, 2, 3, 1)


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
    parameters' dtype.  Returns the tensors ``ops.head.cond_head``
    consumes.  While spans are on (``utils/tracing.py``) each call adds
    one to ``cond_head.composed``."""
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
    keff = _conv(lhs, rhsf, (1, 1), (6, 6))             # [C, 11, 11, 1]
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
    b1map = _conv(ones, k2b1[..., None, None], (5, 5), (2, 2))[0, ..., 0]

    return {"k_sa": k_sa, "b_sa": b_sa, "keff": keff, "wr": wr, "wc": wc,
            "wcc": wcc, "b1map": b1map, "bd": kdb[0]}


def compose_bank_heads(bank_k, bank_b, head_raw: dict, map_h: int,
                       map_w: int) -> dict:
    """Plain version of :func:`cond_compose`: every entry of ``bank_k``
    (a [K, 5, 5, C, C] stack or a sequence of [5, 5, C, C] kernels) and
    ``bank_b`` composed on its own by :func:`fuse_cond_head`, the fields
    stacked with a leading [K] axis."""
    parts = [fuse_cond_head(k, b, head_raw, map_h, map_w)
             for k, b in zip(bank_k, bank_b)]
    return {key: torch.stack([p[key] for p in parts]) for key in parts[0]}


def _windows(size: int) -> int:
    """Outputs of the 7x7 stride-5 drt conv over ``size`` pixels, zero
    padding 2 on each side: the rows and columns of ``b1map``."""
    return (size + 4 - 7) // 5 + 1


def _layouts(c: int) -> tuple:
    """The entry strides the kernel reads: a contiguous HWIO kernel (a
    bank entry) and the HWIO view of a contiguous OIHW ``nn.Conv2d``
    weight (``components.hwio``)."""
    return ((5 * c * c, c * c, c, 1), (5, 1, 25, 25 * c))


def _head_args(head_raw: dict) -> tuple:
    """(w2 kernel, w2 bias, w3 kernel, w3 bias, kd kernel, kd bias) of
    ``PredictHead.raw``, as the op takes them."""
    return (*head_raw["w2"], *head_raw["w3"], *head_raw["kd"])


def _check(kernels, biases, head, dtypes) -> None:
    """Raises unless ``kernels`` (each [5, 5, C, C] in one of
    :func:`_layouts`, all alike), ``biases`` (each [C], contiguous) and
    the head's tensors agree in shape, dtype and device."""
    if not kernels or len(kernels) != len(biases):
        raise ValueError(f"{len(kernels)} conditioner kernels and "
                         f"{len(biases)} biases: one or more of each, "
                         "as many of one as of the other")
    c = kernels[0].shape[-1]
    first = kernels[0]
    want = [(f"kernel {j}", t, (5, 5, c, c)) for j, t in enumerate(kernels)]
    want += [(f"bias {j}", t, (c,)) for j, t in enumerate(biases)]
    want += [(name, t, shape) for name, t, shape in zip(
        ("w2", "w2 bias", "w3", "w3 bias", "kd", "kd bias"), head,
        ((1, 1, c, 1), (1,), (1, 1, c, 1), (1,), (7, 7, c, 1), (1,)))]
    for name, t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != first.dtype:
            raise ValueError(f"{name} is {t.dtype}, kernel 0 is "
                             f"{first.dtype}")
        if t.device != first.device:
            raise ValueError(f"{name} is on {t.device}, kernel 0 is on "
                             f"{first.device}")
    if first.dtype not in dtypes:
        raise ValueError(f"dtype {first.dtype} not supported "
                         f"({', '.join(str(d)[6:] for d in dtypes)})")
    if first.stride() not in _layouts(c) or \
            any(t.stride() != first.stride() for t in kernels):
        raise ValueError(
            f"conditioner kernels at strides "
            f"{sorted({t.stride() for t in kernels})}: all must be "
            "contiguous HWIO or all the HWIO view of a contiguous OIHW "
            f"weight, {_layouts(c)}")
    if any(t.stride() != (1,) for t in biases):
        raise ValueError("conditioner biases must be contiguous")


@torch.library.custom_op("scanpaths_tpu_torch::cond_compose",
                         mutates_args=(), device_types="cpu")
def cond_compose_op(kernels: list[torch.Tensor], biases: list[torch.Tensor],
                    w2: torch.Tensor, w2b: torch.Tensor, w3: torch.Tensor,
                    w3b: torch.Tensor, kd: torch.Tensor, kdb: torch.Tensor,
                    map_h: int, map_w: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor]:
    """The registered op behind :func:`cond_compose`: the composed fields
    in :data:`ops.head.FIELDS` order, each with a leading [K] axis.  Its
    CPU kernel is :func:`compose_bank_heads`, its CUDA kernel
    ``csrc/compose.cu``; no other device has one.  Its outputs are
    contiguous, as the CUDA kernel's are."""
    _check(kernels, biases, (w2, w2b, w3, w3b, kd, kdb), _PLAIN_DTYPES)
    raw = {"w2": (w2, w2b), "w3": (w3, w3b), "kd": (kd, kdb)}
    fused = compose_bank_heads(kernels, biases, raw, map_h, map_w)
    return tuple(fused[k].contiguous() for k in FIELDS)


def _outputs(kernels, map_h, map_w):
    """The op's outputs, uninitialised, in :data:`ops.head.FIELDS`
    order, on the entries' device and in their dtype."""
    k, c = len(kernels), kernels[0].shape[-1]
    shapes = {"k_sa": (k, 5, 5, c, 2), "b_sa": (k, 2),
              "keff": (k, 11, 11, c, 1), "wr": (k, 2, 11, c),
              "wc": (k, 11, 2, c), "wcc": (k, 2, 2, c),
              "b1map": (k, _windows(map_h), _windows(map_w)), "bd": (k,)}
    return tuple(kernels[0].new_empty(shapes[f]) for f in FIELDS)


@cond_compose_op.register_kernel("cuda")
def _cond_compose_cuda(kernels, biases, w2, w2b, w3, w3b, kd, kdb, map_h,
                       map_w):
    _check(kernels, biases, (w2, w2b, w3, w3b, kd, kdb), (torch.float32,))
    first = kernels[0]
    k, c = len(kernels), first.shape[-1]
    outs = _outputs(kernels, map_h, map_w)
    ks = (ctypes.c_void_p * k)(*(t.data_ptr() for t in kernels))
    bs = (ctypes.c_void_p * k)(*(t.data_ptr() for t in biases))
    h5, w5 = outs[FIELDS.index("b1map")].shape[1:]
    fn = _build.kernel("sp_cond_compose", 16, 15)
    with torch.cuda.device(first.device):
        err = fn(ctypes.addressof(ks), ctypes.addressof(bs), kd.data_ptr(),
                 w2.data_ptr(), w3.data_ptr(), w2b.data_ptr(),
                 w3b.data_ptr(), kdb.data_ptr(),
                 *(t.data_ptr() for t in outs), k, c, map_h, map_w, h5, w5,
                 *first.stride(), *kd.stride()[:3], w2.stride(2),
                 w3.stride(2),
                 torch.cuda.current_stream(first.device).cuda_stream)
    _build.check("sp_cond_compose", err)
    tracing.count("cond_compose.launches", -(-k // MAXK))
    if tracing.active():
        tracing.count("cond_head.composed", k)
    return outs


@cond_compose_op.register_fake
def _cond_compose_fake(kernels, biases, w2, w2b, w3, w3b, kd, kdb, map_h,
                       map_w):
    return _outputs(kernels, map_h, map_w)


def cond_compose(bank_k, bank_b, head_raw: dict, map_h: int,
                 map_w: int) -> dict:
    """Every entry of ``bank_k`` (a [K, 5, 5, C, C] stack or a sequence
    of [5, 5, C, C] HWIO kernels, each contiguous or the HWIO view of an
    OIHW conv weight) and ``bank_b`` composed with the head
    (``PredictHead.raw``): the fields of :func:`fuse_cond_head` with a
    leading [K] axis.  A CPU tensor runs :func:`compose_bank_heads`
    (float32 or float64); a CUDA tensor runs ``csrc/compose.cu`` (float32)
    or raises; both through :func:`cond_compose_op`.  Either raises under
    grad mode when an input requires grad (no backward)."""
    kernels, biases = list(bank_k), list(bank_b)
    if not kernels:
        raise ValueError("no conditioner kernel to compose")
    head = _head_args(head_raw)
    _build.refuse_grad("cond_compose", *kernels, *biases, *head)
    if kernels[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"no compose kernel for device "
                         f"{kernels[0].device}")
    return dict(zip(FIELDS, cond_compose_op(kernels, biases, *head, map_h,
                                            map_w)))
