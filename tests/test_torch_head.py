"""The decoder's composed conditioner+head (scanpaths_tpu_torch/ops/head.py):
the wrapper and its registered op against the plain version and against
the unfused conditioner and head convs, its argument checks, its launch
counter, its fake kernel, and the dispatch of
``components.apply_fused_cond_head`` (the kernel in the eval forward,
stock ops in the training forward).  The tests marked ``gpu`` hold the
CUDA kernel (``csrc/head.cu``) to the plain version in float64 on the
card and skip without one; this file imports no JAX, so they run there.
"""

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from scanpaths_tpu_torch.models import components, prepared
from scanpaths_tpu_torch.models.scanpath_model import ScanpathModel, \
    init_weights
from scanpaths_tpu_torch.ops import head
from scanpaths_tpu_torch.tools import common
from scanpaths_tpu_torch.utils import tracing

GEO = common.TINY


def _raw(c, gen, dtype):
    """PredictHead.raw()-shaped head weights at their init's scale."""
    def r(*shape, std):
        return torch.randn(shape, generator=gen, dtype=dtype) * std
    return {"w2": (r(1, 1, c, 1, std=c ** -0.5), r(1, std=0.1)),
            "w3": (r(1, 1, c, 1, std=c ** -0.5), r(1, std=0.1)),
            "kd": (r(7, 7, c, 1, std=(49 * c) ** -0.5), r(1, std=0.1)),
            "kd2": (r(6, 8, 1, 2, std=0.1), r(2, std=0.1))}


def _conditioner(c, gen, dtype, k=None):
    lead = () if k is None else (k,)
    return (torch.randn(lead + (5, 5, c, c), generator=gen, dtype=dtype)
            * (25 * c) ** -0.5,
            torch.randn(lead + (c,), generator=gen, dtype=dtype) * 0.1)


def _case(n, hh, ww, c, per_sample, dtype=torch.float32, seed=0,
          device="cpu"):
    """(h, fused, the unfused weights) of one stream: shared fields, or
    COCO's, one bank entry a sample with a leading [N] axis."""
    gen = torch.Generator().manual_seed(seed)
    raw = _raw(c, gen, dtype)
    h = torch.randn((n, hh, ww, c), generator=gen, dtype=dtype)
    if per_sample:
        bank_k, bank_b = _conditioner(c, gen, dtype, k=3)
        ids = torch.arange(n) % 3
        fused = prepared.fuse_bank_heads(bank_k, bank_b, ids, raw, hh, ww)
        cond = (bank_k[ids], bank_b[ids])
    else:
        cond = _conditioner(c, gen, dtype)
        fused = components.fuse_cond_head(*cond, raw, hh, ww)
    move = lambda t: t.to(device)  # noqa: E731
    return move(h), {k: move(v) for k, v in fused.items()}, (cond, raw)


def _unfused(h, cond, raw):
    """The conditioner's 5x5 conv, then the head's convs, one sample at a
    time: what the composition replaces."""
    (k1, b1), outs = cond, []
    for i in range(h.shape[0]):
        ki, bi = (k1[i], b1[i]) if k1.dim() == 5 else (k1, b1)
        x = components.conv2d(h[i:i + 1], ki, bi, padding=((2, 2), (2, 2)))
        stop = components.conv2d(x, *raw["w2"])[..., 0].mean()
        amap = F.relu(components.conv2d(x, *raw["w3"])[0, ..., 0])
        d = components.conv2d(x, *raw["kd"], strides=(5, 5),
                              padding=((2, 2), (2, 2)))[0, ..., 0]
        outs.append((stop.reshape(1), amap, d))
    return tuple(torch.stack(o) for o in zip(*outs))


@pytest.mark.parametrize("per_sample", [False, True], ids=["shared", "coco"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_gives_the_plain_results_exactly(per_sample, dtype):
    """On the CPU the wrapper, its op and apply_fused_cond_head (both
    forwards) give the plain version's results bit for bit; the plain
    version agrees with the unfused convs."""
    h, fused, (cond, raw) = _case(3, 10, 12, 16, per_sample, dtype)
    want = head.cond_head_plain(h, fused)
    assert [t.shape for t in want] == [(3, 1), (3, 10, 12), (3, 2, 2)]
    assert all(t.dtype == dtype for t in want)
    for got in (head.cond_head(h, fused),
                head.cond_head_op(h, *(fused[k] for k in head.FIELDS)),
                components.apply_fused_cond_head(h, fused, dtype),
                components.apply_fused_cond_head(h, fused, dtype,
                                                 differentiable=True)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    ref = _unfused(h, cond, raw)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    for a, b in zip(want, ref):
        torch.testing.assert_close(a, b.reshape(a.shape), atol=tol, rtol=tol)


def _bad_cases():
    h, fused, _ = _case(2, 10, 12, 16, False)
    hs, fs, _ = _case(2, 10, 12, 16, True)
    cut = dict(fused, keff=fused["keff"][:, :, :8])
    return {
        "rank": (h[0], fused, "h must be"),
        "field shape": (h, cut, "keff must be"),
        "geometry": (h[:, :, :9], fused, "must be"),
        "dtype": (h.half(), fused, "not supported"),
        "device": (h, dict(fused, wr=fused["wr"].to("meta")), "is on meta"),
        "per-sample N": (hs[:1], fs, "must be"),
        "missing": (h, {k: v for k, v in fused.items() if k != "bd"},
                    "lacks"),
    }


@pytest.mark.parametrize("case", list(_bad_cases()))
def test_argument_checks_raise(case):
    h, fused, match = _bad_cases()[case]
    for fn in (head.cond_head, head.cond_head_plain):
        with pytest.raises(ValueError, match=match):
            fn(h, fused)


def test_launch_counter_does_not_move_on_the_cpu():
    assert "cond_head" in tracing.KERNELS
    h, fused, _ = _case(2, 10, 12, 16, True)
    before = tracing.counter("cond_head.launches")
    head.cond_head(h, fused)
    components.apply_fused_cond_head(h, fused, torch.float32)
    assert tracing.counter("cond_head.launches") == before


def test_cond_head_refuses_grad():
    """No backward: under grad mode it raises for a field that requires
    grad; under no_grad it runs; the differentiable head is the plain
    version, whose gradient reaches the conditioner."""
    h, fused, _ = _case(2, 10, 12, 16, False)
    w = dict(fused, k_sa=fused["k_sa"].clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match="cond_head has no backward"):
        head.cond_head(h, w)
    with torch.no_grad():
        assert head.cond_head(h, w)[1].grad_fn is None
    stop, amap, d = components.apply_fused_cond_head(
        h, w, torch.float32, differentiable=True)
    (stop.sum() + amap.sum() + d.sum()).backward()
    assert w["k_sa"].grad is not None and w["k_sa"].grad.abs().sum() > 0


@pytest.mark.parametrize("per_sample", [False, True], ids=["shared", "coco"])
def test_registered_op_traces_with_fake_tensors(per_sample):
    """opcheck passes (schema, fake kernel, dispatch under tracing), and
    under fake tensors the op gives the output shapes and float32 (float64
    for float64 h)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    assert torch.ops.scanpaths_tpu_torch.cond_head.default is not None
    h, fused, _ = _case(2, 10, 12, 16, per_sample)
    args = (h, *(fused[k] for k in head.FIELDS))
    torch.library.opcheck(head.cond_head_op, args)
    for dtype, out_t in ((torch.float32, torch.float32),
                         (torch.bfloat16, torch.float32),
                         (torch.float64, torch.float64)):
        real = (h.to(dtype), *args[1:])
        with FakeTensorMode() as mode:
            outs = head.cond_head_op(*(mode.from_tensor(a) for a in real))
        assert [tuple(o.shape) for o in outs] == [(2, 1), (2, 10, 12),
                                                  (2, 2, 2)]
        assert all(o.dtype == out_t for o in outs)


class _OpsBySpan(TorchDispatchMode):
    """Records each op dispatched at the top level (an op's own insides
    are not seen), with the innermost tracing span open around it; a
    convolution as ``convolution/<its input's channels>``."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        stack = tracing._stack()
        name = func.overloadpacket.__name__
        if name == "convolution":
            name += f"/{args[0].shape[1]}"
        self.seen.append((stack[-1].name if stack else None, name))
        return func(*args, **(kwargs or {}))


def _head_ops(fn):
    """The ops ``fn()`` dispatches inside ``decode.step.head`` spans."""
    tracing.enable()
    try:
        with _OpsBySpan() as mode:
            fn()
    finally:
        tracing.disable()
        tracing.clear()
    return [op for span, op in mode.seen if span == "decode.step.head"]


def _wide_convs(ops):
    """The convolutions over more than one input channel: the head's
    only other conv, ``PredictHead.finish_duration``'s, reads the
    one-channel duration map."""
    return [op for op in ops if op.startswith("convolution/")
            and op != "convolution/1"]


def _tiny(task, device="cpu"):
    model = ScanpathModel(task, embed=GEO["embed"], seq_len=GEO["seq_len"],
                          map_h=GEO["map_h"], map_w=GEO["map_w"],
                          backbone_layers=GEO["layers"])
    init_weights(model, 0)
    return model.to(device).eval()


def _tiny_inputs(task, device="cpu", n=2):
    images = common.random_images(n, GEO, device)
    maps = None
    if task == "air":
        maps = torch.rand((n, GEO["map_h"], GEO["map_w"], 1),
                          generator=torch.Generator().manual_seed(1)
                          ).to(device)
    return images, maps


def test_training_forward_reaches_the_stock_ops():
    """_decode(differentiable=True) computes each step's head with stock
    convolutions over h, two a stream and step, and never the op; the
    eval forward's head is the op, once a stream and step, and convolves
    nothing wider than the duration map."""
    model = _tiny("air")
    images, maps = _tiny_inputs("air")
    train_ops = _head_ops(lambda: model.forward_train(images, maps,
                                                      train=False))
    assert "cond_head" not in train_ops
    assert len(_wide_convs(train_ops)) == 2 * 2 * GEO["seq_len"]
    eval_ops = _head_ops(lambda: model(images, maps))
    assert eval_ops.count("cond_head") == 2 * GEO["seq_len"]
    assert _wide_convs(eval_ops) == []


# the card's shapes: the main path's (30x40, C = 512) at N = 16 and 1,
# and edge ones: a map under one tile, two column tiles (W = 47), a
# 5-pixel map (one window)
CARD_CASES = [(16, 30, 40, 512), (1, 30, 40, 512), (3, 10, 12, 32),
              (2, 12, 47, 16), (2, 5, 6, 16)]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_kernel_matches_plain_on_the_card(dtype):
    """The kernel against the plain version in float64 on the kernel's own
    inputs (bfloat16 h widened exactly), for one stream (OSIE), AiR's two
    composed heads on one h, and COCO's per-sample fields.  Tolerance 2e-5
    of the output's scale (atol = rtol = 2e-5 * max(1, max |want|)): the
    kernel sums each 12,800-term dot product in float32 in 16-channel
    slices, an error of ~1e-6 of the scale; bfloat16 h changes nothing of
    that, the kernel widening each value exactly.  Launches: one a call."""
    _needs_card()
    for n, hh, ww, c in CARD_CASES:
        for label, per_sample, streams in (("osie", False, 1),
                                           ("air", False, 2),
                                           ("coco", True, 1)):
            h = _case(n, hh, ww, c, per_sample, device="cuda")[0].to(dtype)
            for s in range(streams):
                fused = _case(n, hh, ww, c, per_sample, seed=s + 1,
                              device="cuda")[1]
                before = tracing.counter("cond_head.launches")
                got = head.cond_head(h, fused)
                torch.cuda.synchronize()
                assert tracing.counter("cond_head.launches") == before + 1
                want = head.cond_head_plain(
                    h.double(), {k: v.double() for k, v in fused.items()})
                for name, a, b in zip(("stop", "amap", "d"), got, want):
                    where = f"{label} stream {s} {name} {(n, hh, ww, c)} {dtype}"
                    assert a.dtype == torch.float32, where
                    tol = 2e-5 * max(1.0, float(b.abs().max()))
                    torch.testing.assert_close(
                        a.double(), b, atol=tol, rtol=tol,
                        msg=lambda m, where=where: f"{where}: {m}")


@pytest.mark.gpu
def test_eval_forward_on_the_card_launches_the_head_kernel():
    """An eval forward on the card launches the head kernel once a stream
    and step, and its head spans dispatch no convolution over h (cuDNN's
    thin convs are gone from decode.step.head)."""
    _needs_card()
    for task, streams in (("osie", 1), ("air", 2)):
        model = _tiny(task, "cuda")
        images, maps = _tiny_inputs(task, "cuda")
        before = tracing.counter("cond_head.launches")
        ops = _head_ops(lambda: model(images, maps))
        torch.cuda.synchronize()
        assert tracing.counter("cond_head.launches") - before == \
            streams * GEO["seq_len"]
        assert ops.count("cond_head") == streams * GEO["seq_len"]
        assert _wide_convs(ops) == []
