"""The conditioner+head compositions of a stack of conditioner entries
(scanpaths_tpu_torch/ops/compose.py): the whole-bank composition
gathered by task id against ``fuse_cond_head`` entry by entry and
against the JAX package's ``fuse_cond_head``, the wrapper's argument
checks, the registered op under fake tensors, the host check of task
ids, and the training forward's stock-op composition.  The tests marked
``gpu`` hold the CUDA kernel (``csrc/compose.cu``) to the plain version
in float64 on the card, and a COCO eval forward's composition to no
host sync and one kernel launch a weight version; they skip without
one.  JAX is
imported inside the one test that compares with it, so this file runs
on a card that has no JAX.
"""

import numpy as np
import pytest
import torch

from scanpaths_tpu_torch.models import components, prepared
from scanpaths_tpu_torch.models.scanpath_model import ScanpathModel, \
    init_weights
from scanpaths_tpu_torch.ops import compose
from scanpaths_tpu_torch.tools import common
from scanpaths_tpu_torch.utils import tracing

GEO = common.TINY


def _raw(c, gen, dtype=torch.float32, device="cpu"):
    """PredictHead.raw()-shaped head weights at their init's scale, the
    kernels as the HWIO views of OIHW conv weights, as the model's are."""
    def r(*shape, std):
        return (torch.randn(shape, generator=gen, dtype=dtype) * std
                ).to(device)
    hwio = lambda w: w.permute(2, 3, 1, 0)  # noqa: E731
    return {"w2": (hwio(r(1, c, 1, 1, std=c ** -0.5)), r(1, std=0.1)),
            "w3": (hwio(r(1, c, 1, 1, std=c ** -0.5)), r(1, std=0.1)),
            "kd": (hwio(r(1, c, 7, 7, std=(49 * c) ** -0.5)), r(1, std=0.1)),
            "kd2": (hwio(r(2, 1, 6, 8, std=0.1)), r(2, std=0.1))}


def _bank(k, c, gen, dtype=torch.float32, device="cpu"):
    """A [K, 5, 5, C, C] HWIO bank (COCO's layout) and its [K, C] biases."""
    return ((torch.randn((k, 5, 5, c, c), generator=gen, dtype=dtype)
             * (25 * c) ** -0.5).to(device),
            (torch.randn((k, c), generator=gen, dtype=dtype) * 0.3
             ).to(device))


def _convs(k, c, gen, dtype=torch.float32, device="cpu"):
    """K entries as OSIE's and AiR's conditioners hold them: the HWIO
    views of OIHW conv weights, with their biases."""
    ws = [(torch.randn((c, c, 5, 5), generator=gen, dtype=dtype)
           * (25 * c) ** -0.5).to(device) for _ in range(k)]
    bs = [(torch.randn((c,), generator=gen, dtype=dtype) * 0.3).to(device)
          for _ in range(k)]
    return [w.permute(2, 3, 1, 0) for w in ws], bs


@pytest.mark.parametrize("heads", [1, 2, 18])
@pytest.mark.parametrize("mh, mw", [(10, 15), (12, 13)],
                         ids=["divisible", "ragged"])
def test_bank_gathered_by_id_is_each_entry_and_jax(heads, mh, mw):
    """The whole-bank composition gathered by task id (repeats, and ids
    absent from the batch composed all the same) equals fuse_cond_head
    on each sample's entry exactly, and the JAX package's fuse_cond_head
    at atol = rtol = 1e-5 (float32 sums in other orders); on maps that 5
    divides and that it does not (b1map's clipped windows)."""
    from scanpaths_tpu.models import components as jc
    gen = torch.Generator().manual_seed(heads)
    c = 8
    bank_k, bank_b = _bank(heads, c, gen)
    raw = _raw(c, gen)
    ids = torch.tensor([heads - 1, 0, heads - 1, heads // 2])
    bank = compose.cond_compose(bank_k, bank_b, raw, mh, mw)
    assert all(v.shape[0] == heads for v in bank.values())
    fused = prepared.fuse_bank_heads(bank_k, bank_b, ids, raw, mh, mw)
    raw_np = {k: (a.numpy(), b.numpy()) for k, (a, b) in raw.items()}
    for n, i in enumerate(ids.tolist()):
        one = components.fuse_cond_head(bank_k[i], bank_b[i], raw, mh, mw)
        fj = jc.fuse_cond_head(bank_k[i].numpy(), bank_b[i].numpy(), raw_np,
                               mh, mw)
        for key in compose.FIELDS:
            assert torch.equal(fused[key][n], one[key]), key
            assert torch.equal(bank[key][i], one[key]), key
            np.testing.assert_allclose(fused[key][n].numpy(),
                                       np.asarray(fj[key]), atol=1e-5,
                                       rtol=1e-5, err_msg=key)


def test_conv_views_compose_as_contiguous_kernels():
    """OSIE's and AiR's entries, the HWIO views of OIHW conv weights,
    compose as the same kernels made contiguous, in float64 too, up to
    the order of the CPU's sums over a strided operand (torch's default
    tolerances of the dtype)."""
    gen = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, torch.float64):
        ks, bs = _convs(2, 8, gen, dtype)
        raw = _raw(8, gen, dtype)
        got = compose.cond_compose(ks, bs, raw, 10, 10)
        want = compose.cond_compose(torch.stack(ks), torch.stack(bs), raw,
                                    10, 10)
        for key in compose.FIELDS:
            assert got[key].dtype == dtype
            torch.testing.assert_close(got[key], want[key], msg=key)


def _bad(case):
    """(kernels, biases, raw, error match) of one malformed call."""
    gen = torch.Generator().manual_seed(4)
    c = 8
    bank_k, bank_b = _bank(3, c, gen)
    raw = _raw(c, gen)
    ks, bs = list(bank_k), list(bank_b)
    if case == "dtype":
        return [k.half() for k in ks], [b.half() for b in bs], \
            {k: (a.half(), b.half()) for k, (a, b) in raw.items()}, \
            "not supported"
    if case == "mixed_dtype":
        return [ks[0], ks[1].double(), ks[2]], bs, raw, "kernel 1 is"
    if case == "kernel_shape":
        return [k[..., :-1] for k in ks], bs, raw, "kernel 0 must be"
    if case == "bias_shape":
        return ks, [b[:-1] for b in bs], raw, "bias 0 must be"
    if case == "head_shape":
        return ks, bs, {**raw, "kd": (raw["kd"][0][:5], raw["kd"][1])}, \
            "kd must be"
    if case == "count":
        return ks, bs[:2], raw, "as many of one"
    if case == "kernel_layout":
        return [k.transpose(2, 3) for k in ks], bs, raw, "strides"
    if case == "mixed_layout":
        view = ks[1].permute(3, 2, 0, 1).contiguous().permute(2, 3, 1, 0)
        return [ks[0], view, ks[2]], bs, raw, "strides"
    if case == "bias_layout":
        wide = torch.randn((3, 2 * c), generator=gen)
        return ks, list(wide[:, ::2]), raw, "biases must be contiguous"
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "dtype", "mixed_dtype", "kernel_shape", "bias_shape", "head_shape",
    "count", "kernel_layout", "mixed_layout", "bias_layout"])
def test_wrapper_refuses_malformed_arguments(case):
    """A wrong dtype, shape or layout raises ValueError before any
    launch: the kernel reads contiguous HWIO entries or the HWIO views of
    contiguous OIHW weights, all alike, and contiguous biases."""
    ks, bs, raw, match = _bad(case)
    with pytest.raises(ValueError, match=match):
        compose.cond_compose(ks, bs, raw, 10, 10)


def test_wrapper_refuses_grad():
    """No backward: under grad mode an input that requires grad raises."""
    gen = torch.Generator().manual_seed(5)
    bank_k, bank_b = _bank(2, 8, gen)
    raw = _raw(8, gen)
    with pytest.raises(RuntimeError, match="no backward"):
        compose.cond_compose(bank_k.requires_grad_(), bank_b, raw, 10, 10)
    with torch.no_grad():
        compose.cond_compose(bank_k, bank_b, raw, 10, 10)


def test_registered_op_traces_with_fake_tensors():
    """opcheck passes (schema, fake kernel, dispatch under tracing), and
    under fake tensors the op gives the fields' shapes with a leading [K]
    axis in the entries' dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    gen = torch.Generator().manual_seed(6)
    bank_k, bank_b = _bank(3, 8, gen)
    raw = _raw(8, gen)
    args = (list(bank_k), list(bank_b), *compose._head_args(raw), 12, 13)
    torch.library.opcheck(compose.cond_compose_op, args)
    with FakeTensorMode() as mode:
        fake = lambda t: mode.from_tensor(t)  # noqa: E731
        outs = compose.cond_compose_op(
            [fake(t) for t in args[0]], [fake(t) for t in args[1]],
            *(fake(t) for t in args[2:8]), 12, 13)
    want = {"k_sa": (3, 5, 5, 8, 2), "b_sa": (3, 2), "keff": (3, 11, 11, 8, 1),
            "wr": (3, 2, 11, 8), "wc": (3, 11, 2, 8), "wcc": (3, 2, 2, 8),
            "b1map": (3, 2, 3), "bd": (3,)}
    assert [tuple(o.shape) for o in outs] == [want[k] for k in compose.FIELDS]
    assert all(o.dtype == torch.float32 for o in outs)


@pytest.mark.parametrize("ids", [[0, 18], [-1, 3]], ids=["past", "negative"])
def test_host_ids_outside_the_bank_raise(ids):
    """Ids in a host tensor are checked on the host: one past the bank
    or negative raises ValueError."""
    gen = torch.Generator().manual_seed(7)
    bank_k, bank_b = _bank(18, 8, gen)
    with pytest.raises(ValueError, match="outside the bank"):
        prepared.fuse_bank_heads(bank_k, bank_b, torch.tensor(ids),
                                 _raw(8, gen), 10, 10)


def _model(task, device="cpu"):
    model = ScanpathModel(task, embed=GEO["embed"], seq_len=GEO["seq_len"],
                          map_h=GEO["map_h"], map_w=GEO["map_w"],
                          backbone_layers=GEO["layers"])
    init_weights(model, 0)
    with torch.no_grad():
        if task == "coco":
            model.conditioner.bank_bias.normal_(0, 0.3)
    return model.to(device).eval()


@pytest.mark.parametrize("task", ["osie", "air", "coco"])
def test_training_forward_composes_in_stock_ops(task):
    """The differentiable composition (the training forward's) calls
    fuse_cond_head once a conditioner entry (COCO's whole bank, gathered
    by id) and carries gradients to the conditioner; its values are the
    eval composition's."""
    model = _model(task)
    ids = torch.tensor([5, 2, 5]) if task == "coco" else None
    tracing.reset_counters("cond_head.composed")
    tracing.enable()
    try:
        train = model._fused_heads(ids, differentiable=True)
    finally:
        tracing.disable()
    assert tracing.counter("cond_head.composed") == \
        {"osie": 1, "air": 2, "coco": 18}[task]
    with torch.no_grad():
        evals = model._fused_heads(ids)
    for got, want in zip(train, evals):
        assert got["k_sa"].requires_grad
        for key in compose.FIELDS:
            torch.testing.assert_close(got[key].detach(), want[key],
                                       atol=0, rtol=0)
    sum(f["keff"].sum() + f["b1map"].sum() for f in train).backward()
    grads = [p.grad for p in model.conditioner.parameters()]
    assert all(g is not None and g.abs().sum() > 0 for g in grads)


@pytest.mark.parametrize("task", ["osie", "air", "coco"])
def test_training_composition_backpropagates_through_the_head_in_float64(
        task):
    """The training forward's composition (stacked fields, so keff is a
    contiguous HWIO kernel) through the plain head and back, in float64
    on the CPU, where torch's conv takes no gradient of a channels-last
    weight: every conditioner and head parameter gets a finite gradient."""
    model = _model(task).to(torch.float64)
    ids = torch.tensor([5, 2, 5]) if task == "coco" else None
    n = 3
    h = torch.randn((n, GEO["map_h"], GEO["map_w"], GEO["embed"]),
                    generator=torch.Generator().manual_seed(9),
                    dtype=torch.float64)
    loss = 0
    for fused in model._fused_heads(ids, differentiable=True):
        loss = loss + sum(o.sum() for o in components.apply_fused_cond_head(
            h, fused, torch.float64, differentiable=True))
    loss.backward()
    params = list(model.conditioner.parameters()) + [
        model.head.drt_layer_1.weight, model.head.sal_layer_2.weight,
        model.head.sal_layer_3.weight]
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               and p.grad.abs().sum() > 0 for p in params)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("heads, layout", [(1, "conv"), (2, "conv"),
                                           (18, "bank"), (2, "bank"),
                                           (40, "bank")])
def test_kernel_matches_plain_on_the_card(heads, layout):
    """The kernel at C = 512 and a 30x40 map (the main path's shapes:
    OSIE's and AiR's conv views, COCO's bank) against the plain version in
    float64 on the same float32 inputs.  Tolerance 2e-5 of each field's
    scale (atol = 2e-5 * max(1, max |want|), rtol 2e-5): the kernel sums
    each 512-term product in float32 in order, then folds at most 25 of
    them, an error of ~1e-6 of the scale.  One launch per 32 entries (40,
    two launches), each counted."""
    _needs_card()
    gen = torch.Generator().manual_seed(heads)
    c = 512
    if layout == "bank":
        ks, bs = _bank(heads, c, gen, device="cuda")
    else:
        ks, bs = _convs(heads, c, gen, device="cuda")
    raw = _raw(c, gen, device="cuda")
    before = tracing.counter("cond_compose.launches")
    with torch.no_grad():
        got = compose.cond_compose(ks, bs, raw, 30, 40)
        torch.cuda.synchronize()
        assert tracing.counter("cond_compose.launches") == \
            before + -(-heads // compose.MAXK)
        want = compose.compose_bank_heads(
            [k.double() for k in ks], [b.double() for b in bs],
            {k: (a.double(), b.double()) for k, (a, b) in raw.items()},
            30, 40)
    for key in compose.FIELDS:
        w = want[key]
        assert got[key].dtype == torch.float32
        assert got[key].is_contiguous()
        tol = 2e-5 * max(1.0, float(w.abs().max()))
        torch.testing.assert_close(got[key].double(), w, atol=tol, rtol=2e-5,
                                   msg=key)


@pytest.mark.gpu
def test_coco_eval_composition_has_no_host_sync_on_the_card():
    """A COCO eval forward's composition (ids on the card) after a
    change of the bank's weights runs under
    torch.cuda.set_sync_debug_mode("error"), launches the compose kernel
    once and at most 16 kernels in all (the kernel, the device-side range
    check and the gathers), and equals the plain composition gathered by
    id; a whole eval forward on unchanged weights composes nothing."""
    _needs_card()
    model = _model("coco", "cuda")
    ids = torch.tensor([4, 0, 4, 17, 9], device="cuda")
    with torch.no_grad():
        model._fused_heads(ids)
        torch.cuda.synchronize()
        model.conditioner.bank_bias.add_(0.0)   # a new weight version
        before = tracing.counter("cond_compose.launches")
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda.set_sync_debug_mode("error")
            try:
                fused, = model._fused_heads(ids)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
        assert tracing.counter("cond_compose.launches") == before + 1
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert 1 <= len(kernels) <= 16, [e.name for e in kernels]
        (bank_k, bank_b), = model.conditioner.kernels()
        want = compose.compose_bank_heads(bank_k.cpu(), bank_b.cpu(),
                                          {k: (a.cpu(), b.cpu()) for k, (a, b)
                                           in model.head.raw().items()},
                                          model.map_h, model.map_w)
        for key in compose.FIELDS:
            w = want[key][ids.cpu()]
            tol = 2e-5 * max(1.0, float(w.abs().max()))
            torch.testing.assert_close(fused[key].cpu(), w, atol=tol,
                                       rtol=2e-5, msg=key)
        images = common.random_images(5, GEO, "cuda")
        maps = torch.rand((5, GEO["map_h"], GEO["map_w"], 1), device="cuda")
        before = tracing.counter("cond_compose.launches")
        model(images, maps, ids)
        torch.cuda.synchronize()
        assert tracing.counter("cond_compose.launches") == before
