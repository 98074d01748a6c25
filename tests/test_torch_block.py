"""The port's bottleneck stage (scanpaths_tpu_torch/ops/block.py) against
the JAX package's Pallas stage kernel and flax Bottleneck stack.

The flax stack is initialised from a seed and its BN statistics and
affine parameters are then randomised from a seeded numpy generator, so
that folding BN is exercised (fresh statistics fold to a no-op).  The
same weights go into the port's Bottleneck modules.  Float32 on the
CPU; tolerance atol = rtol = 2e-5, the bound of
tests/test_pallas_block.py (the port sums in another order).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanpaths_tpu.models.resnet import Bottleneck as FlaxBottleneck
from scanpaths_tpu.ops import pallas_block as pb
from scanpaths_tpu_torch.models import prepared
from scanpaths_tpu_torch.models.resnet import Bottleneck
from scanpaths_tpu_torch.ops import block
from scanpaths_tpu_torch.utils import tracing

TOL = 2e-5


def _flax_stack(planes, blocks, dilation):
    class Stack(nn.Module):
        @nn.compact
        def __call__(self, x):
            for bi in range(blocks):
                x = FlaxBottleneck(planes=planes, dilation=dilation,
                                   name=f"b{bi}")(x, False)
            return x
    return Stack()


def randomize_bn(variables, rng):
    """Randomised BN statistics and affine parameters (numpy trees)."""
    def walk(tree, fn):
        return {k: walk(v, fn) if isinstance(v, dict) else fn(k, v)
                for k, v in tree.items()}

    def stats(k, v):
        if k == "var":
            return (np.abs(rng.standard_normal(v.shape)) + 0.5).astype(
                np.float32)
        return (rng.standard_normal(v.shape) * 0.2).astype(np.float32)

    def params(k, v):
        if k == "scale":
            return (1.0 + rng.standard_normal(v.shape) * 0.3).astype(
                np.float32)
        if k == "bias":
            return (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
        return np.asarray(v)
    return {"params": walk(variables["params"], params),
            "batch_stats": walk(variables["batch_stats"], stats)}


def bottleneck_state(p, s):
    """One flax bottleneck's (params, stats) -> the port module's state
    dict."""
    t = torch.from_numpy
    sd = {}
    for conv, bn in (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3"),
                     ("downsample_conv", "downsample_bn")):
        if conv not in p:
            continue
        sd[f"{conv}.weight"] = t(np.ascontiguousarray(
            np.asarray(p[conv]["kernel"]).transpose(3, 2, 0, 1)))
        sd[f"{bn}.weight"] = t(np.asarray(p[bn]["scale"]))
        sd[f"{bn}.bias"] = t(np.asarray(p[bn]["bias"]))
        sd[f"{bn}.running_mean"] = t(np.asarray(s[bn]["mean"]))
        sd[f"{bn}.running_var"] = t(np.asarray(s[bn]["var"]))
        sd[f"{bn}.num_batches_tracked"] = torch.tensor(0)
    return sd


@pytest.mark.parametrize(
    "h,w,c4,m,dil,nb",
    [(6, 8, 256, 64, 1, 2),       # layer1 class
     (5, 10, 512, 128, 1, 3),     # layer2 class, non-square grid
     (6, 8, 512, 128, 2, 2)])     # dilation 2 (layer3 class)
def test_stage_plain_matches_pallas_and_flax(h, w, c4, m, dil, nb):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, h, w, c4)).astype(np.float32)
    mod = _flax_stack(m, nb, dil)
    vs = randomize_bn(mod.init(jax.random.PRNGKey(0), x), rng)
    ref_flax = np.asarray(mod.apply(vs, x))
    st = pb.stack_stage_params(vs["params"], vs["batch_stats"],
                               [f"b{i}" for i in range(nb)], jnp.float32)
    ref_pallas = np.asarray(pb.stage_apply(
        x, dil, st["w1"], st["b1"], st["w2"], st["b2"], st["w3"], st["b3"],
        interpret=True))

    blocks = []
    for i in range(nb):
        blk = Bottleneck(c4, m, dilation=dil).eval()
        blk.load_state_dict(bottleneck_state(vs["params"][f"b{i}"],
                                             vs["batch_stats"][f"b{i}"]))
        blocks.append(blk)
    with torch.no_grad():
        ours = prepared.stack_stage_params(blocks, torch.float32)
        # the stacked kernel operands equal the JAX package's
        for k in ("w1", "b1", "w2", "b2", "w3", "b3"):
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(st[k]),
                                       atol=1e-6, rtol=1e-6, err_msg=k)
        out = block.stage_apply_plain(torch.from_numpy(x), dil, ours["w1"],
                                      ours["b1"], ours["w2"], ours["b2"],
                                      ours["w3"], ours["b3"]).numpy()
        # the port's eval-mode modules (BN unfolded) agree too
        y = torch.from_numpy(x).permute(0, 3, 1, 2)
        for blk in blocks:
            y = blk(y)
    np.testing.assert_allclose(out, ref_pallas, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out, ref_flax, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), ref_flax,
                               atol=TOL, rtol=TOL)


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(1)
    f = np.float32
    k = rng.standard_normal((3, 3, 8, 16)).astype(f)          # HWIO
    gamma = (1.0 + rng.standard_normal(16) * 0.3).astype(f)
    beta = (rng.standard_normal(16) * 0.2).astype(f)
    mean = (rng.standard_normal(16) * 0.1).astype(f)
    var = (np.abs(rng.standard_normal(16)) + 0.5).astype(f)
    kj, bj = pb.fold_bn(k, gamma, beta, mean, var)
    t = torch.from_numpy
    kt, bt = prepared.fold_bn(t(k.transpose(3, 2, 0, 1).copy()), t(gamma),
                              t(beta), t(mean), t(var))
    np.testing.assert_allclose(kt.numpy().transpose(2, 3, 1, 0),
                               np.asarray(kj), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-6,
                               rtol=1e-6)


def test_stage_apply_on_cpu_runs_the_plain_version_and_checks_shapes():
    rng = np.random.default_rng(2)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    x = t(rng.standard_normal((1, 3, 4, 64)))
    w = dict(w1=t(rng.standard_normal((1, 64, 32)) * 0.1),
             b1=t(rng.standard_normal((1, 32))),
             w2=t(rng.standard_normal((1, 288, 32)) * 0.1),
             b2=t(rng.standard_normal((1, 32))),
             w3=t(rng.standard_normal((1, 32, 64)) * 0.1),
             b3=t(rng.standard_normal((1, 64))))
    before = tracing.counter("stage_apply.launches")
    y = block.stage_apply(x, 1, **w)
    assert tracing.counter("stage_apply.launches") == before
    assert torch.equal(y, block.stage_apply_plain(x, 1, **w))
    with pytest.raises(ValueError, match="w2"):
        block.stage_apply(x, 1, **dict(w, w2=w["w2"][:, :-1]))
    with pytest.raises(ValueError, match="float32"):
        block.stage_apply(x, 1, **dict(w, b1=w["b1"].double()))


def _assert_stage_refuses_grad(device):
    """stage_apply defines no backward: under grad mode it raises for an
    input that requires grad, whichever it is (before any device
    dispatch); under no_grad it runs."""
    rng = np.random.default_rng(4)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa
    args = dict(x=t(np.maximum(rng.standard_normal((1, 3, 4, 64)), 0)),
                w1=t(rng.standard_normal((1, 64, 32)) * 0.1),
                b1=t(rng.standard_normal((1, 32))),
                w2=t(rng.standard_normal((1, 288, 32)) * 0.1),
                b2=t(rng.standard_normal((1, 32))),
                w3=t(rng.standard_normal((1, 32, 64)) * 0.1),
                b3=t(rng.standard_normal((1, 64))))
    for name in args:
        kw = dict(args)
        kw[name] = kw[name].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="stage_apply has no backward"):
            block.stage_apply(dil=1, **kw)
        with torch.no_grad():
            assert block.stage_apply(dil=1, **kw).grad_fn is None


def test_stage_apply_refuses_grad():
    _assert_stage_refuses_grad("cpu")


@pytest.mark.gpu
def test_stage_apply_refuses_grad_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    _assert_stage_refuses_grad("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_stage_kernel_matches_plain_on_the_card(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(3)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa: E731
    # pixel counts off the 128-pixel tile, column counts off every tile
    # width (96, 32), dilation 1 and 2
    for (n, h, w, c, m, dil) in ((2, 7, 9, 64, 32, 2), (1, 9, 13, 96, 32, 1),
                                 (1, 11, 10, 96, 32, 2)):
        x = t(np.maximum(rng.standard_normal((n, h, w, c)), 0)).to(dtype)
        ws = dict(w1=t(rng.standard_normal((2, c, m)) * 0.1).to(dtype),
                  b1=t(rng.standard_normal((2, m)) * 0.1),
                  w2=t(rng.standard_normal((2, 9 * m, m)) * 0.05).to(dtype),
                  b2=t(rng.standard_normal((2, m)) * 0.1),
                  w3=t(rng.standard_normal((2, m, c)) * 0.1).to(dtype),
                  b3=t(rng.standard_normal((2, c)) * 0.1))
        torch.testing.assert_close(block.stage_apply(x, dil, **ws),
                                   block.stage_apply_plain(x, dil, **ws),
                                   atol=tol, rtol=tol)
