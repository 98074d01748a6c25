"""The port's ConvLSTM decode step (scanpaths_tpu_torch/ops/cell.py)
against the JAX package's Pallas cell and flax cell.

Inputs come from a seeded numpy generator and go through both packages
in float32 on the CPU.  The Pallas kernel runs in interpret mode on the
JAX side only, fed through its flat padded-row layout helpers; the port
takes the same tensors dense NHWC.  Tolerance atol 5e-6 / rtol 1e-5:
the sums are the same up to float reassociation (the bound of
tests/test_pallas_cell.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanpaths_tpu.models.components import FusedConvLSTMCell as FlaxCell
from scanpaths_tpu.ops import pallas_cell as pc
from scanpaths_tpu_torch.models.components import FusedConvLSTMCell
from scanpaths_tpu_torch.ops import cell

ATOL, RTOL = 5e-6, 1e-5


def _inputs(rng, n, h, w, c, s):
    f = np.float32
    return dict(h=rng.standard_normal((n, h, w, c)).astype(f),
                c=rng.standard_normal((n, h, w, c)).astype(f),
                xg=(rng.standard_normal((n, h, w, 4 * c)) * 0.1).astype(f),
                smaps=[rng.standard_normal((n, h, w)).astype(f)
                       for _ in range(s)],
                kps=[(rng.standard_normal((n, 9, 3 * c)) * 0.1).astype(f)
                     for _ in range(s)],
                kh=(rng.standard_normal((3, 3, c, 4 * c)) * 0.05).astype(f))


def _pallas(a, h, w):
    """The JAX Pallas step (interpret mode) on dense inputs."""
    f32 = jnp.float32
    geo = pc.geometry(h, w)
    n, c = a["h"].shape[0], a["h"].shape[-1]
    bo, rb = geo["bo"], geo["rb"]
    hh = pc.zeros_halo(n, c, h, w, f32).at[:, bo:bo + rb].set(
        jnp.pad(a["h"], ((0, 0), (0, 0), (0, 2), (0, 0))).reshape(n, rb, c))
    st = jnp.concatenate([pc.signal_taps(s, h, w, f32) for s in a["smaps"]],
                         axis=-1)
    kp = jnp.concatenate([pc.signal_kp_pad(k, f32) for k in a["kps"]],
                         axis=1)
    ho, co = pc.cell_step(hh, pc.grid_to_body(a["c"], h, w),
                          pc.grid_to_body(a["xg"], h, w), st, kp,
                          pc.gate_kernel_flat(a["kh"], f32), h, w,
                          interpret=True)
    return (np.asarray(pc.halo_to_grid(ho, h, w)),
            np.asarray(pc.body_to_grid(co, h, w)))


@pytest.mark.parametrize("n,h,w,c,s", [(3, 6, 8, 128, 1),    # OSIE/COCO
                                       (2, 4, 6, 128, 2)])   # AiR
def test_cell_step_plain_matches_pallas(n, h, w, c, s):
    a = _inputs(np.random.default_rng(0), n, h, w, c, s)
    hn_ref, cn_ref = _pallas(a, h, w)

    t = torch.from_numpy
    c_state = t(a["c"].copy())
    hn, cn = cell.cell_step_plain(
        t(a["h"]), c_state, t(a["xg"]), t(np.stack(a["smaps"], -1)),
        t(np.stack(a["kps"], 1)), t(a["kh"]))
    assert cn is c_state  # c is updated in place
    np.testing.assert_allclose(hn.numpy(), hn_ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(cn.numpy(), cn_ref, atol=ATOL, rtol=RTOL)


def test_cell_step_on_cpu_runs_the_plain_version():
    a = _inputs(np.random.default_rng(1), 2, 5, 7, 64, 1)
    t = torch.from_numpy
    args = (t(a["xg"]), t(np.stack(a["smaps"], -1)),
            t(np.stack(a["kps"], 1)), t(a["kh"]))
    before = cell.cell_launches
    h1, c1 = cell.cell_step(t(a["h"]), t(a["c"].copy()), *args)
    h2, c2 = cell.cell_step_plain(t(a["h"]), t(a["c"].copy()), *args)
    assert cell.cell_launches == before
    assert torch.equal(h1, h2) and torch.equal(c1, c2)


def test_cell_step_rejects_bad_inputs():
    a = _inputs(np.random.default_rng(2), 1, 4, 4, 32, 1)
    t = torch.from_numpy
    h, c = t(a["h"]), t(a["c"])
    xg, sm = t(a["xg"]), t(np.stack(a["smaps"], -1))
    kp, kh = t(np.stack(a["kps"], 1)), t(a["kh"])
    with pytest.raises(ValueError, match="xg"):
        cell.cell_step(h, c, xg[..., :-1], sm, kp, kh)
    with pytest.raises(ValueError, match="signal streams"):
        cell.cell_step(h, c, xg, sm.repeat(1, 1, 1, 3),
                       kp.repeat(1, 3, 1, 1), kh)
    with pytest.raises(ValueError, match="dtype|is torch"):
        cell.cell_step(h, c.double(), xg, sm, kp, kh)


def test_fused_cell_matches_flax_cell():
    """FusedConvLSTMCell (biases folded into xg once, then cell_step)
    against the flax cell, from the same weights, one signal stream."""
    n, h, w, e = 2, 5, 6, 32
    rng = np.random.default_rng(3)
    f = np.float32
    xg = rng.standard_normal((n, h, w, 4 * e)).astype(f) * 0.1
    hs = rng.standard_normal((n, h, w, e)).astype(f)
    cs = rng.standard_normal((n, h, w, e)).astype(f)
    smap = rng.standard_normal((n, h, w)).astype(f)
    cv = rng.standard_normal((n, e)).astype(f)

    flax_cell = FlaxCell(embed=e, num_signals=1)
    vs = flax_cell.init(jax.random.PRNGKey(0), xg, hs, cs, [(smap, cv)])
    p = jax.tree.map(np.array, vs["params"])
    # nonzero biases, so that folding them is checked
    p["gates_h"]["bias"] = rng.standard_normal(4 * e).astype(f) * 0.1
    p["gates_s0"]["bias"] = rng.standard_normal(3 * e).astype(f) * 0.1
    h_ref, c_ref = flax_cell.apply({"params": p}, xg, hs, cs, [(smap, cv)])

    mod = FusedConvLSTMCell(embed=e, num_signals=1)
    t = torch.from_numpy
    sd = {"gates_h.weight": t(p["gates_h"]["kernel"].transpose(3, 2, 0, 1)),
          "gates_h.bias": t(p["gates_h"]["bias"]),
          "gates_s0.weight": t(p["gates_s0"]["kernel"].transpose(3, 2, 0, 1)),
          "gates_s0.bias": t(p["gates_s0"]["bias"])}
    mod.load_state_dict(sd)
    with torch.no_grad():
        hn, cn = mod(mod.fold_bias(t(xg)), t(hs), t(cs.copy()),
                     [(t(smap), t(cv))])
    np.testing.assert_allclose(hn.numpy(), np.asarray(h_ref), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(cn.numpy(), np.asarray(c_ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.gpu
def test_cell_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(4)
    for s in (1, 2):
        a = _inputs(rng, 2, 7, 9, 64, s)
        t = lambda x: torch.from_numpy(x).cuda()  # noqa: E731
        args = (t(a["xg"]), t(np.stack(a["smaps"], -1)),
                t(np.stack(a["kps"], 1)), t(a["kh"]))
        torch.backends.cudnn.allow_tf32 = False
        h1, c1 = cell.cell_step(t(a["h"]), t(a["c"].copy()), *args)
        h2, c2 = cell.cell_step_plain(t(a["h"]), t(a["c"].copy()), *args)
        torch.testing.assert_close(h1, h2, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(c1, c2, atol=1e-4, rtol=1e-4)
