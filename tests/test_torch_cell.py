"""The port's ConvLSTM decode step (scanpaths_tpu_torch/ops/cell.py)
against the JAX package's Pallas cell and flax cell.

Inputs come from a seeded numpy generator and go through both packages
in float32 on the CPU.  The Pallas kernel runs in interpret mode on the
JAX side only, fed through its flat padded-row layout helpers; the port
takes the same tensors dense NHWC.  Tolerance atol 5e-6 / rtol 1e-5:
the sums are the same up to float reassociation (the bound of
tests/test_pallas_cell.py).  The tests marked ``gpu`` hold the CUDA
kernel to the plain step on the card, and its persistent schedule to
the kernel's own report; they skip without one.  JAX is imported inside
the tests that compare with it, so this file runs on a card that has
no JAX.
"""

import numpy as np
import pytest
import torch

from scanpaths_tpu_torch.models import prepared
from scanpaths_tpu_torch.models.components import FusedConvLSTMCell
from scanpaths_tpu_torch.ops import _build, cell
from scanpaths_tpu_torch.utils import tracing

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
    import jax.numpy as jnp

    from scanpaths_tpu.ops import pallas_cell as pc
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
    before = tracing.counter("cell_step.launches")
    h1, c1 = cell.cell_step(t(a["h"]), t(a["c"].copy()), *args)
    h2, c2 = cell.cell_step_plain(t(a["h"]), t(a["c"].copy()), *args)
    assert tracing.counter("cell_step.launches") == before
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


def _refusal_cases(device):
    a = _inputs(np.random.default_rng(4), 1, 4, 5, 32, 1)
    t = lambda x: torch.from_numpy(x).to(device)  # noqa: E731
    return dict(h=t(a["h"]), c=t(a["c"]), xg=t(a["xg"]),
                smaps=t(np.stack(a["smaps"], -1)),
                kps=t(np.stack(a["kps"], 1)), kh=t(a["kh"]))


def _assert_cell_refuses_grad(device):
    """cell_step defines no backward: under grad mode it raises for an
    input that requires grad, whichever it is; under no_grad it runs."""
    args = _refusal_cases(device)
    for name in args:
        kw = dict(args, c=args["c"].clone())
        kw[name] = kw[name].clone().requires_grad_(True)
        with pytest.raises(RuntimeError, match="cell_step has no backward"):
            cell.cell_step(**kw)
        with torch.no_grad():
            h, _ = cell.cell_step(**kw)
        assert h.grad_fn is None


def test_cell_step_refuses_grad():
    _assert_cell_refuses_grad("cpu")


@pytest.mark.gpu
def test_cell_step_refuses_grad_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    _assert_cell_refuses_grad("cuda")


def test_fused_cell_matches_flax_cell():
    """FusedConvLSTMCell (biases folded into xg once, then cell_step)
    against the flax cell, from the same weights, one signal stream."""
    import jax

    from scanpaths_tpu.models.components import FusedConvLSTMCell as FlaxCell
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
        kh, bias = prepared.cell(mod)
        hn, cn = mod((t(xg) + bias).contiguous(), t(hs), t(cs.copy()),
                     [(t(smap), t(cv))], kh)
    np.testing.assert_allclose(hn.numpy(), np.asarray(h_ref), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(cn.numpy(), np.asarray(c_ref), atol=ATOL,
                               rtol=RTOL)


def test_pack_gate_kernel_roundtrip_and_layout():
    """The kernel's packed gate kernel: unpack(pack(kh)) is kh, row
    g*C + c of the packed form is output column g*C + c tap-major, and
    the plain step fed the unpacked kernel still matches the Pallas
    step."""
    n, h, w, c, s = 2, 4, 5, 32, 1
    a = _inputs(np.random.default_rng(5), n, h, w, c, s)
    kh = torch.from_numpy(a["kh"])
    kt = cell.pack_gate_kernel(kh)
    assert tuple(kt.shape) == (4 * c, 9 * c) and kt.is_contiguous()
    assert torch.equal(cell.unpack_gate_kernel(kt), kh)
    for col in (0, c + 3, 4 * c - 1):
        assert torch.equal(kt[col], kh[..., col].reshape(-1))
    hn_ref, cn_ref = _pallas(a, h, w)
    t = torch.from_numpy
    hn, cn = cell.cell_step_plain(
        t(a["h"]), t(a["c"].copy()), t(a["xg"]), t(np.stack(a["smaps"], -1)),
        t(np.stack(a["kps"], 1)), cell.unpack_gate_kernel(kt))
    np.testing.assert_allclose(hn.numpy(), hn_ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(cn.numpy(), cn_ref, atol=ATOL, rtol=RTOL)


def test_packed_layout_is_kept_until_the_weight_changes():
    """The wrappers pack a weight once per tensor: the same tensor gives
    the same packed object, and an in-place change packs it anew."""
    kh = torch.from_numpy(
        np.random.default_rng(6).standard_normal((3, 3, 32, 128))
        .astype(np.float32))
    kt = _build.packed(kh, cell.pack_gate_kernel)
    assert _build.packed(kh, cell.pack_gate_kernel) is kt
    assert torch.equal(kt, cell.pack_gate_kernel(kh))
    kh.mul_(2.0)
    kt2 = _build.packed(kh, cell.pack_gate_kernel)
    assert kt2 is not kt and torch.equal(kt2, cell.pack_gate_kernel(kh))
    other = _build.packed(kh, lambda t: t.reshape(-1))
    assert other.shape == (3 * 3 * 32 * 128,)


def test_plain_step_runs_in_float64_and_the_kernel_path_refuses_it():
    """The plain step is also a float64 reference (the smoke holds the
    kernel and cuDNN to it on the card); cell_step takes float32 and
    bfloat16 only."""
    n, h, w, c, s = 1, 3, 4, 32, 2
    a = _inputs(np.random.default_rng(7), n, h, w, c, s)
    args = [a["h"], a["c"], a["xg"], np.stack(a["smaps"], -1),
            np.stack(a["kps"], 1), a["kh"]]
    h32, c32 = cell.cell_step_plain(*(torch.from_numpy(x.copy())
                                      for x in args))
    h64, c64 = cell.cell_step_plain(*(torch.from_numpy(x.astype(np.float64))
                                      for x in args))
    assert h64.dtype == torch.float64 and c64.dtype == torch.float64
    np.testing.assert_allclose(h32.numpy(), h64.numpy(), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(c32.numpy(), c64.numpy(), atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="not supported"):
        cell.cell_step(*(torch.from_numpy(x.astype(np.float64))
                         for x in args))


# kernel edge cases: pixel counts off the 128-pixel tile, both signal
# stream counts, and C % 64 != 0 (the narrower gate tile)
GPU_CASES = [(2, 7, 9, 64, 1), (2, 7, 9, 64, 2), (3, 5, 11, 96, 2),
             (1, 30, 40, 128, 1)]
# the benchmark's float32 shapes: 16 images (tiles cut along K after 8
# whole rounds) and one (every tile cut), one and two streams
BENCH_CASES = [(16, 30, 40, 512, 1), (16, 30, 40, 512, 2),
               (1, 30, 40, 512, 1), (1, 30, 40, 512, 2)]


def _card_args(a, dtype):
    t = lambda x: torch.from_numpy(x).cuda().to(dtype)  # noqa: E731
    return t(a["h"]), (t(a["xg"]), t(np.stack(a["smaps"], -1)),
                       t(np.stack(a["kps"], 1)), t(a["kh"])), t(a["c"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cell_kernel_matches_plain_on_the_card(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(4)
    cases = GPU_CASES + (BENCH_CASES if dtype == torch.float32 else [])
    for n, h, w, c, s in cases:
        hs, args, cs = _card_args(_inputs(rng, n, h, w, c, s), dtype)
        h1, c1 = cell.cell_step(hs, cs.clone(), *args)
        h2, c2 = cell.cell_step_plain(hs, cs.clone(), *args)
        torch.testing.assert_close(h1, h2, atol=tol, rtol=tol)
        torch.testing.assert_close(c1, c2, atol=tol, rtol=tol)


@pytest.mark.gpu
def test_float32_cell_kernel_is_deterministic_on_the_card():
    """Two calls on the same inputs give the same bits: the pieces of a
    tile cut along K are added by its owner in one fixed order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(8)
    for n, h, w, c, s in [(16, 30, 40, 512, 1), (1, 30, 40, 512, 2),
                          (3, 5, 11, 96, 2)]:
        hs, args, cs = _card_args(_inputs(rng, n, h, w, c, s),
                                  torch.float32)
        before = tracing.counter("cell_step.split_tiles")
        h1, c1 = cell.cell_step(hs, cs.clone(), *args)
        h2, c2 = cell.cell_step(hs, cs.clone(), *args)
        assert torch.equal(h1, h2) and torch.equal(c1, c2)
        sched = cell.cell_schedule(n, h, w, c, cell._slots(
            torch.cuda.current_device(), 64 if c % 64 == 0 else 32))
        assert sched.split_tiles > 0
        assert tracing.counter("cell_step.split_tiles") - before == \
            2 * sched.split_tiles


@pytest.mark.gpu
def test_cell_grid_reports_the_schedule_on_the_card():
    """``sp_cell_grid`` (the kernel's own arithmetic) and
    :func:`cell.cell_schedule` give the same persistent schedule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernel has no CPU mode")
    for shape in SCHEDULE_SHAPES:
        rep = cell.cell_grid(*shape, torch.float32)
        sched = cell.cell_schedule(*shape, rep["sms"] * rep["per_sm"])
        assert (rep["ctas"], rep["tiles"], rep["split_tiles"], rep["most"],
                rep["units"]) == (sched.ctas, sched.tiles,
                                  sched.split_tiles, sched.most, sched.units)


# N = 1, 8 and 16 at the benchmark's map and width, a ragged pixel count
# and C % 64 != 0
SCHEDULE_SHAPES = [(1, 30, 40, 512), (8, 30, 40, 512), (16, 30, 40, 512),
                   (3, 7, 9, 64), (3, 5, 11, 96)]


@pytest.mark.parametrize("shape", SCHEDULE_SHAPES)
def test_cell_schedule_covers_every_chunk_once(shape):
    """The float32 kernel's persistent schedule on an H100 (132 SMs, one
    CTA each): every (tile, K chunk) falls to exactly one CTA, no CTA's
    work passes the mean by a chunk or more, the summary agrees with the
    items the CTAs walk, and the owner of a cut tile (the CTA holding its
    first chunk) waits only on lower CTAs, for the first item they walk."""
    sched = cell.cell_schedule(*shape, 132)
    work = cell.cell_work(sched)
    assert len(work) == sched.ctas <= 132
    seen = np.zeros((sched.tiles, sched.chunks), dtype=np.int64)
    for items in work:
        for t, k0, k1 in items:
            assert 0 <= k0 < k1 <= sched.chunks
            seen[t, k0:k1] += 1
    assert (seen == 1).all()
    units = [sum(k1 - k0 for _, k0, k1 in items) for items in work]
    assert sum(units) == sched.units == sched.tiles * sched.chunks
    assert max(units) == sched.most
    assert max(units) - sched.units / sched.ctas < 1
    pieces = {}
    for b, items in enumerate(work):
        for pos, (t, k0, k1) in enumerate(items):
            if k1 - k0 < sched.chunks:
                pieces.setdefault(t, []).append((k0, b, pos))
    assert len(pieces) == sched.split_tiles
    for t, ps in pieces.items():
        ps.sort()
        k0, owner, _ = ps[0]
        assert k0 == 0 and t < sched.cut
        for _, b, pos_b in ps[1:]:
            assert b < owner and pos_b == 0   # lower blocks, first items
    if shape[0] == 16:
        # no CTA ends the step on a whole tile alone: the split evens it
        assert sched.split_tiles > 0 and sched.rounds >= 1
    if shape[0] == 1:
        assert sched.ctas == 132 and sched.rounds == 0
