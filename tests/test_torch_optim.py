"""The port's Adam with a bfloat16 first moment (``--bf16_moments``,
``train/schedule.py::Adam``) against the JAX package's optimizer with
``mu_dtype=bfloat16`` (optax 0.2.6's ``scale_by_adam``), on the CPU.

The optax chain clips, adds the weight decay and applies Adam and the
schedule; the port clips before its optimizer step (``clip_grad_norm_``,
whose scale differs from optax's by a factor of at most 1 + 1e-6 /
norm, ``train/schedule.py``).  The bit-level case therefore feeds the
port optax's own clipped gradients (the same ``clip_by_global_norm``
the chain runs, with a clip that binds at every step) and holds the
stored moment bit-equal and the parameters within 1e-6 relative over
six steps, with weight decay.  The optax side runs op by op, and jitted
with XLA's excess precision off: with it on (XLA's default) the jitted
chain keeps ``b1 * mu`` in float32, which moves some stored moments by
one bfloat16 ulp.  The port's whole clip + Adam path is held to the
chain at rtol 1e-5, as ``test_torch_train``'s float32 case.
"""

import copy
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scanpaths_tpu.train.schedule import make_optimizer as jmake
from scanpaths_tpu_torch.train.schedule import Adam
from scanpaths_tpu_torch.train.schedule import make_optimizer as tmake

ARGS = types.SimpleNamespace(lr=3e-4, clip=0.5, weight_decay=5e-4,
                             warmup_epoch=1, start_rl_epoch=3, epoch=6,
                             rl_lr_initial_decay=0.5, bf16_moments=True)
STEPS_SUP = STEPS_RL = 4
START = 2
SHAPES = [(64, 33), (257,), (8, 8, 9)]


def _problem(seed=0, steps=6):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    return params, grads


def _optax_steps(params, grads, mode, args=ARGS):
    """The JAX package's optimizer from step START: per step (the
    clipped gradients it applied, its first moments, its parameters)."""
    opt = jmake(args, STEPS_SUP, STEPS_RL)
    clip = optax.clip_by_global_norm(args.clip)
    jp = list(map(jnp.asarray, params))
    state = optax.tree_utils.tree_set(opt.init(jp),
                                      count=jnp.asarray(START, jnp.int32))
    upd, clip_upd = opt.update, clip.update
    if mode == "jit":
        g0 = list(map(jnp.asarray, grads[0]))
        no_excess = {"xla_allow_excess_precision": False}
        upd = jax.jit(opt.update).lower(g0, state, jp).compile(
            compiler_options=no_excess)
        clip_upd = jax.jit(clip.update).lower(g0, None).compile(
            compiler_options=no_excess)
    out = []
    for g in grads:
        g = list(map(jnp.asarray, g))
        clipped, _ = clip_upd(g, None)
        u, state = upd(g, state, jp)
        jp = optax.apply_updates(jp, u)
        out.append(([np.asarray(c) for c in clipped],
                    [np.asarray(m) for m in
                     optax.tree_utils.tree_get(state, "mu")],
                    [np.asarray(p) for p in jp]))
    return out


@pytest.mark.parametrize("mode", ["eager", "jit"])
def test_bf16_moment_bit_equal_to_optax(mode):
    """Six steps with the clip binding and weight decay: the stored
    bfloat16 moment bit-equal to the op-by-op chain's at every step
    (within one bfloat16 ulp of the jitted chain's), the parameters
    within 1e-6 relative."""
    params, grads = _problem()
    want = _optax_steps(params, grads, mode)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt, sched = tmake(tp, ARGS, STEPS_SUP, STEPS_RL, step=START)
    assert isinstance(opt, Adam)
    for i, (clipped, mu, jp) in enumerate(want):
        norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                           for g in grads[i]))
        assert norm > 10 * ARGS.clip
        for p, c in zip(tp, clipped):
            p.grad = torch.from_numpy(c.copy())
        opt.step()
        sched.step()
        for p, m, q in zip(tp, mu, jp):
            st = opt.state[p]
            assert st["exp_avg"].dtype == torch.bfloat16
            assert st["exp_avg_sq"].dtype == torch.float32
            got, m = st["exp_avg"].float().numpy(), m.astype(np.float32)
            if mode == "eager":
                np.testing.assert_array_equal(got, m, err_msg=f"step {i}")
            else:
                np.testing.assert_allclose(got, m, rtol=2 ** -7, atol=0,
                                           err_msg=f"step {i}")
            np.testing.assert_allclose(
                p.detach().numpy(), q, rtol=1e-6,
                atol=1e-6 * float(np.abs(q).max()), err_msg=f"step {i}")
    assert not np.allclose(tp[0].detach().numpy(), params[0])


@pytest.mark.parametrize("clip", [0.5, 100.0, 0.0])
def test_bf16_chain_matches_optax(clip):
    """The port's path as the trainer runs it (``clip_grad_norm_``, then
    the bf16-moment Adam and the schedule) against the optax chain with
    ``mu_dtype=bfloat16``: three steps, the clip active, idle and off."""
    params, grads = _problem(seed=1, steps=3)
    args = copy.copy(ARGS)
    args.clip = clip
    opt = jmake(args, STEPS_SUP, STEPS_RL)
    jp = list(map(jnp.asarray, params))
    state = optax.tree_utils.tree_set(opt.init(jp),
                                      count=jnp.asarray(START, jnp.int32))
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    topt, sched = tmake(tp, args, STEPS_SUP, STEPS_RL, step=START)
    for g in grads:
        upd, state = opt.update(list(map(jnp.asarray, g)), state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, gi in zip(tp, g):
            p.grad = torch.from_numpy(gi.copy())
        if clip > 0:
            torch.nn.utils.clip_grad_norm_(tp, clip)
        topt.step()
        sched.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)
    for p, m in zip(tp, optax.tree_utils.tree_get(state, "mu")):
        np.testing.assert_allclose(topt.state[p]["exp_avg"].float().numpy(),
                                   np.asarray(m).astype(np.float32),
                                   rtol=2 ** -7, atol=1e-12)


def test_bf16_adam_resumes_through_a_pth(tmp_path):
    """From a preset step the moments start bfloat16 zeros and the
    count goes on from it; a run saved after three steps as the trainer
    saves it (``torch.save`` of the ``state_dict``) and resumed through
    ``make_optimizer(opt_state=...)`` (the saved moments, this run's
    flags) keeps the first moment bfloat16 and takes the same next steps
    bit for bit as the uninterrupted run."""
    params, grads = _problem(seed=2, steps=6)
    args = copy.copy(ARGS)
    args.clip = 0.0

    def run(tp, opt, sched, gs):
        for g in gs:
            for p, gi in zip(tp, g):
                p.grad = torch.from_numpy(gi.copy())
            opt.step()
            sched.step()

    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt, sched = tmake(tp, args, STEPS_SUP, STEPS_RL, step=START)
    for p in tp:
        st = opt.state[p]
        assert float(st["step"]) == START
        assert st["exp_avg"].dtype == torch.bfloat16
        assert not st["exp_avg"].any()
    run(tp, opt, sched, grads[:3])
    path = os.path.join(tmp_path, "checkpoint.pth")
    torch.save({"optimizer": opt.state_dict()}, path)
    run(tp, opt, sched, grads[3:])

    saved = torch.load(path, weights_only=True)["optimizer"]
    assert saved["state"][0]["exp_avg"].dtype == torch.bfloat16
    tp2 = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt0, sched0 = tmake(tp2, args, STEPS_SUP, STEPS_RL, step=START)
    run(tp2, opt0, sched0, grads[:3])
    step = int(saved["state"][0]["step"])
    assert step == START + 3
    opt2, sched2 = tmake(tp2, args, STEPS_SUP, STEPS_RL, step=step,
                         opt_state=saved)
    for p in tp2:
        assert opt2.state[p]["exp_avg"].dtype == torch.bfloat16
    run(tp2, opt2, sched2, grads[3:])
    for a, b in zip(tp, tp2):
        assert torch.equal(a, b)
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[a][k], opt2.state[b][k]), k


def test_default_optimizer_is_torch_adam():
    """Without ``bf16_moments`` the optimizer stays torch Adam, its
    moments in the parameters' dtype."""
    args = copy.copy(ARGS)
    args.bf16_moments = False
    p = torch.nn.Parameter(torch.zeros(3))
    opt, _ = tmake([p], args, STEPS_SUP, STEPS_RL, step=START)
    assert type(opt) is torch.optim.Adam
    assert opt.state[p]["exp_avg"].dtype == torch.float32
