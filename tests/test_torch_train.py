"""The port's training layer against the JAX package's, on the CPU: the
losses, the LR schedule and optimizer chain, the supervised batch, the
supervised step of each task, the SCST loss and step of each task (AiR
with the Consistency-Divergence term on and off), and the bf16
supervised step.

Geometry: ``test_torch_tasks``'s (80x96 images, a 10x12 map, T = 4,
embed 64), trunk (1,1,1,1); the JAX model runs its differentiable XLA
cell, as its own training does.  Weights come from a flax init with
every BN statistic and bias randomised (``test_torch_tasks``); the SCST
cases scale the duration head's last conv by 0.01, as the JAX package's
own SCST test does (``tests/test_train.py::test_rl_step_improves_reward``):
the seed head's LogNormal scale overflows float32 in the sampler.

Steps start at optimizer step 2 (the warmup multiplier is 0 at step 0,
where a step moves nothing) with Adam's second moments preset to 1e-4
in both packages: a step from zero moments moves every parameter by
+-lr times the SIGN of its gradient, so a gradient within rounding of
zero could flip an update; with the preset moments the update is smooth
in the gradient and the parameters compare tightly.  The SCST rollouts
are drawn from JAX's noise (``jax.random.categorical`` is
``argmax(logits + gumbel)``).

JAX's gradient is read back from its step: Adam's first moment starts
at zero, so after one update it is 0.1 (clipped gradient + weight decay
* parameter), which the test inverts; the port's is ``.grad`` after
the step (the clipped gradient; torch Adam adds the decay out of place).

Tolerances, set from measurements: the losses and metrics of a step at
rtol 1e-4 / atol 1e-5 (float32 through a BN-trained trunk and a 4-step
recurrence); the gradients per tensor at ||port - JAX|| <= 2e-2 ||JAX||
+ 1e-6 G (G the global gradient norm): against a float64 run of the
port, float32 puts EITHER package's BN-trained trunk gradients up to
~0.7% off (the stem's, BN over 3 images), and some tensors' gradients are
zero but for rounding (a bias that shifts every attention score alike
leaves the softmax unchanged); the parameters after the steps at atol
5e-5 (the largest update is ~1e-3); the BN running statistics at atol
1e-4 / rtol 1e-4; the loss functions at rtol 1e-5 / atol 1e-6; the
schedule at rtol 1e-6.  The clip differs between optax and torch by a
factor of at most 1 + 1e-6 / norm (``train/schedule.py``), far inside
these.
"""

import copy
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scanpaths_tpu.core import config as jconfig
from scanpaths_tpu.core.grid import GridSpec as JGridSpec
from scanpaths_tpu.data import datasets as jdata
from scanpaths_tpu.models.port import export_reference_state_dict
from scanpaths_tpu.models.scanpath_model import create_model
from scanpaths_tpu.train import losses as jl
from scanpaths_tpu.train import steps as jsteps
from scanpaths_tpu.train import trainer as jtrainer
from scanpaths_tpu.train.schedule import lr_multiplier as jlr
from scanpaths_tpu.train.schedule import make_optimizer as jmake
from scanpaths_tpu_torch.core.grid import GridSpec
from scanpaths_tpu_torch.data import datasets as tdata
from scanpaths_tpu_torch.models import port
from scanpaths_tpu_torch.models.scanpath_model import (ScanpathModel,
                                                       init_weights)
from scanpaths_tpu_torch.train import losses as tl
from scanpaths_tpu_torch.train import steps as tsteps
from scanpaths_tpu_torch.train import trainer as ttrainer
from scanpaths_tpu_torch.train.schedule import lr_multiplier as tlr
from scanpaths_tpu_torch.train.schedule import make_optimizer as tmake
from test_torch_eval import _write_split
from test_torch_tasks import (FLAGS, GEOM, _jax_variables, _port_model,
                              write_task_split)

TASKS = ("osie", "air", "coco")
LAYERS = (1, 1, 1, 1)
MH, MW, T = GEOM["map_h"], GEOM["map_w"], GEOM["seq_len"]
A = MH * MW + 1
N = 3
ARGS = types.SimpleNamespace(lr=1e-3, clip=12.5, weight_decay=1e-4,
                             warmup_epoch=1, start_rl_epoch=5, epoch=10,
                             rl_lr_initial_decay=0.5)
STEPS_SUP = STEPS_RL = 4
START = 2          # optimizer step count the steps start from
NU = 1e-4          # Adam's preset second moments
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_RTOL, GRAD_GTOL = 2e-2, 1e-6
PARAM_ATOL = 5e-5
STATS_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
t = torch.from_numpy


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _loss_cases(rng):
    n, tt, a, h, w, k = 3, 5, 7, 6, 8, 4

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)

    def u(lo, hi, *s):
        return rng.uniform(lo, hi, s).astype(np.float32)

    mask = (u(0, 1, n, tt) > 0.3).astype(np.float32)
    mask[:, 0] = 1
    soft = np.exp(f(n, tt, a))
    soft /= soft.sum(-1, keepdims=True)
    qpos = (u(0, 1, n, h, w, k) > 0.7).astype(np.float32)
    qmask = np.array([[1, 1, 0, 0], [1, 0, 0, 0], [1, 1, 1, 0]], np.float32)
    return {
        "cross_entropy_loss": (f(n, tt, a), soft, mask),
        "duration_smooth_l1_loss": (u(0, 3, n, tt), u(0, 3, n, tt), mask),
        "mlp_log_normal_distribution": (f(n, tt), u(0.1, 2, n, tt),
                                        u(0.05, 1, n, tt), mask),
        "mlp_rayleigh_distribution": (u(0.1, 2, n, tt), u(0.05, 1, n, tt),
                                      mask),
        "log_action": (u(0, 1, n, tt), mask),
        "log_duration": (u(0.05, 2, n, tt), f(n, tt), u(0.1, 2, n, tt),
                         mask),
        "nss": (u(0.1, 1, n, h, w), (u(0, 1, n, h, w) > 0.8)
                .astype(np.float32)),
        "cc": (u(0.1, 1, n, h, w), u(0.1, 1, n, h, w)),
        "kld": (u(0.1, 1, n, h, w), u(0.1, 1, n, h, w)),
        "kld_items": (u(0.1, 1, n, h, w), u(0.1, 1, n, h, w)),
        "cc_terms": (u(0.1, 1, n, h, w), u(0.1, 1, n, h, w),
                     np.array([[1, 1], [0, 0], [1, 0]], np.float32),
                     np.array([[1, 0], [1, 1], [0, 0]], np.float32)),
        "cc_match_loss": (f(n), f(n)),
        "kld_visual_linguistic_alignment": (
            f(n, h, w), qpos, qmask, (u(0, 1, n, h, w, k) > 0.7)
            .astype(np.float32), qmask),
        "kld_question_aligment": (f(n, tt, h, w), qpos, qmask, mask),
    }


@pytest.mark.parametrize("name", sorted(_loss_cases(
    np.random.default_rng(0))))
def test_loss_matches_jax(name, rng):
    """Every function of train/losses.py, the five AiR ablation losses
    among them, on the same seeded inputs."""
    args = _loss_cases(rng)[name]
    want = getattr(jl, name)(*(jnp.asarray(a) for a in args))
    got = getattr(tl, name)(*(t(a) for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.isfinite(np.asarray(w)).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **LOSS_TOL)


# ---------------------------------------------------------------------------
# schedule and optimizer
# ---------------------------------------------------------------------------

def test_lr_multiplier_phase_edges():
    """Warmup from 0, its end, the decay to 0 at the RL start (the
    reference's <=), the step down and the RL decay."""
    kw = dict(steps_sup=10, steps_rl=4, warmup_epoch=1, start_rl_epoch=5,
              epochs=10, rl_lr_initial_decay=0.5)
    want = {0: 0.0, 1: 0.1, 9: 0.9, 10: 1.0, 11: 1 - 1 / 40, 30: 0.5,
            49: 1 / 40, 50: 0.0, 51: 0.5 * (1 - 1 / 20), 60: 0.25,
            69: 0.5 / 20, 70: 0.0}
    for it, value in want.items():
        got = tlr(it, **kw)
        np.testing.assert_allclose(got, float(jlr(it, **kw)), rtol=1e-6,
                                   atol=1e-7, err_msg=str(it))
        np.testing.assert_allclose(got, value, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("clip", [0.5, 100.0, 0.0])
def test_optimizer_matches_the_optax_chain(clip, rng):
    """Three updates of a small parameter set, from step 2: the clip
    (active at 0.5, idle at 100, off at 0), the L2 weight decay, Adam
    and the schedule give the optax chain's parameters."""
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    args = copy.copy(ARGS)
    args.clip = clip
    opt = jmake(args, STEPS_SUP, STEPS_RL)
    jp = list(map(jnp.asarray, params))
    state = optax.tree_utils.tree_set(opt.init(jp),
                                      count=jnp.asarray(START, jnp.int32))
    tp = [torch.nn.Parameter(t(p.copy())) for p in params]
    topt, sched = tmake(tp, args, STEPS_SUP, STEPS_RL, step=START)
    for g in grads:
        upd, state = opt.update(list(map(jnp.asarray, g)), state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, gi in zip(tp, g):
            p.grad = t(gi.copy())
        if clip > 0:
            torch.nn.utils.clip_grad_norm_(tp, clip)
        topt.step()
        sched.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)
    assert not np.allclose(tp[0].detach().numpy(), params[0])


# ---------------------------------------------------------------------------
# the supervised batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("blur,clamp", [(None, False), (1.5, False),
                                        (None, True)])
def test_tensorize_scanpath_matches_jax(blur, clamp, rng):
    """Targets, durations and both masks of scanpaths shorter than, as
    long as and longer than T; with ``clamp`` (COCO) also coordinates on
    the frame's far edge."""
    cfg_j = jdata.DataConfig(img_dir="", fix_dir="", action_map=(MH, MW),
                             max_length=T, blur_sigma=blur)
    cfg_t = tdata.DataConfig(img_dir="", fix_dir="", action_map=(MH, MW),
                             max_length=T, blur_sigma=blur)
    for n in (2, T - 1, T, T + 3):
        x = rng.uniform(0, 512, n).astype(np.float32)
        y = rng.uniform(0, 320, n).astype(np.float32)
        if clamp:
            x[0], y[-1] = 512.0, 320.0
        dur = rng.uniform(100, 800, n).astype(np.float32)
        want = jdata.tensorize_scanpath(x, y, dur, (320, 512), cfg_j, clamp)
        got = tdata.tensorize_scanpath(x, y, dur, (320, 512), cfg_t, clamp)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _split(task, tmp_path, rng):
    """A synthetic split of ``task`` and the flags that read it; its name
    (OSIE's and AiR's test split, COCO's validation split)."""
    if task == "osie":
        img_dir, fix_dir = _write_split(tmp_path, rng)
        flags = FLAGS + ["--task", "osie", "--img_dir", img_dir,
                         "--fix_dir", fix_dir]
    else:
        flags = write_task_split(task, tmp_path, rng) + FLAGS
    return jconfig.parse_opt(flags), \
        "validation" if task == "coco" else "test"


def _assert_batches_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "fix_vectors":
            for ga, gb in zip(a[k], b[k]):
                for va, vb in zip(ga, gb):
                    np.testing.assert_array_equal(va, vb)
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("task", TASKS)
def test_supervised_batches_match_jax(task, tmp_path, rng):
    """SupervisedDataset's samples and the Loader's seeded, shuffled,
    drop-last batches over two epochs (and one process's slice of them),
    key by key, against the JAX package's; the SCST batch fields of the
    evaluation view on the device as the JAX trainer feeds them."""
    args, split = _split(task, tmp_path, rng)
    jds = jdata.SupervisedDataset(task, jtrainer.data_config(args), split)
    tds = tdata.SupervisedDataset(task, ttrainer.data_config(args), split)
    assert len(jds) == len(tds) >= 8
    _assert_batches_equal(jdata.collate([jds[3]]), tdata.collate([tds[3]]))
    for kw in (dict(shuffle=True, seed=7, drop_last=True),
               dict(shuffle=True, seed=7, drop_last=True, process_index=1,
                    process_count=2)):
        jl_, tl_ = (jdata.Loader(jds, batch_size=4, **kw),
                    tdata.Loader(tds, batch_size=4, **kw))
        assert len(jl_) == len(tl_) == len(jds) // 4
        for _ in range(2):
            jb, tb = list(jl_), list(tl_)
            assert len(jb) == len(tb) == len(jl_)
            for a, b in zip(jb, tb):
                _assert_batches_equal(a, b)
    batch = tb[0]
    assert set(batch) >= {"images", "scanpaths", "durations", "action_masks",
                          "duration_masks"}
    db = tsteps.device_batch(batch, "cpu", for_rl=False)
    if task == "air":
        assert db["performances"].dtype == torch.float32
    jev = jdata.EvaluationDataset(task, jtrainer.data_config(args), split)
    tev = tdata.EvaluationDataset(task, ttrainer.data_config(args), split)
    jb = next(iter(jdata.Loader(jev, batch_size=2, shuffle=True, seed=1,
                                drop_last=True)))
    tb = next(iter(tdata.Loader(tev, batch_size=2, shuffle=True, seed=1,
                                drop_last=True)))
    _assert_batches_equal(jb, tb)
    db = tsteps.device_batch(tb, "cpu", for_rl=True, ablate_attention=True)
    want = {"images", "gt_fix", "gt_len", "gt_mask"} | (
        {"attention_maps", "gt_performance"} if task == "air" else
        {"attention_maps", "tasks"} if task == "coco" else set())
    assert set(db) == want
    if "attention_maps" in db:
        assert not db["attention_maps"].any()


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def _reference(params, batch_stats, task):
    """export_reference_state_dict at this geometry: the exporter reshapes
    the spatial scoring kernel to the 30x40 map, so it gets a stand-in of
    that size and the real kernel is reshaped here, row-major."""
    p = _np_tree(params)
    att = p["spatial_att"]["att"]["kernel"]
    p["spatial_att"]["att"]["kernel"] = np.zeros((30 * 40, 1), np.float32)
    sd = export_reference_state_dict(p, _np_tree(batch_stats), task)
    sd["spatial_att.spatial_attention.weight"] = att.T.reshape(1, 1, MH, MW)
    return sd


def _port_reference(tm, task, grads=False):
    if grads:
        sd = {n: p.grad for n, p in tm.named_parameters()}
    else:
        sd = tm.state_dict()
    return {k: v.numpy() for k, v in
            port.to_reference_state_dict(sd, task, MH, MW).items()}


def _assert_state(tm, jparams, jstats, task):
    """The port's parameters and BN running statistics against JAX's, in
    the reference's key space."""
    want = _reference(jparams, jstats, task)
    got = _port_reference(tm, task)
    assert set(got) == set(want)
    for k in want:
        tol = STATS_TOL if "running" in k else dict(atol=PARAM_ATOL, rtol=0)
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _jax_grads(jstate, jparams_before):
    """JAX's clipped gradient of the step that made ``jstate``, from
    Adam's first moment (zero before the step): mu / (1 - b1) minus the
    weight decay term."""
    mu = optax.tree_utils.tree_get(jstate.opt_state, "mu")
    return jax.tree.map(lambda m, p: np.asarray(m) / 0.1
                        - ARGS.weight_decay * np.asarray(p), mu,
                        jparams_before)


def _assert_grads(tm, jgrads, jstats, task, grad_norm):
    """The port's gradients (after the step's clip) against JAX's, per
    tensor (GRAD_RTOL, GRAD_GTOL)."""
    want = _reference(jgrads, jstats, task)
    got = _port_reference(tm, task, grads=True)
    assert set(got) <= set(want)
    # the port's norm before the clip, against the norm of JAX's
    # clipped gradient
    np.testing.assert_allclose(
        float(optax.global_norm(jgrads)), min(grad_norm, ARGS.clip),
        **STEP_TOL)
    for k in got:
        err = np.linalg.norm(got[k] - want[k])
        assert err <= GRAD_RTOL * np.linalg.norm(want[k]) \
            + GRAD_GTOL * grad_norm, (k, err, np.linalg.norm(want[k]))


def _states(task, vs, tm):
    """The JAX and port train states at optimizer step START with the
    second moments preset to NU."""
    opt = jmake(ARGS, STEPS_SUP, STEPS_RL)

    def init(params):
        ost = optax.tree_utils.tree_set(opt.init(params),
                                        count=jnp.asarray(START, jnp.int32))
        return optax.tree_utils.tree_set(ost, nu=jax.tree.map(
            lambda x: jnp.full_like(x, NU), params))
    ost = jax.jit(init)(vs["params"])
    jstate = jsteps.TrainState(params=vs["params"],
                               batch_stats=vs["batch_stats"], opt_state=ost,
                               step=jnp.int32(START))
    tstate = tsteps.TrainState.create(tm, ARGS, STEPS_SUP, STEPS_RL,
                                      step=START, device="cpu")
    for st in tstate.optimizer.state.values():
        st["exp_avg_sq"].fill_(NU)
    return opt, jstate, tstate


@functools.lru_cache(maxsize=None)
def _cached_variables(task):
    rng = np.random.default_rng(TASKS.index(task))
    imgs, extra = _inputs(task, rng)
    return _jax_variables(task, rng, imgs, _model_kw(extra), LAYERS)


def _variables(task):
    """The JAX model of ``task`` and a copy of its weights: a flax init
    with the BN statistics and biases randomised, made once per task
    (the supervised and SCST batches share their shapes)."""
    jm, vs = _cached_variables(task)
    return jm, copy.deepcopy(vs)


def _inputs(task, rng):
    imgs = rng.standard_normal((N, 80, 96, 3)).astype(np.float32)
    extra = {}
    if task != "osie":
        extra["attention_maps"] = rng.uniform(0, 1, (N, MH, MW, 1)) \
            .astype(np.float32)
    if task == "coco":
        extra["tasks"] = np.array([5, 2, 5], np.int32)
    return imgs, extra


def _model_kw(batch):
    kw = {}
    if "attention_maps" in batch:
        kw["attention_maps"] = batch["attention_maps"]
    if "tasks" in batch:
        kw["task_ids"] = batch["tasks"]
    return kw


def _supervised_batch(task, rng):
    imgs, extra = _inputs(task, rng)
    cfg = tdata.DataConfig(img_dir="", fix_dir="", action_map=(MH, MW),
                           max_length=T)
    parts = [tdata.tensorize_scanpath(
        rng.uniform(0, 800, n), rng.uniform(0, 600, n),
        rng.uniform(100, 800, n), (600, 800), cfg) for n in (2, T, T + 2)]
    batch = dict(images=imgs, **extra)
    for i, key in enumerate(("scanpaths", "durations", "action_masks",
                             "duration_masks")):
        batch[key] = np.stack([p[i] for p in parts])
    if task == "air":
        batch["performances"] = np.array([1, 0, 1], np.float32)
    return batch


def _jax_supervised_loss(jm, params, batch_stats, batch):
    """The JAX supervised step's loss (steps.supervised_step's loss_fn),
    for its gradients."""
    kw = _model_kw(batch)
    if jm.task == "air":
        kw["performances"] = batch["performances"]
    out, _ = jm.apply({"params": params, "batch_stats": batch_stats},
                      batch["images"], train=True, mutable=["batch_stats"],
                      **kw)
    logits = out["actions"] if jm.task != "air" else out["all_actions_prob"]
    return jl.cross_entropy_loss(logits, batch["scanpaths"],
                                 batch["action_masks"]) \
        + jl.mlp_log_normal_distribution(
            out["log_normal_mu"], out["log_normal_sigma2"],
            batch["durations"], batch["duration_masks"])


@pytest.mark.parametrize("task", TASKS)
def test_supervised_steps_match_jax(task, rng):
    """Two supervised steps from step 2 on one batch, each package from
    the same weights: the loss and its two terms and the global gradient
    norm of each step, the gradients of the first, then the parameters
    and BN running statistics after each step (AiR's per-sample stream
    select by performance, COCO's bank heads by task id)."""
    batch = _supervised_batch(task, rng)
    jm, vs = _variables(task)
    tm = _port_model(task, vs, LAYERS)
    opt, jstate, tstate = _states(task, vs, tm)
    jstep = jax.jit(lambda s, b: jsteps.supervised_step(jm, opt, s, b,
                                                        lambda_1=1.0))
    db = tsteps.device_batch(batch, "cpu", for_rl=False)
    for i in range(2):
        before = jstate
        jstate, jmet = jstep(jstate, batch)
        tmet = tsteps.supervised_step(tstate, db, lambda_1=1.0)
        assert set(tmet) == set(jmet) | {"grad_norm"}
        for k in jmet:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       err_msg=k, **STEP_TOL)
        if i == 0:
            jgrads = _jax_grads(jstate, before.params)
            _assert_grads(tm, jgrads, before.batch_stats, task,
                          float(tmet["grad_norm"]))
        _assert_state(tm, jstate.params, jstate.batch_stats, task)
    assert tstate.step == START + 2
    # the steps moved the parameters and the running statistics
    moved = _reference(jstate.params, jstate.batch_stats, task)
    init = _reference(vs["params"], vs["batch_stats"], task)
    assert not np.allclose(moved["resnet.0.weight"], init["resnet.0.weight"])
    assert not np.allclose(moved["resnet.1.running_var"],
                           init["resnet.1.running_var"])


RL_CASES = [("osie", False), ("air", False), ("air", True), ("coco", False)]


def _rl_batch(task, rng):
    imgs, extra = _inputs(task, rng)
    smax, glen = 3, 6
    gt_fix = np.zeros((N, smax, glen, 3), np.float32)
    gt_fix[..., 0] = rng.uniform(0, 96, (N, smax, glen))
    gt_fix[..., 1] = rng.uniform(0, 80, (N, smax, glen))
    gt_fix[..., 2] = rng.uniform(0.1, 0.5, (N, smax, glen))
    gt_len = rng.integers(2, glen + 1, (N, smax)).astype(np.int32)
    gt_mask = np.ones((N, smax), np.float32)
    gt_mask[1, 2] = 0.0
    batch = dict(images=imgs, gt_fix=gt_fix, gt_len=gt_len, gt_mask=gt_mask,
                 **extra)
    if task == "air":
        batch["gt_performance"] = np.array([[1, 0, 1], [0, 0, 1], [1, 1, 0]],
                                           np.float32)
    return batch


def _jax_noise(task, key, r):
    """The sampler noise of JAX's rl_loss, per stream: R keys from
    fold_in(key, 1) (AiR: fold_in(key, stream index)), each split into
    the categorical's Gumbel draw and the duration's normal draw."""
    out = []
    for si in ((0, 1) if task == "air" else (1,)):
        g, z = [], []
        for k in jax.random.split(jax.random.fold_in(key, si), r):
            k_act, k_dur = jax.random.split(k)
            g.append(np.asarray(jax.random.gumbel(k_act, (N, T, A))))
            z.append(np.asarray(jax.random.normal(k_dur, (N, T))))
        out.append((t(np.stack(g)), t(np.stack(z))))
    return out


@pytest.mark.parametrize("task,apply_cd", RL_CASES)
def test_rl_matches_jax(task, apply_cd, rng):
    """One rl_step from step 2, each package from the same weights and on
    JAX's sampler noise: the loss, every metric key of rl_loss (OSIE's 11
    metrics_for_reward/* among them), the global gradient norm, the
    gradients, then the parameters after the step; the BN running
    statistics do not move."""
    batch = _rl_batch(task, rng)
    jm, vs = _variables(task)
    head = vs["params"]["head"]["drt_layer_2"]
    head["kernel"] = head["kernel"] * np.float32(0.01)
    tm = _port_model(task, vs, LAYERS)
    opt, jstate, tstate = _states(task, vs, tm)
    r = 2
    jgrid = JGridSpec(map_width=MW, map_height=MH, width=96, height=80,
                      max_length=T, min_length=1)
    jcfg = jsteps.RLConfig(task=task, grid=jgrid, rl_sample_number=r,
                           max_symbols_wd=32, apply_cd=apply_cd)
    tcfg = tsteps.RLConfig(task=task, grid=GridSpec(**vars(jgrid)),
                           rl_sample_number=r, max_symbols_wd=32,
                           apply_cd=apply_cd)
    key = jax.random.PRNGKey(3)
    jnew, jmet = jax.jit(lambda s, b: jsteps.rl_step(jm, opt, s, b, key,
                                                     jcfg))(jstate, batch)
    db = tsteps.device_batch(batch, "cpu", for_rl=True)
    tmet = tsteps.rl_step(tstate, db, tcfg, noise=_jax_noise(task, key, r))
    assert set(tmet) == set(jmet) | {"grad_norm"}
    if task == "osie":
        assert sum(k.startswith("metrics_for_reward/") for k in tmet) == 11
    for k in jmet:
        assert np.isfinite(float(jmet[k])), k
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   err_msg=k, **STEP_TOL)
    assert float(jmet["rl_loss"]) != 0.0
    _assert_grads(tm, _jax_grads(jnew, vs["params"]), vs["batch_stats"],
                  task, float(tmet["grad_norm"]))
    _assert_state(tm, jnew.params, jnew.batch_stats, task)
    np.testing.assert_array_equal(
        tm.backbone.bn1.running_var.numpy(),
        np.asarray(vs["batch_stats"]["backbone"]["bn1"]["var"]))


def test_supervised_step_bf16(rng):
    """The bf16 supervised step (bf16 compute, float32 parameters, as
    tests/test_train.py::test_supervised_step_bf16): two steps, finite
    losses, the parameters stay float32 and move."""
    batch = _supervised_batch("osie", rng)
    tm = ScanpathModel("osie", backbone_layers=LAYERS, dtype=torch.bfloat16,
                       **GEOM)
    init_weights(tm, 0)
    before = tm.sal_conv.weight.detach().clone()
    state = tsteps.TrainState.create(tm, ARGS, STEPS_SUP, STEPS_RL,
                                     step=START, device="cpu")
    db = tsteps.device_batch(batch, "cpu", for_rl=False)
    for _ in range(2):
        m = tsteps.supervised_step(state, db, lambda_1=1.0)
        assert all(np.isfinite(float(v)) for v in m.values()), m
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert not torch.equal(tm.sal_conv.weight, before)
    assert all(torch.isfinite(p).all() for p in tm.parameters())
