"""The port's joint multi-task model (``models/scanpath_model.py``:
``JointScanpathModel``, ``TaskView``; ``models/port.py``'s joint
carrier and ``.pth`` layout) against the JAX package's, on the CPU, at
``tests/test_joint.py``'s geometry (40x48 images, a 5x6 map, T = 3,
embed 128, trunk (1,1,1,1)) with the kernels' plain versions:

* one trunk and three heads, no head holding a trunk, and JAX's
  parameter count;
* each head's eval forward on JAX's weights (a flax ``init_all`` with
  every BN statistic and affine parameter randomised) against
  ``JointScanpathModel.apply(task=...)``, at ``tests/test_torch_tasks.py``'s
  whole-forward tolerance (atol 2e-4, rtol 1e-4);
* an OSIE loss reaches the trunk and the OSIE head only;
* two OSIE supervised steps through ``TaskView`` against JAX's
  ``supervised_step`` through its ``TaskView`` (test_joint.py's
  optimizer flags and schedule), with and without weight decay: the
  losses, then every parameter and BN statistic of the joint model;
  with decay the AiR and COCO heads move by decay alone, without it they
  stay bit-unchanged.  The steps start at optimizer step 2 with Adam's
  second moments preset to 1e-4 in both packages, as in
  ``tests/test_torch_train.py``: from zero moments an update is about lr
  times the SIGN of the gradient, and a gradient within rounding of zero
  (measured: 3 of the stem's 9408 weights) then moves a parameter by
  +-lr in either package;
* the joint ``.pth`` layout: the whole model round-trips, and a head
  taken out into a single-task ``ScanpathModel`` gives exactly the joint
  head's forward.

Tolerances of the steps, measured on this geometry (the largest gap in
brackets): the losses at rtol 1e-5 (7.9e-7); the parameters and BN
statistics after the steps at rtol 1e-4 / atol 1e-6 (0.30 of that bound,
a layer-4 BN running mean).
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

from scanpaths_tpu.models.scanpath_model import JointScanpathModel as JJoint
from scanpaths_tpu.models.scanpath_model import TaskView as JView
from scanpaths_tpu.train import steps as jsteps
from scanpaths_tpu.train.schedule import make_optimizer as jmake
from scanpaths_tpu_torch.models import port
from scanpaths_tpu_torch.models.scanpath_model import (JointScanpathModel,
                                                       ScanpathModel,
                                                       TaskView)
from scanpaths_tpu_torch.train import steps as tsteps
from test_torch_block import randomize_bn

TASKS = ("osie", "air", "coco")
MH, MW, T, EMBED, LAYERS = 5, 6, 3, 128, (1, 1, 1, 1)
N = 2
START = 2          # optimizer step count the steps start from
NU = 1e-4          # Adam's preset second moments
FWD_TOL = dict(atol=2e-4, rtol=1e-4)
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
t = torch.from_numpy


def _inputs(rng):
    imgs = rng.standard_normal((N, 40, 48, 3)).astype(np.float32)
    att = rng.uniform(0, 1, (N, MH, MW, 1)).astype(np.float32)
    tids = np.array([5, 2], np.int32)
    return imgs, att, tids


@functools.lru_cache(maxsize=None)
def _jax_joint():
    """The JAX joint model and its weights: a flax init_all with the BN
    statistics, affine parameters and the COCO bank's biases
    randomised."""
    rng = np.random.default_rng(0)
    jm = JJoint(seq_len=T, map_h=MH, map_w=MW, embed=EMBED,
                backbone_layers=LAYERS)
    imgs, att, tids = _inputs(rng)
    vs = jax.jit(lambda k: jm.init(k, imgs, att, tids, method="init_all"))(
        jax.random.PRNGKey(0))
    vs = randomize_bn(jax.tree.map(np.array, vs), rng)
    bank = vs["params"]["coco"]["conditioner"]
    bank["bank_bias"] = (rng.standard_normal(bank["bank_bias"].shape)
                         * 0.3).astype(np.float32)
    return jm, vs


def _variables():
    jm, vs = _jax_joint()
    return jm, copy.deepcopy(vs)


def _port_joint(vs):
    tm = JointScanpathModel(embed=EMBED, seq_len=T, map_h=MH, map_w=MW,
                            backbone_layers=LAYERS)
    tm.load_state_dict(port.joint_from_jax_params(
        vs["params"], vs["batch_stats"], MH, MW))
    return tm


def _task_kw(task, att, tids):
    kw = {}
    if task != "osie":
        kw["attention_maps"] = att
    if task == "coco":
        kw["task_ids"] = tids
    return kw


def test_one_trunk_three_heads():
    """The joint model holds one trunk and three heads without one, with
    as many parameters as JAX's init_all makes."""
    _, vs = _jax_joint()
    tm = JointScanpathModel(embed=EMBED, seq_len=T, map_h=MH, map_w=MW,
                            backbone_layers=LAYERS)
    names = [n for n, _ in tm.named_parameters()]
    assert sum(n.startswith("backbone.") for n in names) > 0
    for task in TASKS:
        head = tm.task_head(task)
        assert head.backbone is None
        assert not any(k.startswith("backbone") for k in head.state_dict())
        assert any(n.startswith(f"{task}.") for n in names)
    assert {n.split(".")[0] for n in names} == {"backbone", *TASKS}
    n_jax = sum(np.size(x) for x in jax.tree_util.tree_leaves(vs["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    view = TaskView(tm, "air")
    assert [id(p) for p in view.parameters()] == \
        [id(p) for p in tm.parameters()]
    with pytest.raises(ValueError, match="task"):
        TaskView(tm, "joint")


@pytest.mark.parametrize("task", TASKS)
def test_head_forward_matches_jax(task):
    """Each head's eval forward (the trunk BN-folded, the plain cell) on
    JAX's weights against the JAX joint model's, every output."""
    jm, vs = _jax_joint()
    imgs, att, tids = _inputs(np.random.default_rng(1))
    kw = _task_kw(task, att, tids)
    want = jm.apply(vs, imgs, task=task, **kw)
    view = TaskView(_port_joint(vs), task)
    got = view(t(imgs), *(t(kw[k]) if k in kw else None
                          for k in ("attention_maps", "task_ids")))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **FWD_TOL)


def test_osie_loss_reaches_trunk_and_osie_head_only():
    """test_joint.py::test_joint_gradients_touch_shared_trunk_only_own_head
    on the port: the gradient of an OSIE training loss."""
    _, vs = _jax_joint()
    tm = _port_joint(vs)
    imgs, _, _ = _inputs(np.random.default_rng(0))
    out = TaskView(tm, "osie").forward_train(t(imgs), train=True)
    (out["actions"] ** 2).mean().backward()

    def total(prefix):
        return sum(float(p.grad.abs().sum()) for n, p in
                   tm.named_parameters()
                   if n.startswith(prefix) and p.grad is not None)
    assert total("backbone.") > 0
    assert total("osie.") > 0
    assert total("air.") == 0
    assert total("coco.") == 0


def _supervised_batch(rng):
    imgs, _, _ = _inputs(rng)
    a = MH * MW + 1
    scan = np.zeros((N, T, a), np.float32)
    scan[:, :, 1] = 1.0
    return {"images": imgs, "scanpaths": scan,
            "durations": np.full((N, T), 0.3, np.float32),
            "action_masks": np.ones((N, T), np.float32),
            "duration_masks": np.ones((N, T), np.float32)}


@pytest.mark.parametrize("wd", [5e-4, 0.0])
def test_osie_steps_match_jax(wd):
    """Two OSIE supervised steps through TaskView from JAX's weights, on
    test_joint.py::test_joint_weight_decay_semantics_pinned's optimizer
    (lr 1e-3, warmup 1 of 10 epochs over 10 steps), from step START with
    the second moments preset to NU, against JAX's steps: the losses, then every parameter and BN
    statistic of the joint model (in the joint reference layout); the
    AiR and COCO heads bit-unchanged without decay, moved against the
    sign of each parameter (decay alone) with it."""
    jm, vs = _variables()
    batch = _supervised_batch(np.random.default_rng(2))
    args = types.SimpleNamespace(lr=1e-3, clip=12.5, weight_decay=wd,
                                 warmup_epoch=1, start_rl_epoch=5, epoch=10,
                                 rl_lr_initial_decay=0.5)
    opt = jmake(args, steps_sup=10, steps_rl=10)

    def init(params):
        ost = optax.tree_utils.tree_set(opt.init(params),
                                        count=jnp.asarray(START, jnp.int32))
        return optax.tree_utils.tree_set(ost, nu=jax.tree.map(
            lambda x: jnp.full_like(x, NU), params))
    jstate = jsteps.TrainState(params=vs["params"],
                               batch_stats=vs["batch_stats"],
                               opt_state=jax.jit(init)(vs["params"]),
                               step=jnp.int32(START))
    jview = JView(jm, "osie")
    jstep = jax.jit(lambda s, b: jsteps.supervised_step(jview, opt, s, b,
                                                        lambda_1=1.0))
    tm = _port_joint(vs)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    state = tsteps.TrainState.create(tm, args, 10, 10, step=START,
                                     device="cpu")
    for st in state.optimizer.state.values():
        st["exp_avg_sq"].fill_(NU)
    state.model = TaskView(tm, "osie")
    db = tsteps.device_batch(batch, "cpu", for_rl=False)
    for _ in range(2):
        jstate, jmet = jstep(jstate, batch)
        tmet = tsteps.supervised_step(state, db, lambda_1=1.0)
        for k in jmet:
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
    want = port.to_joint_reference_state_dict(
        port.joint_from_jax_params(_flat_tree(jstate.params),
                                   _flat_tree(jstate.batch_stats), MH, MW),
        MH, MW)
    got = port.to_joint_reference_state_dict(tm.state_dict(), MH, MW)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **PARAM_TOL)
    after = tm.state_dict()
    for task in ("air", "coco"):
        keys = [k for k in after if k.startswith(f"{task}.")]
        if wd == 0.0:
            assert all(torch.equal(after[k], before[k]) for k in keys)
            continue
        d = torch.cat([(after[k] - before[k]).flatten() for k in keys])
        p = torch.cat([before[k].flatten() for k in keys])
        big = p.abs() > 0.05
        assert big.sum() > 100
        assert torch.equal(torch.sign(d[big]), -torch.sign(p[big]))
    # the trunk's running statistics moved with the OSIE batches
    assert not torch.equal(after["backbone.bn1.running_var"],
                           before["backbone.bn1.running_var"])


def _flat_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("task", TASKS)
def test_joint_pth_layout(task, tmp_path):
    """The joint layout: the trunk once under resnet.*, each head under
    <task>.; the whole model round-trips through a .pth, and a head taken
    out into a single-task ScanpathModel gives the joint head's forward
    exactly."""
    _, vs = _jax_joint()
    tm = _port_joint(vs)
    ref = port.to_joint_reference_state_dict(tm.state_dict(), MH, MW)
    assert "resnet.0.weight" in ref and "osie.sal_conv.weight" in ref
    assert not any(k.startswith(f"{t_}.resnet.") for k in ref for t_ in TASKS)
    path = tmp_path / "checkpoint_best.pth"
    torch.save({"model": ref}, path)
    loaded = torch.load(path, weights_only=True)
    back = port.load_joint_reference_state_dict(loaded)
    sd = tm.state_dict()
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd
               if not k.endswith("num_batches_tracked"))
    single = ScanpathModel(task, embed=EMBED, seq_len=T, map_h=MH, map_w=MW,
                           backbone_layers=LAYERS)
    single.load_state_dict(port.load_reference_state_dict(
        port.task_reference_state_dict(loaded, task), task))
    imgs, att, tids = _inputs(np.random.default_rng(3))
    kw = {k: t(v) for k, v in _task_kw(task, att, tids).items()}
    want = tm(t(imgs), task, **kw)
    got = single(t(imgs), **kw)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
