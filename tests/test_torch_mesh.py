"""Data parallel in the port (``train/mesh.py``) on the CPU over gloo.

Two ranks, spawned processes with one torch thread each, joined by a
``file://`` rendezvous in the module's tmp dir (so test workers never
share a port), run every world-2 case of the module once
(:func:`_rank_main`); a third spawned process runs each port case at
world 1 with no process group (the code path of a single-card run); the
test process computes the JAX side meanwhile and compares.  The cases:

* against the JAX package's mesh, at ``tests/test_mesh.py``'s geometry
  and tolerances (its ``_setup``: OSIE, embed 128, trunk (1,1,1,1), a
  5x6 map, T = 3, N = 8, its optimizer at step 0): the port's world-2
  supervised step on JAX's weights (``models/port.py``) against JAX's
  step on ``make_mesh(8)`` and ``make_mesh(1)``, the loss at rel 2e-5,
  the parameters and BN statistics at rtol 2e-5 / atol 2e-6; the SCST
  step on JAX's noise (drawn for the global batch; each rank keeps its
  rows): ``reward_hmean`` at rel 2e-5, ``rl_loss`` at rel 2e-4, the
  parameters at rtol 5e-5;
* port world 2 against port world 1 for each task (40x48 images, a 5x6
  map, T = 4, embed 64, trunk (1,1,1,1), N = 4), in float64: two
  supervised and two SCST steps from optimizer step 2 with Adam's second
  moments preset (as ``test_torch_train`` does: a first step from zero
  moments moves each parameter by lr times the SIGN of its gradient), the
  rollouts drawn from a generator (the global draw), AiR with its
  Consistency-Divergence term on, COCO's batch holding bank heads that
  only one rank's rows use; every metric, Adam's first moment after each
  kind of step (a running sum of the summed gradients), the parameters,
  the BN running statistics and COCO's bank gradient;
* the joint model's round robin of supervised steps, world 2 against
  world 1, in float64: the idle heads' parameters and both Adam moments
  after the first step, every parameter's after the third;
* whole runs: ``cli.train`` at world 2 against world 1 on
  ``test_torch_trainer``'s tiny argv (``--batch 8``: 4 images a rank;
  ``make_synth_data`` with 4 images a task), one supervised and one SCST
  epoch, then a resume for a third epoch, for ``--task osie`` and
  ``--task joint``: each step's batch (the ranks' slices, concatenated,
  are world 1's batch), the ``learning_rate`` scalars exactly, every
  other training scalar (losses, rewards) at rtol 1e-3
  (test_torch_trainer's whole-run bound), the record, one run dir with
  one checkpoint triad and the ``_supervised_save`` copy, every scalar
  written once.  A fresh run's Adam starts with its second moments preset
  here too: from zero moments the sign-like first steps part the two
  worlds' float32 weights in the last bits, the SCST rollouts' binned
  durations then part, and a reward moved by 1e-3 in a joint run (the
  largest gap with the preset: 4.5e-5, AiR's supervised duration loss).

Every rank-1 array equals rank 0's exactly (the state is replicated), so
only rank 0's leave the ranks.

Why float64 for the world-2 against world-1 step cases: in float32 the
trunk's BN gradients over 4 images at these map sizes are ill-conditioned
(a BN backward subtracts near-equal sums): world 2 parts from world 1
by up to 2e-4 in the gradient norm and by up to 3.4% in single elements
of the stem conv's gradient moments (AiR, COCO), which would hide a real
fault.  In float64 the two
worlds agree to float32 rounding, so a term missed or counted twice
shows at once.  Tolerances, from measurements on this box (the largest
gap in brackets): the metrics at rtol 1e-6 (1.2e-7: some of the metric
path rounds to float32), every array rounded to float32 at rtol 2e-7 /
atol 5e-9 (6.4e-10 on a running mean of 5e-4).  The float32 path is held
to the JAX mesh above and, end to end, by the whole runs.
"""

import json
import multiprocessing
import os
import shutil
import sys
import time
import traceback
import types
from os.path import exists, join
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from scanpaths_tpu_torch.cli import train as tcli_train
from scanpaths_tpu_torch.core.grid import GridSpec
from scanpaths_tpu_torch.models import port
from scanpaths_tpu_torch.models.scanpath_model import (JointScanpathModel,
                                                       ScanpathModel,
                                                       TaskView,
                                                       init_weights)
from scanpaths_tpu_torch.train import mesh, steps

WORLD = 2
WAIT = 600            # s, for the ranks' results
ARGS = types.SimpleNamespace(lr=1e-3, clip=12.5, weight_decay=1e-4,
                             warmup_epoch=1, start_rl_epoch=5, epoch=10,
                             rl_lr_initial_decay=0.5)
# tests/test_mesh.py's geometry
JMH, JMW, JT = 5, 6, 3
JH, JW, JA, JN = 8 * JMH, 8 * JMW, JMH * JMW + 1, 8
# the world-2 against world-1 cases
MH, MW, T, N = 5, 6, 4, 4
H, W = 8 * MH, 8 * MW
A = MH * MW + 1
TASKS = ("osie", "air", "coco")
START, NU = 2, 1e-4
METRIC_TOL = dict(rtol=1e-6, atol=1e-12)
F64_TOL = dict(rtol=2e-7, atol=5e-9)
RUN_RTOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread, as each rank runs: the CPU kernels
    split their sums by thread, so the two sides compare at one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(x):
    """This rank's rows of a global batch array."""
    n = len(x) // mesh.world_size()
    return x[mesh.rank() * n:(mesh.rank() + 1) * n]


def _np(t):
    """A float tensor as float32 numpy (the float64 cases agree far below
    float32's rounding), other tensors as they are."""
    t = t.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy().copy()


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


# ---------------------------------------------------------------------------
# the cases, run on each rank of world 2 and (but for jax_steps) in the
# test process at world 1
# ---------------------------------------------------------------------------

def case_jax_steps(tmp):
    """One supervised and one SCST step of test_mesh.py's setup from
    JAX's weights (each from step 0), on this rank's rows (the test
    process writes JAX's inputs once the ranks have started)."""
    path = join(tmp, "jax_inputs.pt")
    while not exists(path):
        time.sleep(0.05)
    d = torch.load(path, weights_only=False)
    grid = GridSpec(map_width=JMW, map_height=JMH, width=JW, height=JH,
                    max_length=JT, min_length=1)
    cfg = steps.RLConfig(task="osie", grid=grid, rl_sample_number=2,
                         max_symbols_wd=32)
    out = {}
    for kind in ("sup", "rl"):
        model = ScanpathModel("osie", embed=128, seq_len=JT, map_h=JMH,
                              map_w=JMW, backbone_layers=(1, 1, 1, 1))
        model.load_state_dict(d["state_dict"])
        state = steps.TrainState.create(model, ARGS, 4, 4, step=0,
                                        device="cpu")
        batch = {k: _rows(v) for k, v in d[kind].items()}
        if kind == "sup":
            m = steps.supervised_step(
                state, steps.device_batch(batch, "cpu", for_rl=False), 1.0)
        else:
            m = steps.rl_step(state, steps.device_batch(batch, "cpu",
                                                        for_rl=True),
                              cfg, noise=d["noise"])
        out[f"{kind}_metrics"] = _floats(m)
        out[f"{kind}_state"] = {k: _np(v)
                                for k, v in model.state_dict().items()}
    return out


def _task_batches(task, seed):
    """A supervised and an SCST batch of N samples (the global batch)."""
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((N, H, W, 3)).astype(np.float32)
    extra = {}
    if task != "osie":
        extra["attention_maps"] = rng.uniform(0, 1, (N, MH, MW, 1)) \
            .astype(np.float32)
    if task == "coco":
        # bank heads 5 and 7 on one rank each, head 2 on both
        extra["tasks"] = np.array([5, 2, 7, 2], np.int32)
    lens = np.array([2, T, 3, T])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    sup = dict(images=imgs, **extra,
               scanpaths=np.eye(A, dtype=np.float32)[
                   rng.integers(0, A, (N, T))],
               durations=rng.uniform(0.1, 0.8, (N, T)).astype(np.float32),
               action_masks=mask, duration_masks=mask)
    if task == "air":
        sup["performances"] = np.array([1, 0, 0, 1], np.float32)
    smax, glen = 3, 6
    gt_fix = np.zeros((N, smax, glen, 3), np.float32)
    gt_fix[..., 0] = rng.uniform(0, W, (N, smax, glen))
    gt_fix[..., 1] = rng.uniform(0, H, (N, smax, glen))
    gt_fix[..., 2] = rng.uniform(0.1, 0.5, (N, smax, glen))
    gt_mask = np.ones((N, smax), np.float32)
    gt_mask[1, 2] = gt_mask[2, 0] = 0.0
    rl = dict(images=imgs, **extra, gt_fix=gt_fix,
              gt_len=rng.integers(2, glen + 1, (N, smax)).astype(np.int32),
              gt_mask=gt_mask)
    if task == "air":
        rl["gt_performance"] = np.array(
            [[1, 0, 1], [0, 0, 1], [1, 1, 0], [0, 1, 1]], np.float32)
    return sup, rl


def _preset_state(model, steps_sup=4, steps_rl=4):
    state = steps.TrainState.create(model, ARGS, steps_sup, steps_rl,
                                    step=START, device="cpu")
    for st in state.optimizer.state.values():
        st["exp_avg_sq"].fill_(NU)
    return state


def _moments(state, model, key="exp_avg"):
    return {n: _np(state.optimizer.state[p][key])
            for n, p in model.named_parameters()}


def case_task_steps(tmp, task, dtype=torch.float64):
    """Two supervised steps, then two SCST steps (AiR with its CD term),
    on this rank's rows of global batches, in ``dtype``: the metrics of
    each step, Adam's first moment after each kind of step (a running sum
    of the summed gradients), the final state dict and, for COCO, the
    bank's gradient of the last supervised step."""
    model = ScanpathModel(task, backbone_layers=(1, 1, 1, 1), map_h=MH,
                          map_w=MW, seq_len=T, embed=64, dtype=dtype)
    init_weights(model, 0)
    model.to(dtype)
    with torch.no_grad():
        model.head.drt_layer_2.weight.mul_(0.01)
    state = _preset_state(model)
    cfg = steps.RLConfig(task=task, grid=GridSpec(
        map_width=MW, map_height=MH, width=W, height=H, max_length=T,
        min_length=1), rl_sample_number=2, max_symbols_wd=32,
        apply_cd=task == "air")
    gen = torch.Generator().manual_seed(7)
    out = {"metrics": []}
    batches = [_task_batches(task, s) for s in (0, 1)]
    for sup, _ in batches:
        db = steps.device_batch({k: _rows(v) for k, v in sup.items()},
                                "cpu", for_rl=False)
        out["metrics"].append(_floats(steps.supervised_step(state, db,
                                                            1.0)))
    out["sup_moments"] = _moments(state, model)
    if task == "coco":
        out["bank_grad"] = _np(model.conditioner.bank_kernel.grad)
    for _, rl in batches:
        db = steps.device_batch({k: _rows(v) for k, v in rl.items()},
                                "cpu", for_rl=True)
        out["metrics"].append(_floats(steps.rl_step(state, db, cfg,
                                                    generator=gen)))
    out["rl_moments"] = _moments(state, model)
    out["state"] = {k: _np(v) for k, v in model.state_dict().items()}
    return out


def case_joint_steps(tmp, dtype=torch.float64):
    """The joint model's round robin (OSIE, AiR, COCO supervised steps
    through TaskViews over one TrainState), in ``dtype``: the AiR and
    COCO heads' parameters and Adam moments after the first step (where
    they are idle), every parameter's after the third."""
    joint = JointScanpathModel(embed=64, seq_len=T, map_h=MH, map_w=MW,
                               backbone_layers=(1, 1, 1, 1), dtype=dtype)
    init_weights(joint, 0)
    joint.to(dtype)
    state = _preset_state(joint, 12, 12)

    def snapshot(prefixes=("",)):
        return {n: (_np(p), _np(state.optimizer.state[p]["exp_avg"]),
                    _np(state.optimizer.state[p]["exp_avg_sq"]))
                for n, p in joint.named_parameters()
                if n.startswith(prefixes)}
    out = {"metrics": []}
    for i, task in enumerate(TASKS):
        sup, _ = _task_batches(task, 10 + i)
        state.model = TaskView(joint, task)
        db = steps.device_batch({k: _rows(v) for k, v in sup.items()},
                                "cpu", for_rl=False)
        out["metrics"].append(_floats(steps.supervised_step(state, db,
                                                            1.0)))
        if i == 0:
            out["first"] = snapshot(("air.", "coco."))
    out["last"] = snapshot()
    return out


def case_mesh_size(tmp):
    """What --mesh_size this launch takes: 0 and its world size, and the
    message of any other."""
    out = {"ok": [mesh.check_mesh_size(0),
                  mesh.check_mesh_size(mesh.world_size())]}
    try:
        mesh.check_mesh_size(3)
    except ValueError as e:
        out["error"] = str(e)
    return out


def _run_argv(kind, root, log_root):
    """test_torch_trainer.py's tiny argv at --batch 8 (4 images a rank),
    one supervised and one SCST epoch; for the joint run its data root."""
    data = (["--task", "osie", "--img_dir", join(root, "osie", "stimuli"),
             "--fix_dir", join(root, "osie", "fixations"),
             "--eval_repeat_num", "2"] if kind == "osie" else
            ["--task", "joint", "--joint_data_root", root,
             "--eval_repeat_num", "1"])
    return data + [
        "--log_root", log_root, "--height", "40", "--width", "48",
        "--map_height", "5", "--map_width", "6", "--max_length", "4",
        "--embed", "128", "--backbone_layers", "1,1,1,1", "--batch", "8",
        "--rl_sample_number", "2", "--warmup_epoch", "1",
        "--start_rl_epoch", "1", "--epoch", "2", "--device", "cpu",
        "--mesh_size", "0" if mesh.world_size() > 1 else "1"]


def _run_dir(log_root):
    runs = [d for d in os.listdir(log_root)
            if d.startswith("log_") and not d.endswith("_supervised_save")]
    assert len(runs) == 1, runs
    return join(log_root, runs[0])


def _scalars(log_dir):
    """{tag: {step: [values]}} of a run's scalars.jsonl."""
    out = {}
    with open(join(log_dir, "scalars.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            out.setdefault(r["tag"], {}).setdefault(r["step"], []).append(
                r["value"])
    return out


def case_run(tmp, kind):
    """cli.train's run of ``kind`` and its resume for a third epoch; each
    step's batch names in order (this rank's slice), and the run's
    scalars, record, files and log."""
    root = join(tmp, "synth")
    log_root = join(tmp, f"world{mesh.world_size()}", kind)
    names = []
    real = steps.device_batch

    def device_batch(batch, *a, **kw):
        names.append(list(batch["img_names"]))
        return real(batch, *a, **kw)
    argv = _run_argv(kind, root, log_root)
    real_create = steps.TrainState.create.__func__

    def create(cls, *a, opt_state=None, **kw):
        """A fresh run's Adam with its second moments preset (see the
        module docstring)."""
        state = real_create(cls, *a, opt_state=opt_state, **kw)
        if opt_state is None:
            for p in state.model.parameters():
                state.optimizer.state[p] = {
                    "step": torch.tensor(0.0),
                    "exp_avg": torch.zeros_like(p, dtype=getattr(
                        state.optimizer, "mu_dtype", None)),
                    "exp_avg_sq": torch.full_like(p, NU)}
        return state
    # scalars.jsonl alone: importing TensorBoard (it pulls in TensorFlow)
    # would cost each process seconds
    with mock.patch.object(steps, "device_batch", device_batch), \
            mock.patch.object(steps.TrainState, "create",
                              classmethod(create)), \
            mock.patch.dict(sys.modules, {"torch.utils.tensorboard": None}):
        tcli_train.main(argv)
        run = _run_dir(log_root)
        tcli_train.main(argv + ["--resume_dir", run, "--epoch", "3"])
    with open(join(run, "history_record.json")) as f:
        record = json.load(f)
    with open(join(run, "log_train.txt")) as f:
        log = f.read()
    out = dict(names=names, scalars=_scalars(run), record=record,
               runs=sorted(os.listdir(log_root)),
               checkpoints=sorted(os.listdir(join(run, "checkpoints"))),
               saved=exists(join(run + "_supervised_save", "checkpoints",
                                 "checkpoint.pth")),
               args_logged=log.count("The args corresponding"))
    mesh.barrier()      # every rank has read rank 0's files
    if mesh.rank() == 0:
        shutil.rmtree(log_root)
    return out


CASES = [(f"steps_{t}", case_task_steps, (t,)) for t in TASKS] \
    + [("joint_steps", case_joint_steps, ()), ("mesh_size", case_mesh_size,
                                               ())] \
    + [(f"run_{k}", case_run, (k,)) for k in ("osie", "joint")] \
    + [("jax_steps", case_jax_steps, ())]


def _arrays(tree, path=()):
    """(path, array) of every numpy array in a result, in order."""
    if isinstance(tree, np.ndarray):
        yield path, tree
    elif isinstance(tree, dict):
        for k in tree:
            yield from _arrays(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _arrays(v, path + (i,))


def _replica_gaps(out):
    """Rank 0's result as it is; on rank 1 its arrays are replaced by
    their largest gap to rank 0's (broadcast here), so only one copy of
    the replicated state leaves the ranks."""
    gaps = {}
    for path, a in _arrays(out):
        t = torch.from_numpy(np.ascontiguousarray(a))
        ref = t.clone()
        dist.broadcast(ref, 0)
        gaps[path] = float((t.double() - ref.double()).abs().max()) \
            if t.numel() else 0.0
    if dist.get_rank() == 0:
        return out
    return {"gaps": gaps, **{k: v for k, v in out.items()
                             if not any(True for _ in _arrays(v))}}


def _rank_main(who, tmp):
    """Rank ``who`` (0 or 1) of world 2 in the gloo group, or (``who`` =
    "w1") one process with no group: every case in CASES (world 1 leaves
    out the JAX one), each result saved as ``<name>.<who>.pt`` (a
    traceback as ``error.<who>.txt``)."""
    torch.set_num_threads(1)
    if who != "w1":
        dist.init_process_group(
            "gloo", init_method=f"file://{join(tmp, 'pg')}", rank=who,
            world_size=WORLD)
    try:
        for name, fn, extra in CASES:
            if who == "w1" and name == "jax_steps":
                continue
            out = fn(tmp, *extra)
            if who != "w1":
                out = _replica_gaps(out)
            path = join(tmp, f"{name}.{who}.pt")
            torch.save(out, path + ".part")
            os.replace(path + ".part", path)
    except BaseException:
        with open(join(tmp, f"error.{who}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    if who != "w1":
        dist.destroy_process_group()


class Ranks:
    """The spawned processes (the two ranks, then the world-1 process)
    and their results."""

    def __init__(self, tmp, procs):
        self.tmp, self.procs = tmp, procs
        self.started = time.monotonic()
        self.results = {}

    def result(self, name):
        """[rank 0's result of case ``name``, rank 1's (its arrays replaced
        by their gaps to rank 0's, which must be 0: the state is
        replicated)]; each file is read once and removed."""
        if name not in self.results:
            self.results[name] = self._read(name, range(WORLD))
            gaps = self.results[name][1].get("gaps", {})
            assert not any(gaps.values()), \
                {k: v for k, v in gaps.items() if v}
        return self.results[name]

    def world1(self, name):
        """The world-1 process's result of case ``name``."""
        return self._read(name, ("w1",))[0]

    def _read(self, name, who):
        paths = [join(self.tmp, f"{name}.{w}.pt") for w in who]
        while not all(exists(p) for p in paths):
            for w, p in zip((0, 1, "w1"), self.procs):
                if p.exitcode not in (None, 0):
                    err = join(self.tmp, f"error.{w}.txt")
                    text = open(err).read() if exists(err) else ""
                    pytest.fail(f"process {w} exited {p.exitcode}:\n{text}")
            if time.monotonic() - self.started > WAIT:
                pytest.fail(f"no result {name} after {WAIT} s")
            time.sleep(0.05)
        out = [torch.load(p, weights_only=False) for p in paths]
        for p in paths:
            os.remove(p)
        return out


def _jax_setup():
    """tests/test_mesh.py's _setup and its SCST batch, and JAX's sampler
    noise of that test's key for the global batch."""
    import jax
    from test_mesh import _setup

    model, optimizer, state, sup_batch, rng = _setup()
    smax, glen = 3, 6
    gt_fix = np.zeros((JN, smax, glen, 3), np.float32)
    gt_fix[..., 0] = rng.uniform(0, JW, (JN, smax, glen))
    gt_fix[..., 1] = rng.uniform(0, JH, (JN, smax, glen))
    gt_fix[..., 2] = rng.uniform(0.1, 0.5, (JN, smax, glen))
    rl_batch = {
        "images": np.asarray(rng.normal(size=(JN, JH, JW, 3)), np.float32),
        "gt_fix": gt_fix,
        "gt_len": np.full((JN, smax), glen, np.int32),
        "gt_mask": np.ones((JN, smax), np.float32),
    }
    key = jax.random.PRNGKey(3)
    # JAX's rl_loss noise (as test_torch_train._jax_noise): R keys from
    # fold_in(key, 1), each split into the Gumbel and the normal draw
    g, z = [], []
    for k in jax.random.split(jax.random.fold_in(key, 1), 2):
        k_act, k_dur = jax.random.split(k)
        g.append(np.asarray(jax.random.gumbel(k_act, (JN, JT, JA))))
        z.append(np.asarray(jax.random.normal(k_dur, (JN, JT))))
    noise = [(torch.from_numpy(np.stack(g)), torch.from_numpy(np.stack(z)))]
    return model, optimizer, state, sup_batch, rl_batch, key, noise


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The JAX inputs and the synthetic data written, then the two ranks
    and the world-1 process started; they run while the test process
    computes the JAX side."""
    from tools.make_synth_data import make_all
    tmp = str(tmp_path_factory.mktemp("mesh"))
    make_all(join(tmp, "synth"), osie=dict(n_images=4),
             air=dict(n_questions=4), coco=dict(n_images=4))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(who, tmp), daemon=True)
             for who in (0, 1, "w1")]
    for p in procs:
        p.start()
    ranks = Ranks(tmp, procs)
    jax_setup = _jax_setup()
    _, _, state, sup_batch, rl_batch, _, noise = jax_setup
    path = join(tmp, "jax_inputs.pt")
    torch.save({"state_dict": port.from_jax_params(
        _tree(state.params), _tree(state.batch_stats), "osie", JMH, JMW),
        "sup": sup_batch, "rl": rl_batch, "noise": noise}, path + ".part")
    os.replace(path + ".part", path)
    ranks.jax_setup = jax_setup
    yield ranks
    for p in procs:
        p.join(timeout=30)
        if p.is_alive():
            p.terminate()
    shutil.rmtree(tmp, ignore_errors=True)


def _tree(tree):
    import jax
    return jax.tree.map(np.array, tree)


def _close_tree(got, want, label):
    """Every array of a float64 case's result, each side rounded to
    float32, at F64_TOL."""
    got, want = dict(_arrays(got)), dict(_arrays(want))
    assert set(got) == set(want), label
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **F64_TOL,
                                   err_msg=f"{label} {k}")


# ---------------------------------------------------------------------------
# against the JAX package's mesh
# ---------------------------------------------------------------------------

def _jax_results(world2):
    """JAX's supervised and SCST steps of test_mesh.py on make_mesh(1)
    and make_mesh(8), once a module."""
    if hasattr(world2, "jax_results"):
        return world2.jax_results
    import jax
    from scanpaths_tpu.core.grid import GridSpec as JGridSpec
    from scanpaths_tpu.train import steps as jsteps
    from scanpaths_tpu.train.mesh import make_mesh, replicated, shard_batch
    from test_mesh import _run_sup

    model, optimizer, state, sup_batch, rl_batch, key, _ = world2.jax_setup
    cfg = jsteps.RLConfig(task="osie", grid=JGridSpec(
        map_width=JMW, map_height=JMH, width=JW, height=JH, max_length=JT,
        min_length=1), rl_sample_number=2, max_symbols_wd=32)
    out = {}
    for n_dev in (1, 8):
        s_sup, m_sup = _run_sup(model, optimizer, state, sup_batch, n_dev)
        m = make_mesh(n_dev)
        rep = replicated(m)
        rl = jax.jit(lambda s, b: jsteps.rl_step(model, optimizer, s, b,
                                                 key, cfg),
                     in_shardings=(rep, None))
        s_rl, m_rl = rl(jax.device_put(state, rep), shard_batch(m, rl_batch))
        out[n_dev] = {kind: (_floats(met), port.from_jax_params(
            _tree(s.params), _tree(s.batch_stats), "osie", JMH, JMW))
            for kind, (s, met) in (("sup", (s_sup, m_sup)),
                                   ("rl", (s_rl, m_rl)))}
    world2.jax_results = out
    return out


@pytest.mark.parametrize("n_dev", [1, 8])
def test_supervised_step_matches_jax_mesh(world2, n_dev):
    """The port's world-2 supervised step against the JAX step on
    make_mesh(n_dev): loss at rel 2e-5, the parameters and BN statistics
    at rtol 2e-5 / atol 2e-6 (test_mesh.py's bounds)."""
    want_m, want_sd = _jax_results(world2)[n_dev]["sup"]
    res = world2.result("jax_steps")
    for got_m in (r["sup_metrics"] for r in res):
        assert got_m["loss"] == pytest.approx(want_m["loss"], rel=2e-5)
    got_sd = res[0]["sup_state"]
    for k, v in want_sd.items():
        np.testing.assert_allclose(got_sd[k], v.numpy(), rtol=2e-5,
                                   atol=2e-6, err_msg=k)
    # the step moved the BN running statistics
    assert not np.allclose(got_sd["backbone.bn1.running_var"], 1.0)


@pytest.mark.parametrize("n_dev", [1, 8])
def test_rl_step_matches_jax_mesh(world2, n_dev):
    """The port's world-2 SCST step on JAX's noise against the JAX step on
    make_mesh(n_dev): reward_hmean at rel 2e-5, rl_loss at rel 2e-4, the
    parameters at rtol 5e-5 / atol 5e-6 (test_mesh.py's bounds)."""
    want_m, want_sd = _jax_results(world2)[n_dev]["rl"]
    res = world2.result("jax_steps")
    for got_m in (r["rl_metrics"] for r in res):
        assert got_m["reward_hmean"] == pytest.approx(
            want_m["reward_hmean"], rel=2e-5, abs=1e-6)
        assert got_m["rl_loss"] == pytest.approx(want_m["rl_loss"],
                                                 rel=2e-4, abs=1e-5)
    for k, v in want_sd.items():
        np.testing.assert_allclose(res[0]["rl_state"][k], v.numpy(),
                                   rtol=5e-5, atol=5e-6, err_msg=k)
    assert want_m["rl_loss"] != 0.0


# ---------------------------------------------------------------------------
# port world 2 against port world 1
# ---------------------------------------------------------------------------

def _close_metrics(got, want):
    for rank, g in enumerate(got):
        assert len(g["metrics"]) == len(want["metrics"])
        for i, (gm, wm) in enumerate(zip(g["metrics"], want["metrics"])):
            assert set(gm) == set(wm)
            for k in wm:
                np.testing.assert_allclose(gm[k], wm[k], **METRIC_TOL,
                                           err_msg=f"rank {rank} step {i} {k}")


@pytest.mark.parametrize("task", TASKS)
def test_steps_world2_match_world1(world2, task):
    """Two supervised and two SCST steps (AiR with apply_cd, COCO's bank
    heads split over the ranks), each rank on its rows, against the same
    steps in one process: every metric, Adam's first moment after each
    kind of step (the summed gradients), the parameters and the BN
    running statistics; for COCO the bank's gradient."""
    want = world2.world1(f"steps_{task}")
    got = world2.result(f"steps_{task}")
    _close_metrics(got, want)
    for key in ("sup_moments", "rl_moments", "state") + \
            (("bank_grad",) if task == "coco" else ()):
        _close_tree(got[0][key], want[key], key)
    assert want["metrics"][-1]["rl_loss"] != 0.0
    if task == "coco":
        # the gradient reached the bank heads of both ranks' rows alone
        bank = want["bank_grad"]
        used = np.abs(bank).reshape(len(bank), -1).sum(-1) > 0
        assert set(np.flatnonzero(used)) == {2, 5, 7}


def test_joint_steps_world2_match_world1(world2):
    """The joint round robin at world 2 against world 1: the AiR and COCO
    heads' parameters and Adam moments after the first (OSIE) step, where
    they are idle (a zero-filled gradient: decay alone moves them), and
    every parameter's and moment's after the third."""
    want = world2.world1("joint_steps")
    got = world2.result("joint_steps")
    _close_metrics(got, want)
    for when in ("first", "last"):
        _close_tree(got[0][when], want[when], when)
    # the idle AiR head moved by decay, its moments from decay alone
    before = JointScanpathModel(embed=64, seq_len=T, map_h=MH, map_w=MW,
                                backbone_layers=(1, 1, 1, 1))
    init_weights(before, 0)
    p, m, v = want["first"]["air.sal_conv.weight"]
    assert not np.array_equal(p, _np(before.air.sal_conv.weight))
    assert np.abs(m).max() > 0 and np.all(v <= NU)


def test_mesh_size_under_ranks(world2):
    """Under a group of 2 ranks --mesh_size is 0 or 2; another value
    raises, naming the world size."""
    for got in world2.result("mesh_size"):
        assert got["ok"] == [WORLD, WORLD]
        assert "--mesh_size 3 but torchrun launched 2 ranks" in got["error"]


@pytest.mark.parametrize("kind", ["osie", "joint"])
def test_run_world2_matches_world1(world2, kind):
    """cli.train at world 2 and its resume against world 1: the batches,
    the lr scalars exactly, every training scalar at rtol 1e-3, the
    record, one run dir and checkpoint triad, rank 0 alone writing."""
    want = world2.world1(f"run_{kind}")
    got0, got1 = world2.result(f"run_{kind}")
    assert len(got0["names"]) == len(got1["names"]) == len(want["names"])
    for a, b, w in zip(got0["names"], got1["names"], want["names"]):
        assert a + b == w
    # rank 0's files, read on both ranks
    assert got0["scalars"] == got1["scalars"]
    for got in (got0,):
        assert got["record"]["epoch"] == want["record"]["epoch"] == 2
        assert got["record"]["iteration"] == want["record"]["iteration"]
        run, saved = got["runs"]
        assert saved == run + "_supervised_save", got["runs"]
        assert got["checkpoints"] == ["checkpoint.pth",
                                      "checkpoint_best.pth"]
        assert got["saved"] and got["args_logged"] == 2
        scal = got["scalars"]
        assert set(scal) == set(want["scalars"])
        for tag, by_step in want["scalars"].items():
            assert set(scal[tag]) == set(by_step), tag
            for step, vals in by_step.items():
                assert len(scal[tag][step]) == len(vals) == 1, (tag, step)
                if tag == "learning_rate":
                    assert scal[tag][step] == vals, (tag, step)
                elif not (tag.startswith(("perf/", "metrics/"))
                          or tag.split("/", 1)[-1].startswith("metrics/")
                          or tag == "current metric"):
                    np.testing.assert_allclose(
                        scal[tag][step], vals, rtol=RUN_RTOL,
                        equal_nan=True, err_msg=f"{tag} at {step}")
    loss_tag = "loss/loss" if kind == "osie" else "osie/loss/loss"
    assert len(want["scalars"][loss_tag]) > 1


# ---------------------------------------------------------------------------
# the mesh helpers
# ---------------------------------------------------------------------------

def test_helpers_are_the_identity_without_a_group():
    """With no process group every helper returns its input: one process
    runs the code path of a single-card run."""
    assert not mesh.active()
    x = torch.arange(6.0).reshape(2, 3)
    assert mesh.global_sum(x) is x
    assert mesh.all_reduce_with_grad(x) is x
    assert mesh.slice_rows(x, 0) is x
    assert torch.equal(mesh.global_mean(x), x.mean())
    assert mesh.broadcast_str("log_1") == "log_1"
    m = mesh.current("cpu")
    assert (m.rank, m.world, m.backend, m.is_primary) == (0, 1, None, True)


@pytest.mark.parametrize("argv_mesh,error", [
    (2, "launch it under torchrun"), (0, None), (1, None)])
def test_mesh_size_without_torchrun(argv_mesh, error, monkeypatch):
    """Outside torchrun --mesh_size is 0 or 1; 2 raises with the torchrun
    command line."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = types.SimpleNamespace(mesh_size=argv_mesh)
    if error:
        with pytest.raises(ValueError, match=error):
            mesh.make_mesh(args, "cpu")
    else:
        m = mesh.make_mesh(args, "cpu")
        assert (m.world, m.backend, m.owner) == (1, None, False)


@pytest.mark.parametrize("device,cards,local_world,want", [
    ("cpu", 0, 2, ("cpu", "gloo")),
    ("cuda", 1, 2, ("cuda:0", "gloo")),     # two ranks share one card
    ("cuda", 2, 2, ("cuda:1", "nccl")),     # a card each
])
def test_make_mesh_under_torchrun(device, cards, local_world, want,
                                  monkeypatch):
    """Under torchrun's environment (rank 1 of 2): each rank on
    cuda:LOCAL_RANK, NCCL when each rank has its own card, gloo when
    ranks share one or on the CPU; the group initialised from torchrun's
    environment (the call is recorded here, not made)."""
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    calls = []
    with mock.patch.object(torch.cuda, "device_count", lambda: cards), \
            mock.patch.object(torch.cuda, "set_device", lambda d: None), \
            mock.patch.object(dist, "init_process_group",
                              lambda *a, **kw: calls.append((a, kw))):
        m = mesh.make_mesh(types.SimpleNamespace(mesh_size=0), device)
        with pytest.raises(ValueError, match="torchrun launched 2 ranks"):
            mesh.make_mesh(types.SimpleNamespace(mesh_size=4), device)
    assert (str(m.device), m.backend) == want
    assert (m.rank, m.world, m.owner, m.is_primary) == (1, 2, True, False)
    assert calls == [((want[1],), dict(init_method="env://", rank=1,
                                       world_size=2,
                                       timeout=mesh.TIMEOUT))]
