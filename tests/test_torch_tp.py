"""Row-parallel tensor parallelism in the port (``train/tp_step.py``,
``train/mesh.py``'s model group, ``components.tp_row_conv``) on the CPU
over gloo.

Four spawned ranks with one torch thread each, joined by a ``file://``
rendezvous in the module's tmp dir, first form a 2 x 2 mesh (data x
model); then ranks 0 and 1 form a 1 x 2 mesh, while ranks 2 and 3 run
the world-1 side of the port cases with no process group.  The test
process computes the JAX side meanwhile and compares.  The cases:

* against the JAX package's ``make_tp_supervised_step`` and
  ``make_tp_rl_step`` on ``tests/test_tp_shardmap.py``'s geometry (``KW``,
  N = 8, 80x96 images), on JAX's weights (``models/port.py``) and, for
  SCST, JAX's noise (each data shard's draw from its folded key, so the
  port's global draw is their concatenation): two supervised steps
  (against JAX's on its 2 x 2 mesh) and one SCST step on the 1 x 2 and
  the 2 x 2 mesh (the SCST loss on the
  1 x 2 mesh alone: see test_tp_steps_match_jax_tp_steps), at that file's
  tolerances (losses at rel 2e-5, the SCST loss at rel 5e-5 and its
  reward at abs 1e-5, each parameter within 5e-5 + 1e-4 max|leaf|, the
  BN statistics within 1e-5 + 1e-4 max|leaf|);
* the port's 2 x 2 TP state against the port's world 1 for each task,
  in float64 (``tests/test_torch_mesh.py``'s step cases: two supervised
  and two SCST steps from optimizer step 2 with Adam's second moments
  preset, AiR with its CD term): every metric at rtol 1e-6, the gathered
  parameters, BN statistics and Adam's first moments after each kind of
  step at rtol 2e-7 / atol 5e-9 (float32 rounding, as there);
* the global-norm clip binding (clip 1e-3) on the 1 x 2 mesh against
  world 1, in float64: the norm at rtol 1e-12, the parameters and Adam's
  moments as above;
* ``--bf16_moments`` on the 1 x 2 mesh against world 1, in float64: two
  supervised steps, the first moments bfloat16 on both sides (gloo
  all-reduces the bfloat16 slices to gather them), the metrics, moments
  and parameters as above;
* a TP eval forward (``tp_step.gathered``) on the 1 x 2 mesh against the
  JAX package's row-parallel eval forward on a 2 x 2 mesh, at
  ``tests/test_mesh.py``'s bar for it (rtol 1e-4 / atol 1e-5); without
  the gather the cell kernel refuses the slice;
* a TP run's checkpoint (the full reference layout) loaded into a
  world-1 model, and loaded back under TP (the parameters and moments
  sliced as they were);
* ``cli.train --model_parallel 2`` (OSIE and ``--task joint``, each with
  a resume, with ``--ckpt_backend orbax --bf16_moments true`` on both
  sides) on the 1 x 2 mesh against world 1, as
  ``test_torch_mesh.test_run_world2_matches_world1``;
* the refusal of ``--model_parallel 3`` on world 2.
"""

import multiprocessing
import os
import shutil
import time
import traceback
import types
from os.path import exists, join
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_mesh as tmesh
from scanpaths_tpu_torch.cli import train as tcli_train
from scanpaths_tpu_torch.core.grid import GridSpec
from scanpaths_tpu_torch.models import port
from scanpaths_tpu_torch.models.scanpath_model import (ScanpathModel,
                                                       init_weights)
from scanpaths_tpu_torch.train import mesh, steps, tp_step

WAIT = 600            # s, for the ranks' results
# tests/test_tp_shardmap.py's geometry and optimizer
KW = dict(seq_len=3, map_h=10, map_w=12, embed=16,
          backbone_layers=(1, 1, 1, 1))
N, H, W = 8, 80, 96
A = 10 * 12 + 1
JARGS = types.SimpleNamespace(lr=1e-3, clip=12.5, weight_decay=5e-4,
                              warmup_epoch=1, start_rl_epoch=5, epoch=10,
                              rl_lr_initial_decay=0.5)
CLIP = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(x):
    """This data rank's rows of a global batch array."""
    n = len(x) // mesh.data_size()
    return x[mesh.data_index() * n:(mesh.data_index() + 1) * n]


def _full_state(model):
    return {k: tmesh._np(v) for k, v in tp_step.full_state_dict(model).items()}


def _full_moments(state, model, key="exp_avg"):
    """Adam's ``key`` moment of every parameter of ``model``, whole."""
    opt = tp_step.full_optimizer_state(state.optimizer)["state"]
    return {n: tmesh._np(opt[i][key])
            for i, (n, _) in enumerate(model.named_parameters())}


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def _jax_inputs(tmp):
    path = join(tmp, "jax_inputs.pt")
    while not exists(path):
        time.sleep(0.05)
    return torch.load(path, weights_only=False)


def _recording_groups(kinds):
    """dist.all_reduce, recording in ``kinds`` which group each call
    reduces over: the model group, the data group, or the world."""
    real = dist.all_reduce
    layout = mesh._current()

    def all_reduce(tensor, *a, group=None, **kw):
        kinds.add("model" if group is layout.model_group and
                  group is not None else
                  "data" if group is layout.data_group and group is not None
                  else "world")
        return real(tensor, *a, group=group, **kw)
    return mock.patch.object(dist, "all_reduce", all_reduce)


def case_jax_steps(tmp):
    """Two supervised steps, then from the first state one SCST step (on
    the calibrated duration head), on JAX's weights; this data rank's
    rows, the SCST noise of this mesh's data shards; the groups the
    steps' all-reduces went over."""
    d = _jax_inputs(tmp)
    out = {}
    kinds = set()
    with _recording_groups(kinds):
        _jax_steps(d, out)
    out["groups"] = sorted(kinds)
    return out


def _jax_steps(d, out):
    for kind in ("sup", "rl"):
        model = ScanpathModel("osie", **KW)
        model.load_state_dict(d[f"{kind}_sd"])
        state = tp_step.train_state_class().create(model, JARGS, 100, 100,
                                                   step=0, device="cpu")
        if kind == "sup":
            db = steps.device_batch({k: _rows(v) for k, v in d["sup"].items()},
                                    "cpu", for_rl=False)
            metrics = [tmesh._floats(steps.supervised_step(state, db, 1.0))
                       for _ in range(2)]
        else:
            cfg = steps.RLConfig(task="osie", grid=GridSpec(
                map_width=12, map_height=10, width=W, height=H,
                max_length=3, min_length=1), rl_sample_number=2,
                max_symbols_wd=64, max_symbols_wod=8)
            db = steps.device_batch({k: _rows(v) for k, v in d["rl"].items()},
                                    "cpu", for_rl=True)
            metrics = [tmesh._floats(steps.rl_step(
                state, db, cfg, noise=[d["noise"][mesh.data_size()]]))]
        out[f"{kind}_metrics"] = metrics
        out[f"{kind}_state"] = _full_state(model)


def case_task_steps(tmp, task, clip=None, bf16_moments=False):
    """test_torch_mesh's float64 step case on this mesh's state class:
    two supervised steps, then two SCST steps (AiR with its CD term), on
    this data rank's rows; every metric, Adam's first moment after each
    kind of step (and its dtype), the final state, all whole.  With
    ``clip``, one supervised step at that clip; with ``bf16_moments``,
    the two supervised steps alone, the first moment in bfloat16."""
    model = ScanpathModel(task, backbone_layers=(1, 1, 1, 1),
                          map_h=tmesh.MH, map_w=tmesh.MW, seq_len=tmesh.T,
                          embed=64, dtype=torch.float64)
    init_weights(model, 0)
    model.to(torch.float64)
    with torch.no_grad():
        model.head.drt_layer_2.weight.mul_(0.01)
    args = types.SimpleNamespace(**{**vars(tmesh.ARGS),
                                    **({} if clip is None
                                       else {"clip": clip}),
                                    "bf16_moments": bf16_moments})
    state = tp_step.train_state_class().create(model, args, 4, 4,
                                               step=tmesh.START,
                                               device="cpu")
    for st in state.optimizer.state.values():
        st["exp_avg_sq"].fill_(tmesh.NU)
    cfg = steps.RLConfig(task=task, grid=GridSpec(
        map_width=tmesh.MW, map_height=tmesh.MH, width=tmesh.W,
        height=tmesh.H, max_length=tmesh.T, min_length=1),
        rl_sample_number=2, max_symbols_wd=32, apply_cd=task == "air")
    gen = torch.Generator().manual_seed(7)
    out = {"metrics": [], "sliced": sorted(
        n for n, p in model.named_parameters() if tp_step.is_sliced(p))}
    batches = [tmesh._task_batches(task, s) for s in (0, 1)]
    for sup, _ in batches[:1 if clip else 2]:
        db = steps.device_batch({k: _rows(v) for k, v in sup.items()},
                                "cpu", for_rl=False)
        out["metrics"].append(tmesh._floats(steps.supervised_step(state, db,
                                                                  1.0)))
    out["sup_moments"] = _full_moments(state, model)
    out["moment_dtype"] = str(tp_step.full_optimizer_state(
        state.optimizer)["state"][0]["exp_avg"].dtype)
    if clip is None and not bf16_moments:
        for _, rl in batches:
            db = steps.device_batch({k: _rows(v) for k, v in rl.items()},
                                    "cpu", for_rl=True)
            out["metrics"].append(tmesh._floats(steps.rl_step(
                state, db, cfg, generator=gen)))
        out["rl_moments"] = _full_moments(state, model)
    out["state"] = _full_state(model)
    return out


def case_eval_forward(tmp):
    """The eval forward on JAX's weights with the kernels sliced, gathered
    whole for the forward; whether the cell kernel refuses the slice
    without the gather, and the slices after it."""
    d = _jax_inputs(tmp)
    model = ScanpathModel("osie", **KW)
    model.load_state_dict(d["sup_sd"])
    model.eval()
    sliced = sorted(tp_step.shard_model(model))
    images = torch.from_numpy(d["sup"]["images"])
    try:
        model(images)
        refused = False
    except ValueError as e:
        refused = "gather the sliced kernels" in str(e)
    part = model.lstm.gates_h.weight
    with tp_step.gathered(model):
        whole = model.lstm.gates_h.weight.shape
        out = {k: tmesh._np(v) for k, v in model(images).items()}
    return dict(out=out, refused=refused, sliced=sliced,
                whole=tuple(whole), back=model.lstm.gates_h.weight is part)


def case_checkpoint(tmp):
    """One supervised step under TP, the checkpoint pair as end_epoch
    writes it (reference layout, Adam state), loaded into a world-1 model
    and back into a TP state."""
    model = ScanpathModel("osie", **KW)
    init_weights(model, 0)
    state = tp_step.TPTrainState.create(model, JARGS, 100, 100, step=2,
                                        device="cpu")
    d = _jax_inputs(tmp)
    db = steps.device_batch({k: _rows(v) for k, v in d["sup"].items()},
                            "cpu", for_rl=False)
    steps.supervised_step(state, db, 1.0)
    ref = port.to_reference_state_dict(tp_step.full_state_dict(model),
                                       "osie", 10, 12)
    opt = tp_step.full_optimizer_state(state.optimizer)
    # world 1 reads the TP run's checkpoint
    one = ScanpathModel("osie", **KW)
    one.load_state_dict(port.load_reference_state_dict(ref, "osie"))
    gaps = {"world1": max(float((a - b).abs().max()) for a, b in zip(
        one.state_dict().values(), tp_step.full_state_dict(model).values()))}
    # and a TP run resumes from it, sliced as before
    back = ScanpathModel("osie", **KW)
    back.load_state_dict(port.load_reference_state_dict(ref, "osie"))
    st2 = tp_step.TPTrainState.create(back, JARGS, 100, 100, step=3,
                                      device="cpu", opt_state=opt)
    gaps["params"] = max(float((a - b).abs().max()) for a, b in zip(
        back.parameters(), model.parameters()))
    gaps["moments"] = max(
        float((st2.optimizer.state[a][k] - state.optimizer.state[b][k])
              .abs().max())
        for a, b in zip(back.parameters(), model.parameters())
        for k in ("exp_avg", "exp_avg_sq"))
    shapes = [tuple(back.lstm.gates_h.weight.shape),
              tuple(back.xgates.gates_x.weight.shape)]
    return dict(gaps=gaps, shapes=shapes)


def case_run(tmp, kind):
    """test_torch_mesh's whole run and resume with the checkpoints written
    on the writer thread and bfloat16 first moments, under
    --model_parallel 2 when a process group holds two ranks; and the
    saved first moment's dtype after each call."""
    real = tcli_train.main
    dtypes = []

    def main(argv):
        best = real(argv + ["--ckpt_backend", "orbax",
                            "--bf16_moments", "true"]
                    + (["--model_parallel", "2"]
                       if mesh.world_size() > 1 else []))
        run = tmesh._run_dir(argv[argv.index("--log_root") + 1])
        saved = torch.load(join(run, "checkpoints", "checkpoint.pth"),
                           weights_only=True)["optimizer"]["state"]
        dtypes.append(str(saved[0]["exp_avg"].dtype))
        return best
    with mock.patch.object(tcli_train, "main", main):
        out = tmesh.case_run(tmp, kind)
    return {**out, "moment_dtypes": dtypes}


def case_refusal(tmp):
    try:
        mesh.make_mesh(types.SimpleNamespace(mesh_size=0, model_parallel=3),
                       "cpu")
    except ValueError as e:
        return str(e)
    return None


CASES = {
    "jax_steps": (case_jax_steps, ()),
    **{f"steps_{t}": (case_task_steps, (t,)) for t in tmesh.TASKS},
    "clip": (case_task_steps, ("osie", CLIP)),
    "bf16": (case_task_steps, ("osie", None, True)),
    "eval_forward": (case_eval_forward, ()),
    "checkpoint": (case_checkpoint, ()),
    **{f"run_{k}": (case_run, (k,)) for k in ("osie", "joint")},
    "refusal": (case_refusal, ()),
}
# (world, model_parallel, cases) of each mesh the ranks form in turn
# (the cases that wait for the JAX side's inputs come last)
MESHES = [(4, 2, ["steps_osie", "steps_air", "steps_coco", "jax_steps"]),
          (2, 2, ["clip", "bf16", "run_osie", "run_joint", "refusal",
                  "checkpoint", "jax_steps", "eval_forward"])]
# the world-1 cases each rank left out of the last mesh runs
WORLD1 = {2: ["steps_osie", "steps_air", "steps_coco", "clip", "bf16"],
          3: ["run_osie", "run_joint"]}


def _save(tmp, name, tag, out):
    path = join(tmp, f"{name}.{tag}.pt")
    torch.save(out, path + ".part")
    os.replace(path + ".part", path)


def _rank_main(rank, tmp):
    """Rank ``rank`` of each mesh in MESHES that holds it, then its
    WORLD1 cases with no process group; every result saved as
    ``<name>.<world>x<rank>.pt`` (world 1: ``<name>.w1.pt``), a traceback
    as ``error.<rank>.txt``."""
    torch.set_num_threads(1)
    try:
        for i, (world, tp, names) in enumerate(MESHES):
            if rank >= world:
                continue
            dist.init_process_group(
                "gloo", init_method=f"file://{join(tmp, f'pg{i}')}",
                rank=rank, world_size=world)
            mesh.set_model_parallel(tp)
            for name in names:
                fn, extra = CASES[name]
                out = fn(tmp, *extra)
                if name != "refusal":
                    out = tmesh._replica_gaps(out)
                _save(tmp, name, f"{world}x{rank}", out)
            dist.destroy_process_group()
        for name in WORLD1.get(rank, ()):
            fn, extra = CASES[name]
            _save(tmp, name, "w1", fn(tmp, *extra))
    except BaseException:
        with open(join(tmp, f"error.{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


class Ranks:
    def __init__(self, tmp):
        ctx = multiprocessing.get_context("spawn")
        self.tmp = tmp
        self.procs = [ctx.Process(target=_rank_main, args=(r, tmp),
                                  daemon=True) for r in range(4)]
        for p in self.procs:
            p.start()
        self.started = time.monotonic()

    def read(self, name, tags):
        """The results ``<name>.<tag>.pt`` of ``tags``, each read once and
        removed; a rank that ends in a fault fails the test."""
        paths = [join(self.tmp, f"{name}.{t}.pt") for t in tags]
        while not all(exists(p) for p in paths):
            for r, p in enumerate(self.procs):
                if p.exitcode not in (None, 0):
                    err = join(self.tmp, f"error.{r}.txt")
                    text = open(err).read() if exists(err) else ""
                    pytest.fail(f"rank {r} exited {p.exitcode}:\n{text}")
            if time.monotonic() - self.started > WAIT:
                pytest.fail(f"no result {name} after {WAIT} s")
            time.sleep(0.05)
        out = [torch.load(p, weights_only=False) for p in paths]
        for p in paths:
            os.remove(p)
        return out

    def mesh(self, name, world):
        """Every rank's result of ``name`` on the mesh of ``world`` ranks;
        the others' replicated arrays must equal rank 0's."""
        res = self.read(name, [f"{world}x{r}" for r in range(world)])
        for r in res[1:]:
            gaps = r.get("gaps", {})
            assert not any(gaps.values()), \
                {k: v for k, v in gaps.items() if v}
        return res


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------

def _tree(tree):
    import jax
    return jax.tree.map(np.array, tree)


def _jax_noise(key, d):
    """JAX's SCST noise for N rows split into ``d`` data shards, each
    shard's from its folded key (make_tp_rl_step), concatenated: [R, N,
    ...]."""
    import jax
    g, z = [], []
    for i in range(d):
        k_shard = jax.random.fold_in(key, i)
        gs, zs = [], []
        for k in jax.random.split(jax.random.fold_in(k_shard, 1), 2):
            k_act, k_dur = jax.random.split(k)
            gs.append(np.asarray(jax.random.gumbel(k_act, (N // d, 3, A))))
            zs.append(np.asarray(jax.random.normal(k_dur, (N // d, 3))))
        g.append(np.stack(gs))
        z.append(np.stack(zs))
    return (torch.from_numpy(np.concatenate(g, 1)),
            torch.from_numpy(np.concatenate(z, 1)))


def _jax_setup(tmp):
    """test_tp_shardmap.py's weights, batches and key, test_mesh.py's
    setup for the eval forward; the port's inputs written for the ranks."""
    import bench
    import jax
    import jax.numpy as jnp
    from scanpaths_tpu.models.scanpath_model import create_model
    from test_tp_shardmap import _batch

    rng = np.random.default_rng(0)
    sup = _batch(rng)
    plain = create_model("osie", **KW)
    variables = _tree(jax.jit(lambda k, x: plain.init(k, x, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(sup["images"])))
    rng = np.random.default_rng(1)
    smax, glen = 3, 4
    gt_fix = np.zeros((N, smax, glen, 3), np.float32)
    gt_fix[..., 0] = rng.uniform(0, W, (N, smax, glen))
    gt_fix[..., 1] = rng.uniform(0, H, (N, smax, glen))
    gt_fix[..., 2] = rng.uniform(0.1, 0.5, (N, smax, glen))
    rl = {"images": rng.normal(size=(N, H, W, 3)).astype(np.float32),
          "gt_fix": gt_fix, "gt_len": np.full((N, smax), glen, np.int32),
          "gt_mask": np.ones((N, smax), np.float32)}
    calibrated = _tree(bench.calibrate_duration_head(variables))
    key = jax.random.PRNGKey(7)
    inputs = {
        "sup": sup, "rl": rl,
        "sup_sd": port.from_jax_params(variables["params"],
                                       variables["batch_stats"], "osie",
                                       10, 12),
        "rl_sd": port.from_jax_params(calibrated["params"],
                                      calibrated["batch_stats"], "osie",
                                      10, 12),
        "noise": {d: _jax_noise(key, d) for d in (1, 2)}}
    path = join(tmp, "jax_inputs.pt")
    torch.save(inputs, path + ".part")
    os.replace(path + ".part", path)
    return dict(sup=sup, rl=rl, variables=variables, calibrated=calibrated,
                key=key, sup_sd=inputs["sup_sd"])


def _jax_tp_steps(js, n_dev, kinds=("sup", "rl")):
    """JAX's TP supervised steps (two) and SCST step on make_mesh(n_dev,
    model_parallel=2), of ``kinds``: (metrics, the port's state dict) of
    each."""
    import jax
    import jax.numpy as jnp
    from scanpaths_tpu.core.grid import GridSpec as JGridSpec
    from scanpaths_tpu.models.scanpath_model import create_model
    from scanpaths_tpu.train import steps as jsteps
    from scanpaths_tpu.train.mesh import make_mesh
    from scanpaths_tpu.train.schedule import make_optimizer
    from scanpaths_tpu.train.tp_step import (make_tp_rl_step,
                                             make_tp_supervised_step,
                                             tp_state_sharding)
    optimizer = make_optimizer(JARGS, steps_sup=100, steps_rl=100)
    tp_model = create_model("osie", tp_axis="model", bn_axis="data",
                            tp_shards=2, **KW)
    jmesh = make_mesh(n_dev, model_parallel=2)
    out = {}
    for kind in kinds:
        v = js["variables" if kind == "sup" else "calibrated"]
        state = jsteps.TrainState(
            params=jax.tree.map(jnp.asarray, v["params"]),
            batch_stats=jax.tree.map(jnp.asarray, v["batch_stats"]),
            opt_state=optimizer.init(v["params"]), step=jnp.int32(0))
        if kind == "sup":
            step, sh = make_tp_supervised_step(
                tp_model, optimizer, jmesh, state, lambda_1=1.0,
                batch_keys=tuple(js["sup"]))
            st = jax.device_put(state, sh)
            metrics = []
            for _ in range(2):
                st, m = step(st, js["sup"])
                metrics.append({k: float(x) for k, x in m.items()})
        else:
            cfg = jsteps.RLConfig(task="osie", grid=JGridSpec(
                map_width=12, map_height=10, width=W, height=H,
                max_length=3, min_length=1), rl_sample_number=2,
                max_symbols_wd=64, max_symbols_wod=8)
            step = make_tp_rl_step(tp_model, optimizer, jmesh, state, cfg)
            st = jax.device_put(state, tp_state_sharding(jmesh, state))
            st, m = step(st, js["rl"], js["key"])
            metrics = [{k: float(x) for k, x in m.items()}]
        st = jax.device_get(st)
        out[kind] = (metrics, port.from_jax_params(
            _tree(st.params), _tree(st.batch_stats), "osie", 10, 12))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from tools.make_synth_data import make_all
    tmp = str(tmp_path_factory.mktemp("tp"))
    make_all(join(tmp, "synth"), osie=dict(n_images=4),
             air=dict(n_questions=4), coco=dict(n_images=4))
    r = Ranks(tmp)
    r.jax = _jax_setup(tmp)
    r.jax_steps = {}
    yield r
    for p in r.procs:
        p.join(timeout=30)
        if p.is_alive():
            p.terminate()
    shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# against the JAX package's TP steps and eval forward
# ---------------------------------------------------------------------------

def _close_leaves(got, want, atol, label):
    for k, v in want.items():
        v = v.numpy()
        d = float(np.abs(got[k] - v).max())
        m = float(np.abs(v).max())
        assert d <= atol + 1e-4 * m, (label, k, d, m)


@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "2x2"])
def test_tp_steps_match_jax_tp_steps(ranks, world):
    """The port's TP supervised and SCST steps on a (world / 2) x 2 mesh
    against JAX's make_tp_supervised_step (on its 2 x 2 mesh) and
    make_tp_rl_step on the same mesh, at tests/test_tp_shardmap.py's
    tolerances.  JAX's shard_map
    SCST step normalises each data shard's REINFORCE terms by that shard's
    own mask sums (its pinned reference is the sum of per-chunk
    ``rl_loss`` programs), while the port's steps normalise by the global
    batch's, as the JAX mesh ``rl_step`` and the port's data parallel do;
    so on the 2 x 2 mesh ``rl_loss`` is held to world 1
    (test_tp_state_matches_world1) and to JAX's TP step only through the
    rewards, the rollouts' share and the parameters."""
    # the supervised step is JAX's on its 2 x 2 mesh for both meshes (the
    # same global-batch program; one compile fewer)
    for n_dev, kinds in ((4, ("sup", "rl")), (world, ("rl",))):
        if (n_dev, kinds[-1]) not in ranks.jax_steps:
            for kind, v in _jax_tp_steps(ranks.jax, n_dev, kinds).items():
                ranks.jax_steps[n_dev, kind] = v
    want = {"sup": ranks.jax_steps[4, "sup"],
            "rl": ranks.jax_steps[world, "rl"]}
    got = ranks.mesh("jax_steps", world)
    for r in got:
        for g, w in zip(r["sup_metrics"], want["sup"][0]):
            for k in ("loss", "loss_actions", "loss_duration"):
                assert abs(g[k] - w[k]) <= 2e-5 * max(abs(w[k]), 1.0), k
        (g,), (w,) = r["rl_metrics"], want["rl"][0]
        if world == 2:
            # one data shard: JAX's shard-normalised loss is the global one
            assert abs(g["rl_loss"] - w["rl_loss"]) <= \
                5e-5 * max(abs(w["rl_loss"]), 1.0)
        assert abs(g["reward_hmean"] - w["reward_hmean"]) <= 1e-5
        assert g["rollout_ok_frac"] > 0.0
    for kind in ("sup", "rl"):
        sd = got[0][f"{kind}_state"]
        params = {k: v for k, v in want[kind][1].items()
                  if "running" not in k}
        stats = {k: v for k, v in want[kind][1].items() if "running" in k}
        _close_leaves(sd, params, 5e-5, kind)
        _close_leaves(sd, stats, 1e-5, kind)
    # the model group carries the f/g pair and the clip; BN, the
    # gradients and the metrics reduce over the data group alone (none on
    # one data rank): no all-reduce spans the world
    for r in got:
        assert r["groups"] == (["model"] if world == 2
                               else ["data", "model"]), r["groups"]
    # the second supervised step moved the sliced kernels
    for name in ("lstm.gates_h.weight", "xgates.gates_x.weight"):
        assert not np.allclose(got[0]["sup_state"][name],
                               ranks.jax["sup_sd"][name].numpy())


def test_tp_eval_forward_matches_jax_row_parallel(ranks):
    """The TP eval forward (the sliced kernels gathered whole) against
    the JAX package's row-parallel eval forward on a 2 x 2 mesh (its
    kernels contraction-sharded, tests/test_mesh.py's
    test_tp_eval_forward_row_parallel_matches_replicated), at that test's
    bar; the cell kernel refuses a slice, and the slices are back after
    the forward."""
    import jax
    from scanpaths_tpu.models.scanpath_model import create_model
    from scanpaths_tpu.train.mesh import (batch_sharding, make_mesh,
                                          state_sharding)
    model = create_model("osie", **KW)
    variables = ranks.jax["variables"]
    jmesh = make_mesh(4, model_parallel=2)
    v = jax.device_put(variables, state_sharding(jmesh, variables))
    img = jax.device_put(ranks.jax["sup"]["images"], batch_sharding(jmesh))
    want = _tree(jax.jit(lambda vv, ii: model.apply(vv, ii, train=False))(
        v, img))
    got = ranks.mesh("eval_forward", 2)
    r = got[0]
    assert r["refused"] and r["back"]
    assert r["sliced"] == ["lstm.gates_h.weight", "xgates.gates_x.weight"]
    assert r["whole"][1] == KW["embed"]
    for k in want:
        np.testing.assert_allclose(r["out"][k].astype(np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# against the port's world 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", tmesh.TASKS)
def test_tp_state_matches_world1(ranks, task):
    """The 2 x 2 TP steps (two supervised, two SCST) against world 1 in
    float64: every metric, the gathered parameters and BN statistics and
    Adam's first moments after each kind of step; the TP state sliced the
    two decode kernels."""
    (want,) = ranks.read(f"steps_{task}", ["w1"])
    got = ranks.mesh(f"steps_{task}", 4)
    tmesh._close_metrics(got, want)
    assert got[0]["sliced"] == ["lstm.gates_h.weight",
                                "xgates.gates_x.weight"]
    assert want["sliced"] == []
    for key in ("sup_moments", "rl_moments", "state"):
        tmesh._close_tree(got[0][key], want[key], key)
    assert want["metrics"][-1]["rl_loss"] != 0.0


def test_tp_clip_matches_world1(ranks):
    """A supervised step whose clip binds (clip 1e-3) on the 1 x 2 mesh
    against world 1 in float64: the global norm (the sliced kernels'
    squares summed over the model group) at rtol 1e-12, the clipped
    update's parameters and Adam's moments."""
    (want,) = ranks.read("clip", ["w1"])
    got = ranks.mesh("clip", 2)
    norm = want["metrics"][0]["grad_norm"]
    assert norm > 100 * CLIP
    for r in got:
        assert r["metrics"][0]["grad_norm"] == pytest.approx(norm,
                                                             rel=1e-12)
    for key in ("sup_moments", "state"):
        tmesh._close_tree(got[0][key], want[key], key)


def test_tp_bf16_moments_match_world1(ranks):
    """--bf16_moments under TP: two supervised steps on the 1 x 2 mesh
    against world 1 in float64, the first moments gathered whole in
    bfloat16 (gloo all-reduces the bfloat16 slices): every metric, the
    moments and the parameters."""
    (want,) = ranks.read("bf16", ["w1"])
    got = ranks.mesh("bf16", 2)
    tmesh._close_metrics(got, want)
    for r in (*got, want):
        assert r["moment_dtype"] == "torch.bfloat16"
    for key in ("sup_moments", "state"):
        tmesh._close_tree(got[0][key], want[key], key)


def test_tp_checkpoint_loads_into_world1_and_back(ranks):
    """A TP run's checkpoint (reference layout, gathered whole) loads
    into a world-1 model exactly, and a TP resume slices it back: the
    same parameters and Adam moments as before the save."""
    for r in ranks.mesh("checkpoint", 2):
        assert r["gaps"] == {"world1": 0.0, "params": 0.0, "moments": 0.0}
        assert r["shapes"] == [(64, 8, 3, 3), (64, 8, 3, 3)]


@pytest.mark.parametrize("kind", ["osie", "joint"])
def test_run_under_tp_matches_world1(ranks, kind):
    """cli.train --model_parallel 2 (a 1 x 2 mesh) and its resume
    against world 1, both with the async checkpoint writer and bfloat16
    first moments: both ranks step on every row, the lr scalars
    exactly, every training scalar at rtol 1e-3, the record, one run dir
    and checkpoint triad (its first moment bfloat16), rank 0 alone
    writing."""
    (want,) = ranks.read(f"run_{kind}", ["w1"])
    got0, got1 = ranks.mesh(f"run_{kind}", 2)
    assert got0["names"] == got1["names"] == want["names"]
    assert got0["scalars"] == got1["scalars"]
    assert got0["record"]["epoch"] == want["record"]["epoch"] == 2
    assert got0["record"]["iteration"] == want["record"]["iteration"]
    run, saved = got0["runs"]
    assert saved == run + "_supervised_save"
    assert got0["checkpoints"] == ["checkpoint.pth", "checkpoint_best.pth"]
    assert got0["saved"] and got0["args_logged"] == 2
    assert got0["moment_dtypes"] == want["moment_dtypes"] == \
        ["torch.bfloat16"] * 2
    scal = got0["scalars"]
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
                    scal[tag][step], vals, rtol=tmesh.RUN_RTOL,
                    equal_nan=True, err_msg=f"{tag} at {step}")


def test_model_parallel_must_divide_the_world(ranks):
    """--model_parallel 3 on a world of 2 raises, with the numbers."""
    for msg in ranks.read("refusal", ["2x0", "2x1"]):
        assert "--model_parallel 3 does not divide the 2 rank(s)" in msg
