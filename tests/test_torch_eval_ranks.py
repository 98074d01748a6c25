"""Evaluation over ranks in the port (``train/mesh.py``,
``EvalCore.evaluate``, ``metrics/device_eval.py``, ``cli/test.py``) on
the CPU over gloo, against one process.

Two ranks, spawned processes with one torch thread each, joined by a
``file://`` rendezvous in the module's tmp dir, run every case of the
module once (:func:`_rank_main`); the test process runs each case at
world 1 with no process group (the code path of a single-card run)
meanwhile, and compares.  The data are ``tools/make_synth_data``'s
(9 OSIE images a split, 5 AiR questions and 5 COCO images): at batch 4
each split ends in a partial batch that every rank loads whole and only
rank 0 counts.  The cases, in float64 (the kernels' eval forward takes
float32 and bfloat16, so the float64 cases run the model's stock-op
forward in eval mode, ``forward_train(train=False)``, which the kernels
are held to elsewhere):

* ``EvalCore.evaluate`` for OSIE, AiR (both streams, the answer buckets)
  and COCO, with the device sweep and with the host suite, and the human
  baseline both ways: the metrics and stds at rtol 1e-12, the prediction
  records equal and in the same order;
* ``cli/test.py`` under two ranks against one process, on a run dir in
  ``cli/train.py``'s layout (hparams.json and
  checkpoints/checkpoint_best.pth in the reference layout): a single-task
  OSIE run with the device sweep, and the AiR head of a joint run with
  the host suite: the metric tree and the prediction JSON;
* ``cli/train.py`` at world 2 against world 1 (a supervised and an SCST
  epoch, the human baseline and a validation after each on the device
  sweep): every validation
  scalar and the selection metric at rtol 1e-9, the record equal.

And in the test process alone: a world-1 process group calls no
collective in the steps, the evaluation and the human baseline.
"""

import contextlib
import json
import logging
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

from scanpaths_tpu_torch.cli import test as tcli_test
from scanpaths_tpu_torch.cli import train as tcli_train
from scanpaths_tpu_torch.core import config as tconfig
from scanpaths_tpu_torch.data.datasets import EvaluationDataset, Loader
from scanpaths_tpu_torch.models import port
from scanpaths_tpu_torch.models.scanpath_model import (JointScanpathModel,
                                                       ScanpathModel,
                                                       init_weights)
from scanpaths_tpu_torch.serve import predictor as tpredictor
from scanpaths_tpu_torch.train import joint as tjoint
from scanpaths_tpu_torch.train import mesh, steps
from scanpaths_tpu_torch.train import trainer as ttrainer

WORLD = 2
WAIT = 300            # s, for the ranks' results
TASKS = ("osie", "air", "coco")
MH, MW, T = 5, 6, 4
FLAGS = ["--height", "40", "--width", "48", "--map_height", str(MH),
         "--map_width", str(MW), "--max_length", str(T), "--embed", "64",
         "--backbone_layers", "1,1,1,1", "--batch", "4",
         "--eval_repeat_num", "2", "--seed", "3"]
METRIC_RTOL = 1e-12
RUN_RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread, as each rank runs: the CPU kernels
    split their sums by thread, so the two sides compare at one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# float64 stand-ins for the eval forward and the model of the flags
# ---------------------------------------------------------------------------

def forward64(self, batch):
    """EvalCore.forward in float64: the stock-op forward in eval mode."""
    def dev(a):
        return None if a is None else torch.from_numpy(np.asarray(a))
    with torch.no_grad():
        return self.model.forward_train(
            dev(batch["images"]).double(), dev(batch.get("attention_maps")),
            dev(batch.get("tasks")), train=False)


def model64(args):
    """models.scanpath_model.model_from_flags in float64."""
    kw = dict(embed=args.embed, seq_len=args.max_length,
              map_h=args.map_height, map_w=args.map_width,
              backbone_layers=tuple(int(v) for v in
                                    args.backbone_layers.split(",")),
              dtype=torch.float64)
    model = (JointScanpathModel(**kw) if args.task == "joint"
             else ScanpathModel(args.task, **kw))
    return model.double()


def init64(model, seed):
    """init_weights, the duration heads scaled by 0.01 (the seed heads'
    LogNormal scale gives durations far past a split's)."""
    init_weights(model, seed)
    heads = ([model.task_head(t) for t in TASKS]
             if isinstance(model, JointScanpathModel) else [model])
    with torch.no_grad():
        for head in heads:
            head.head.drt_layer_2.weight.mul_(0.01)


@contextlib.contextmanager
def _no_tensorboard():
    """scalars.jsonl alone: importing TensorBoard (it pulls in TensorFlow)
    would cost each process seconds.  Only that module's entry is set and
    restored (restoring all of sys.modules would drop the modules the block
    imported, and a second import of some re-registers torch ops)."""
    name = "torch.utils.tensorboard"
    had, old = name in sys.modules, sys.modules.get(name)
    sys.modules[name] = None
    try:
        yield
    finally:
        if had:
            sys.modules[name] = old
        else:
            del sys.modules[name]


def _float64():
    return (mock.patch.object(ttrainer.EvalCore, "forward", forward64),
            mock.patch.object(tpredictor, "model_from_flags", model64),
            mock.patch.object(ttrainer, "model_from_flags", model64),
            mock.patch.object(ttrainer, "init_weights", init64))


class Core(ttrainer.EvalCore):
    """An EvalCore over a float64 model from seed 0 on the CPU."""

    def __init__(self, args):
        self.args, self.task = args, args.task
        self.grid = ttrainer.grid_spec(args)
        self.device = torch.device("cpu")
        self.model = model64(args)
        init64(self.model, 0)
        self.generator = torch.Generator().manual_seed(5)
        self.logger = logging.getLogger("eval_ranks")
        self.logger.addHandler(logging.NullHandler())
        self.logger.propagate = False

    forward = forward64


def _args(tmp, task):
    return tconfig.parse_opt(["--task", task, "--joint_data_root",
                              join(tmp, "synth")] + FLAGS)


def _loader(args):
    split = "validation" if args.task == "coco" else "test"
    return Loader(EvaluationDataset(args.task,
                                    tjoint.task_data_config(args, args.task),
                                    split=split),
                  batch_size=args.batch, **ttrainer.rank_slice())


def _record(batch, flag, r, preds):
    return [(batch["img_names"][i], flag, r, p.tolist())
            for i, p in enumerate(preds)]


# ---------------------------------------------------------------------------
# the cases, run on each rank of world 2 and in the test process at world 1
# ---------------------------------------------------------------------------

def case_evaluate(tmp, task):
    """EvalCore.evaluate with the device sweep and with the host suite,
    then the human baseline both ways, on the task's evaluation split."""
    args = _args(tmp, task)
    core = Core(args)
    out = {}
    for device_eval in (True, False):
        metrics, stds, records = core.evaluate(_loader(args), device_eval,
                                               record=_record)
        out[device_eval] = dict(
            metrics=metrics, stds=stds, records=records,
            human=core.human_metrics(_loader(args), device_eval))
    return out


def _cli_argv(tmp, kind, run):
    if kind == "osie":
        data = ["--task", "osie", "--img_dir",
                join(tmp, "synth", "osie", "stimuli"), "--fix_dir",
                join(tmp, "synth", "osie", "fixations"), "--device_eval",
                "true"]
    else:
        data = ["--task", "air", "--img_dir",
                join(tmp, "synth", "air", "stimuli"), "--att_dir",
                join(tmp, "synth", "air", "attention"), "--fix_dir",
                join(tmp, "synth", "air", "fixations"), "--device_eval",
                "false"]
    return data + FLAGS + ["--evaluation_dir", run, "--device", "cpu",
                           "--mesh_size", "0"]


def case_cli_test(tmp, kind):
    """cli/test.py on a copy of the ``kind`` run dir: its metric tree,
    prediction JSON and whether rank 0 alone wrote them."""
    run = join(tmp, f"world{mesh.world_size()}", kind)
    if mesh.rank() == 0:
        shutil.copytree(join(tmp, f"run_{kind}"), run)
    mesh.barrier()
    patches = _float64()
    with patches[0], patches[1]:
        metrics = tcli_test.main(_cli_argv(tmp, kind, run))
    split = "test"
    with open(join(run, f"{split}_predicts.json")) as f:
        records = json.load(f)
    with open(join(run, "log_test.txt")) as f:
        log = f.read()
    mesh.barrier()
    return dict(metrics=metrics, records=records,
                tables=log.count("The metrics for best model"))


def case_train(tmp):
    """cli/train.py's OSIE run (--batch 8: 4 rows a rank; a supervised
    and an SCST epoch, the device sweep): its scalars and record."""
    log_root = join(tmp, f"world{mesh.world_size()}", "train")
    argv = ["--task", "osie", "--img_dir",
            join(tmp, "synth", "osie", "stimuli"), "--fix_dir",
            join(tmp, "synth", "osie", "fixations"), "--log_root",
            log_root] + FLAGS + [
        "--batch", "8", "--rl_sample_number", "2", "--warmup_epoch", "1",
        "--start_rl_epoch", "1", "--epoch", "2", "--device_eval", "true",
        "--device", "cpu", "--mesh_size", "0"]
    patches = _float64()
    with patches[0], patches[2], patches[3], _no_tensorboard():
        best = tcli_train.main(argv)
    run = [d for d in os.listdir(log_root) if d.startswith("log_")
           and not d.endswith("_supervised_save")][0]
    scalars = {}
    with open(join(log_root, run, "scalars.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            scalars.setdefault(r["tag"], []).append((r["step"], r["value"]))
    with open(join(log_root, run, "history_record.json")) as f:
        record = json.load(f)
    mesh.barrier()
    return dict(best=best, scalars=scalars, record=record)


CASES = {**{f"evaluate_{t}": (case_evaluate, (t,)) for t in TASKS},
         **{f"cli_{k}": (case_cli_test, (k,)) for k in ("osie", "joint")},
         "train": (case_train, ())}


def _rank_main(rank, world, tmp, names, model_parallel=1):
    """Rank ``rank`` of ``world`` in a gloo group over ``tmp``'s
    rendezvous file (a ``model_parallel`` mesh): the cases ``names``, each
    result saved as ``<name>.<rank>.pt`` (a traceback as
    ``error.<rank>.txt``)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{join(tmp, 'pg')}",
                            rank=rank, world_size=world)
    mesh.set_model_parallel(model_parallel)
    module = sys.modules[__name__]
    try:
        for name in names:
            fn, extra = module.CASES[name]
            out = fn(tmp, *extra)
            path = join(tmp, f"{name}.{rank}.pt")
            torch.save(out, path + ".part")
            os.replace(path + ".part", path)
    except BaseException:
        with open(join(tmp, f"error.{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


class Ranks:
    """The spawned ranks of one module and their results."""

    def __init__(self, tmp, target, world, names, model_parallel=1):
        ctx = multiprocessing.get_context("spawn")
        self.tmp, self.world = tmp, world
        self.procs = [ctx.Process(target=target, daemon=True,
                                  args=(r, world, tmp, names,
                                        model_parallel))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.started = time.monotonic()
        self.results = {}

    def result(self, name):
        """Every rank's result of case ``name``; each file is read once
        and removed."""
        if name not in self.results:
            paths = [join(self.tmp, f"{name}.{r}.pt")
                     for r in range(self.world)]
            while not all(exists(p) for p in paths):
                for r, p in enumerate(self.procs):
                    if p.exitcode not in (None, 0):
                        err = join(self.tmp, f"error.{r}.txt")
                        text = open(err).read() if exists(err) else ""
                        pytest.fail(f"rank {r} exited {p.exitcode}:\n{text}")
                if time.monotonic() - self.started > WAIT:
                    pytest.fail(f"no result {name} after {WAIT} s")
                time.sleep(0.05)
            self.results[name] = [torch.load(p, weights_only=False)
                                  for p in paths]
            for p in paths:
                os.remove(p)
        return self.results[name]

    def close(self):
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()


def _write_runs(tmp):
    """A single-task OSIE run dir and a joint run dir in cli/train.py's
    layout, their weights from seed 0."""
    args = _args(tmp, "osie")
    for kind in ("osie", "joint"):
        ckpt = join(tmp, f"run_{kind}", "checkpoints")
        os.makedirs(ckpt)
        a = types.SimpleNamespace(**{**vars(args), "task": kind})
        model = model64(a).float()
        init64(model, 0)
        if kind == "joint":
            sd = port.to_joint_reference_state_dict(model.state_dict(), MH,
                                                    MW)
        else:
            sd = port.to_reference_state_dict(model.state_dict(), "osie",
                                              MH, MW)
        torch.save(sd, join(ckpt, "checkpoint_best.pth"))
        with open(join(tmp, f"run_{kind}", "hparams.json"), "w") as f:
            json.dump({**vars(args), "task": kind}, f)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The data and run dirs written, then the two ranks started; the
    world-1 results are computed here, as the tests ask for them."""
    from tools.make_synth_data import make_all
    tmp = str(tmp_path_factory.mktemp("eval_ranks"))
    make_all(join(tmp, "synth"), osie=dict(n_images=9),
             air=dict(n_questions=5), coco=dict(n_images=5))
    _write_runs(tmp)
    ranks = Ranks(tmp, _rank_main, WORLD, list(CASES))
    yield ranks
    ranks.close()
    shutil.rmtree(tmp, ignore_errors=True)


def _world1(world2, name):
    fn, extra = CASES[name]
    return fn(world2.tmp, *extra)


def _close_tree(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _close_tree(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL,
                                       atol=0, err_msg=f"{path}/{k}")


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", TASKS)
def test_evaluate_over_ranks_matches_one_process(world2, task):
    """EvalCore.evaluate (device sweep and host suite) and the human
    baseline at world 2 against world 1: every metric and std at rtol
    1e-12 on both ranks, the records of rank 0 equal to world 1's in
    order (rank 1 returns none); the split ends in a partial batch."""
    want = _world1(world2, f"evaluate_{task}")
    got = world2.result(f"evaluate_{task}")
    n_images = len(EvaluationDataset(
        task, tjoint.task_data_config(_args(world2.tmp, task), task),
        split="validation" if task == "coco" else "test"))
    assert n_images % 4
    for device_eval in (True, False):
        w = want[device_eval]
        for rank, g in enumerate(got):
            g = g[device_eval]
            for key in ("metrics", "stds"):
                _close_tree(g[key], w[key], f"rank {rank} {key}")
            for i, key in enumerate(("human metrics", "human stds")):
                _close_tree(g["human"][i], w["human"][i], f"rank {rank} {key}")
        assert got[1][device_eval]["records"] == []
        assert got[0][device_eval]["records"] == w["records"]
        streams = 2 if task == "air" else 1
        assert len(w["records"]) == n_images * 2 * streams
    if task == "air":
        assert set(want[True]["metrics"]) == {"all", "right_answer",
                                              "wrong_answer"}


@pytest.mark.parametrize("kind", ["osie", "joint"])
def test_cli_test_over_ranks_matches_one_process(world2, kind):
    """cli/test.py under two ranks against one process: the metric tree
    on both ranks, the prediction JSON rank 0 wrote, the log's metric
    table written once."""
    want = _world1(world2, f"cli_{kind}")
    got = world2.result(f"cli_{kind}")
    for g in got:
        _close_tree(g["metrics"], want["metrics"])
        assert g["records"] == want["records"]
        assert g["tables"] == want["tables"] == 1
    assert want["records"]


def test_trainer_validation_over_ranks_matches_one_process(world2):
    """cli/train.py at world 2 (every rank validates its rows) against
    world 1: the human baseline's and the validation's scalars and the
    selection metric at rtol 1e-9, the record equal, the best metric
    on both ranks."""
    want = _world1(world2, "train")
    got = world2.result("train")
    for g in got:
        assert g["record"] == want["record"]
        assert g["best"] == pytest.approx(want["best"], rel=RUN_RTOL)
        tags = [t for t in want["scalars"] if "metrics/" in t
                or t == "current metric"]
        assert "current metric" in tags and len(tags) > 5
        for tag in tags:
            (s1, v1), (s2, v2) = (zip(*x[tag]) for x in (want["scalars"],
                                                        g["scalars"]))
            assert s1 == s2 and len(s1) == 2, tag    # after each epoch
            np.testing.assert_allclose(v2, v1, rtol=RUN_RTOL, err_msg=tag)


def test_world1_under_a_process_group_calls_no_collective(tmp_path):
    """One rank in a process group takes the single-card path: the
    supervised and SCST steps, an evaluation with records and the human
    baseline call no collective."""
    from tools.make_synth_data import make_all
    make_all(str(tmp_path / "synth"), osie=dict(n_images=3),
             air=dict(n_questions=1), coco=dict(n_images=1))
    calls = []

    def counted(name):
        real = getattr(dist, name)

        def call(*a, **kw):
            calls.append(name)
            return real(*a, **kw)
        return call
    names = ("all_reduce", "broadcast", "barrier", "all_gather",
             "reduce", "gather")
    dist.init_process_group("gloo",
                            init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        with mock.patch.multiple(dist, **{n: counted(n) for n in names}):
            args = _args(str(tmp_path), "osie")
            core = Core(args)
            loader = _loader(args)
            core.evaluate(loader, True, record=_record)
            core.evaluate(loader, False)
            core.human_metrics(loader, True)
            state = steps.TrainState.create(core.model, types.SimpleNamespace(
                lr=1e-3, clip=12.5, weight_decay=1e-4, warmup_epoch=1,
                start_rl_epoch=5, epoch=10, rl_lr_initial_decay=0.5), 4, 4,
                step=2, device="cpu")
            batch = next(iter(Loader(EvaluationDataset(
                "osie", tjoint.task_data_config(args, "osie"), "train"),
                batch_size=2)))
            steps.rl_step(state, steps.device_batch(batch, "cpu", True),
                          ttrainer.rl_config(args, loader.dataset),
                          generator=torch.Generator().manual_seed(0))
            from scanpaths_tpu_torch.data.datasets import SupervisedDataset
            sup = next(iter(Loader(SupervisedDataset(
                "osie", tjoint.task_data_config(args, "osie"), "train"),
                batch_size=2)))
            core.model.train()
            steps.supervised_step(state, steps.device_batch(sup, "cpu",
                                                            False), 1.0)
            mesh.broadcast_str("log_1")
            mesh.barrier()
        assert mesh.active() and mesh.world_size() == 1
        assert not mesh.distributed()
    finally:
        dist.destroy_process_group()
    assert calls == []
