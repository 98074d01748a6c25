"""The port's joint trainer on the CPU (``train/joint.py``,
``cli/train.py --task joint``) and the test and serving drivers on a
joint run's heads, at ``tests/test_joint.py``'s geometry and argv (40x48
images, a 5x6 map, T = 4, embed 128, trunk (1,1,1,1), batch 8) over
``tools/make_synth_data.py::make_all`` with 3 images a task:

* the port's run of that argv through ``cli/train.py`` (one supervised
  epoch, then a resumed run that adds the SCST epoch): the artifacts, the
  record and the tags, then ``cli/test.py --task osie`` and
  ``cli/predict.py --task air`` on the run;
* that run against the JAX ``JointTrainer``'s run of the same argv in one
  go, the port starting from the JAX trainer's initial weights (carried
  over by ``models/port.py::joint_from_jax_params`` in a test-side patch
  of ``train/joint.py``'s ``init_weights``) with its sampler fed the
  noise of the JAX trainer's key chain (test-side patches of
  ``EvalCore.sample`` and ``steps.rl_step``, as in
  ``tests/test_torch_trainer.py``): the batches of every step, the scalar
  tags, the ``learning_rate`` scalars (exactly), the losses and rewards
  of every step, the joint selection metric of each validation and the
  record;
* the device sweep's validation against the host suite's, and the
  device human baseline against the host one;
* the resume: the iteration, Adam's step count and the lr go on;
* ``--checkpoint`` warm-starts the shared trunk (a sha-checked
  torchvision-layout file);
* ``--task joint`` on ``cli/test.py`` and ``cli/predict.py`` raises.

Tolerances, with the largest gap measured on this geometry in brackets:
the losses of every step at rtol 1e-3 (the supervised ones 2.5e-5; the
SCST ``rl_loss``, a small difference of large per-rollout terms,
1.9e-4): Adam's first steps from zero moments move each parameter by
about lr times the SIGN of its gradient, so a gradient within rounding
of zero parts the packages, and the losses drift apart step by step;
the SCST rewards at rtol 1e-5 (6.3e-8); the joint selection metric at
rtol 1e-6 (0: on the same noise the sampled scanpaths agree); the
device sweep against the host suite at ``tests/test_joint.py``'s
tolerances (rtol 5e-4 / atol 5e-5, with duration and the joint metric
rtol 1e-2; the with-duration columns of a task whose sweep truncated a
rollout differ by design and are left out, as in
``tests/test_torch_eval.py``).
"""

import hashlib
import json
import os
from os.path import exists, join
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from scanpaths_tpu.core import config as jconfig
from scanpaths_tpu.train import joint as jjoint
from scanpaths_tpu.train.schedule import lr_multiplier as jlr
from scanpaths_tpu_torch.cli import predict as tcli_predict
from scanpaths_tpu_torch.cli import test as tcli_test
from scanpaths_tpu_torch.cli import train as tcli_train
from scanpaths_tpu_torch.core import config as tconfig
from scanpaths_tpu_torch.models import port, resnet
from scanpaths_tpu_torch.ops.sampling import random_sample_from_noise
from scanpaths_tpu_torch.train import joint as tjoint
from scanpaths_tpu_torch.train import trainer as ttrainer
from scanpaths_tpu_torch.utils import checkpointing as ck
from test_torch_trainer import _torchvision_layout

TASKS = ("osie", "air", "coco")
MH, MW, T = 5, 6, 4
LOSS_RTOL = 1e-3
REWARD_RTOL = 1e-5
METRIC_RTOL = 1e-6
SWEEP_TOL = dict(rtol=5e-4, atol=5e-5)
SWEEP_WD_RTOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    from tools.make_synth_data import make_all
    root = tmp_path_factory.mktemp("torch_joint_data")
    make_all(str(root), osie=dict(n_images=3, n_subjects=3),
             air=dict(n_questions=3, n_subjects=3),
             coco=dict(n_images=3, n_subjects=3))
    return str(root)


def _argv(synth_root, log_root, extra=()):
    """test_joint.py's argv (the port's CLIs add ``--device cpu``)."""
    return ["--task", "joint", "--joint_data_root", synth_root,
            "--log_root", log_root, "--height", "40", "--width", "48",
            "--map_height", str(MH), "--map_width", str(MW),
            "--max_length", str(T), "--embed", "128",
            "--backbone_layers", "1,1,1,1", "--batch", "8",
            "--rl_sample_number", "2", "--eval_repeat_num", "1",
            "--warmup_epoch", "1", "--start_rl_epoch", "1",
            "--mesh_size", "1", *extra]


def _head_argv(task, synth_root, log_dir):
    """cli/test.py's and cli/predict.py's flags for one head of the run."""
    data = {"osie": ["--img_dir", join(synth_root, "osie", "stimuli")],
            "air": ["--img_dir", join(synth_root, "air", "stimuli"),
                    "--att_dir", join(synth_root, "air", "attention")],
            "coco": ["--img_dir", join(synth_root, "coco", "images"),
                     "--detector_dir", join(synth_root, "coco",
                                            "detectors")]}[task]
    return ["--task", task, *data,
            "--fix_dir", join(synth_root, task, "fixations"),
            "--evaluation_dir", log_dir, "--height", "40", "--width", "48",
            "--map_height", str(MH), "--map_width", str(MW),
            "--max_length", str(T), "--embed", "128",
            "--backbone_layers", "1,1,1,1", "--batch", "8",
            "--eval_repeat_num", "1", "--device", "cpu"]


def _run_dir(log_root):
    runs = [d for d in os.listdir(log_root)
            if d.startswith("log_joint_")
            and not d.endswith("_supervised_save")]
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


def _record(log_dir):
    with open(join(log_dir, "history_record.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the runs: the JAX joint trainer's and the port's, from the same weights
# ---------------------------------------------------------------------------

class _KeyChain:
    """The JAX joint trainer's key chain: PRNGKey(seed), split once per
    SCST step and per validation decode (per stream for AiR)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def next(self):
        self.key, sub = jax.random.split(self.key)
        return sub


def _jax_draws(key, r, shape_g, shape_z):
    g, z = [], []
    for k in jax.random.split(key, r):
        k_act, k_dur = jax.random.split(k)
        g.append(np.asarray(jax.random.gumbel(k_act, shape_g)))
        z.append(np.asarray(jax.random.normal(k_dur, shape_z)))
    return torch.from_numpy(np.stack(g)), torch.from_numpy(np.stack(z))


def _patched_port(chain, params, stats):
    """The test-side patches that give the port the JAX trainer's initial
    weights and noise: ``init_weights`` loads the flax trees; each
    validation decode of a stream draws from the next key (the JAX
    trainer's vmapped ``random_sample`` over ``split(sub, R)``), and each
    SCST step from the next key (``rl_loss``: ``split(fold_in(key, 1),
    R)``, AiR ``fold_in(key, 0)`` for the good stream and
    ``fold_in(key, 1)`` for the poor one)."""
    real_rl_step = ttrainer.steps.rl_step

    def init_weights(model, seed):
        model.load_state_dict(port.joint_from_jax_params(params, stats, MH,
                                                         MW))

    def sample(self, out, repeat_num, stream):
        pre = f"{stream}_" if stream else ""
        probs, mu = out[pre + "all_actions_prob"], out[pre + "log_normal_mu"]
        g, z = _jax_draws(chain.next(), repeat_num, tuple(probs.shape),
                          tuple(mu.shape))
        return random_sample_from_noise(probs, mu,
                                        out[pre + "log_normal_sigma2"],
                                        self.grid, g, z)

    def rl_step(state, batch, cfg, generator=None, noise=None):
        n, a = batch["images"].shape[0], MH * MW + 1
        key = chain.next()
        noise = [_jax_draws(jax.random.fold_in(key, si), cfg.rl_sample_number,
                            (n, T, a), (n, T))
                 for si in ((0, 1) if cfg.task == "air" else (1,))]
        return real_rl_step(state, batch, cfg, noise=noise)
    return (mock.patch.object(tjoint, "init_weights", init_weights),
            mock.patch.object(ttrainer.EvalCore, "sample", sample),
            mock.patch.object(ttrainer.steps, "rl_step", rl_step))


def _name_batches(tasks, names):
    """Record in ``names`` the image names of each batch of each task's
    two train loaders, in the order they are drawn."""
    for task, ctx in tasks.items():
        for kind, loader in (("sup", ctx.train_loader),
                             ("rl", ctx.train_rl_loader)):
            ds, real = loader.dataset, loader.dataset.get_batch

            def get_batch(indices, real=real, key=(task, kind)):
                batch = real(indices)
                names.append((*key, list(batch["img_names"])))
                return batch
            ds.get_batch = get_batch


@pytest.fixture(scope="module")
def runs(synth_root, tmp_path_factory):
    """test_joint.py's argv run by the JAX joint trainer in one go (one
    supervised epoch, one SCST epoch, host validation), and by the port
    through its cli.train: one supervised epoch (--epoch 1), then a
    resumed run that adds the SCST epoch (--epoch 2), from the JAX
    trainer's initial weights and on its key chain (which goes on across
    the resume).  Both record the image names of each training batch.
    Returns the run dirs, the name records and the port's rolling
    checkpoint after its supervised epoch."""
    argv = _argv(synth_root, str(tmp_path_factory.mktemp("jax_logs")),
                 ("--epoch", "2"))
    jargs = jconfig.parse_opt(argv)
    np.random.seed(jargs.seed)
    jt = jjoint.JointTrainer(jargs)
    params = jax.tree.map(np.array, jt.state.params)
    stats = jax.tree.map(np.array, jt.state.batch_stats)
    jnames = []
    _name_batches(jt.tasks, jnames)
    jt.fit()

    log_root = str(tmp_path_factory.mktemp("port_logs"))
    chain = _KeyChain(jargs.seed)
    tnames = []
    real_fit = tjoint.JointTrainer.fit

    def fit(self):
        _name_batches(self.tasks, tnames)
        return real_fit(self)
    p1, p2, p3 = _patched_port(chain, params, stats)
    with p1, p2, p3, mock.patch.object(tjoint.JointTrainer, "fit", fit):
        tcli_train.main(_argv(synth_root, log_root,
                              ("--epoch", "1", "--device", "cpu")))
        log_dir = _run_dir(log_root)
        after_sup = ck.restore_checkpoint(join(log_dir, "checkpoints"))
        best = tcli_train.main(_argv(synth_root, log_root,
                                     ("--epoch", "2", "--resume_dir",
                                      log_dir, "--device", "cpu")))
    return dict(jax_dir=jt.log_dir, jax_names=jnames, synth_root=synth_root,
                log_root=log_root, log_dir=log_dir, names=tnames,
                after_sup=after_sup, best=best)


# ---------------------------------------------------------------------------
# the artifacts, the test and serving drivers on a head
# ---------------------------------------------------------------------------

def test_joint_run_artifacts(runs):
    """test_joint.py::test_joint_cli_end_to_end's contract on the port's
    run, with .pth for .msgpack: the artifacts, the record (3 supervised
    and 3 SCST steps, one per task each), the tags of every task, and the
    joint .pth layout."""
    log_dir = runs["log_dir"]
    for name in ("hparams.json", "log_train.txt", "history_record.json",
                 "scalars.jsonl", "checkpoints/checkpoint.pth",
                 "checkpoints/checkpoint_best.pth"):
        assert exists(join(log_dir, name)), name
    assert exists(join(log_dir + "_supervised_save", "checkpoints",
                       "checkpoint.pth"))
    with open(join(log_dir, "hparams.json")) as f:
        assert json.load(f)["task"] == "joint"
    rec = _record(log_dir)
    assert (rec["epoch"], rec["iteration"]) == (1, 5)
    assert rec["best_metric"] > 0 and runs["best"] == rec["best_metric"]
    tags = set(_scalars(log_dir))
    for task in TASKS:
        assert f"{task}/loss/loss" in tags
        assert f"{task}/rl_loss" in tags
        assert any(tag.startswith(f"{task}/metrics/") for tag in tags)
    assert "osie/metrics_for_reward/vector" in tags
    assert "air/reward_same_hmean" in tags and "coco/reward_wd" in tags
    assert {"learning_rate", "current metric"} <= tags
    assert not any(tag.startswith(("loss/", "metrics/")) for tag in tags)
    best = ck.restore_best_checkpoint(join(log_dir, "checkpoints"))
    assert "resnet.0.weight" in best
    assert {"osie.sal_conv.weight", "air.lstm.input_pos.weight",
            "coco.object_sal_layer.cup.weight"} <= set(best)


def test_cli_test_on_a_joint_head(runs):
    """cli/test.py --task osie with --evaluation_dir at the joint run: the
    model is the run's OSIE head (its checkpoint_best.pth), the metric
    tree complete."""
    synth_root, log_dir = runs["synth_root"], runs["log_dir"]
    argv = _head_argv("osie", synth_root, log_dir)
    metrics = tcli_test.main(argv)
    assert set(metrics) >= {"MultiMatch", "ScanMatch", "VAME"}
    assert set(metrics["ScanMatch"]) == {"w/o duration", "with duration"}
    assert exists(join(log_dir, "test_predicts.json"))
    ev = ttrainer.Evaluator(tconfig.parse_opt(argv[:-2]), log_dir, "cpu")
    want = port.load_reference_state_dict(port.task_reference_state_dict(
        ck.restore_best_checkpoint(join(log_dir, "checkpoints")), "osie"),
        "osie")
    got = ev.model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_cli_predict_on_a_joint_head(runs, tmp_path):
    """cli/predict.py --task air serves the joint run's AiR head: the same
    records as a single-task AiR run dir holding that head's weights."""
    synth_root, log_dir = runs["synth_root"], runs["log_dir"]
    argv = _head_argv("air", synth_root, log_dir) + [
        "--predict_images", join(synth_root, "air", "stimuli"),
        "--decode", "sample", "--num_samples", "2"]
    recs = tcli_predict.main(argv)
    assert recs and all(set(r) == {"name", "repeat_id", "X", "Y", "T",
                                   "length"} for r in recs)
    single = tmp_path / "air_run"
    (single / "checkpoints").mkdir(parents=True)
    torch.save({"model": port.task_reference_state_dict(
        ck.restore_best_checkpoint(join(log_dir, "checkpoints")), "air")},
        single / "checkpoints" / "checkpoint_best.pth")
    i = argv.index("--evaluation_dir")
    assert tcli_predict.main(argv[:i + 1] + [str(single)]
                             + argv[i + 2:]) == recs


@pytest.mark.parametrize("cli", [tcli_test, tcli_predict],
                         ids=["test", "predict"])
def test_task_joint_is_refused(cli, runs):
    argv = _head_argv("osie", runs["synth_root"], runs["log_dir"])
    argv[1] = "joint"
    with pytest.raises(ValueError, match="one task at a time"):
        cli.main(argv + ["--predict_images",
                         join(runs["synth_root"], "osie", "stimuli")])


# ---------------------------------------------------------------------------
# parity with the JAX joint trainer
# ---------------------------------------------------------------------------

def test_batches_match_the_jax_trainer(runs):
    """The same batches in the same round-robin order: OSIE, AiR, COCO,
    supervised then SCST."""
    assert [n[:2] for n in runs["jax_names"]] == \
        [(t, "sup") for t in TASKS] + [(t, "rl") for t in TASKS]
    assert runs["names"] == runs["jax_names"]


def test_scalars_and_record_match_the_jax_trainer(runs):
    """The port's run (resumed after its supervised epoch) against the JAX
    joint trainer's run in one go: the same scalar tags, the
    ``learning_rate`` of every iteration exactly, the losses of each
    supervised step and the losses and rewards of each SCST step, the
    joint selection metric of each validation, and the record."""
    js, ts = _scalars(runs["jax_dir"]), _scalars(runs["log_dir"])
    assert set(ts) == set(js)
    assert ts["learning_rate"] == js["learning_rate"]
    assert sorted(ts["learning_rate"]) == list(range(6))
    for it, task in enumerate(TASKS):
        for tag in ("loss", "loss_actions", "loss_duration"):
            tag = f"{task}/loss/{tag}"
            assert sorted(ts[tag]) == sorted(js[tag]) == [it], tag
            np.testing.assert_allclose(ts[tag][it], js[tag][it],
                                       rtol=LOSS_RTOL, err_msg=tag)
    for it, task in enumerate(TASKS, start=3):
        tags = [t for t in js if t.startswith(f"{task}/")
                and t.split("/", 1)[1].startswith(
                    ("rl_loss", "reward_", "metrics_for_reward/",
                     "rollout_"))]
        assert f"{task}/rl_loss" in tags and len(tags) > 1
        for tag in tags:
            assert sorted(ts[tag]) == sorted(js[tag]) == [it], tag
            rtol = LOSS_RTOL if tag.endswith("rl_loss") else REWARD_RTOL
            np.testing.assert_allclose(ts[tag][it], js[tag][it], rtol=rtol,
                                       err_msg=tag)
    assert sorted(ts["current metric"]) == sorted(js["current metric"]) \
        == [2, 5]
    for it in (2, 5):
        np.testing.assert_allclose(ts["current metric"][it],
                                   js["current metric"][it],
                                   rtol=METRIC_RTOL)
    jrec, trec = _record(runs["jax_dir"]), _record(runs["log_dir"])
    assert (trec["epoch"], trec["iteration"]) == \
        (jrec["epoch"], jrec["iteration"]) == (1, 5)
    np.testing.assert_allclose(trec["best_metric"], jrec["best_metric"],
                               rtol=METRIC_RTOL)


def test_resume_continues_the_run(runs):
    """The resumed run goes on from the record's iteration with the Adam
    state restored (step 3 after the supervised epoch, 6 at the end), each
    ``learning_rate`` written once and equal to ``lr * lr_multiplier``
    of the joint schedule (3 supervised and 3 SCST steps, the sums over
    the tasks); a JointTrainer on the finished record restores it and its
    fit() is a no-op returning the best metric."""
    assert ttrainer.adam_step(runs["after_sup"]["optimizer"]) == 3
    log_dir = runs["log_dir"]
    assert ttrainer.adam_step(ck.restore_checkpoint(
        join(log_dir, "checkpoints"))["optimizer"]) == 6
    args = tconfig.parse_opt(_argv(runs["synth_root"], runs["log_root"],
                                   ("--epoch", "2", "--resume_dir",
                                    log_dir)))
    for it, values in _scalars(log_dir)["learning_rate"].items():
        assert values == [args.lr * jlr(it, 3, 3, 1, 1, 2, 0.5)], it
    trainer = tjoint.JointTrainer(args, "cpu")
    assert (trainer.record_manager.get_epoch(),
            trainer.record_manager.get_iteration()) == (1, 5)
    assert trainer.state.step == 6
    assert trainer.state.optimizer.param_groups[0]["lr"] == \
        args.lr * jlr(6, 3, 3, 1, 1, 2, 0.5)
    assert trainer.fit() == pytest.approx(
        trainer.checkpoint_manager.get_best_metric())


# ---------------------------------------------------------------------------
# the device sweep against the host suite
# ---------------------------------------------------------------------------

def _trainer(synth_root, log_root):
    return tjoint.JointTrainer(tconfig.parse_opt(_argv(
        synth_root, log_root, ("--eval_repeat_num", "2"))), "cpu")


def _joint_metric(scalars, step):
    """The joint selection metric recomputed from a validation's logged
    per-task ScanMatch scalars: the harmonic mean over the tasks of each
    task's ScanMatch harmonic mean (AiR: its right- and wrong-answer
    groups)."""
    def hmean(vals):
        return len(vals) / sum(1.0 / v for v in vals)
    per_task = []
    for task in TASKS:
        groups = ("right_answer-", "wrong_answer-") if task == "air" \
            else ("",)
        per_task.append(hmean([
            scalars[f"{task}/metrics/{g}ScanMatch-{col}"][step][0]
            for g in groups for col in ("w/o duration", "with duration")]))
    return hmean(per_task)


def test_validation_device_matches_host(synth_root, tmp_path):
    """test_joint.py::test_joint_validation_device_matches_host on the
    port: the same noise, then every head's metric scalars of the device
    sweep against the host suite's.  A task whose sweep prefix-truncated
    a rollout past its with-duration table (its wd_overflow_frac > 0:
    seed weights sample huge LogNormal durations) has its with-duration
    columns differ by design, as in tests/test_torch_eval.py; they are
    then left out, and so is the joint metric's comparison.  The joint
    metric of each validation equals its recomputation from the logged
    per-task scalars."""
    trainer = _trainer(synth_root, str(tmp_path))
    trainer.generator.manual_seed(99)
    host = trainer.validation(1)
    trainer.generator.manual_seed(99)
    dev = trainer.validation(2, device_eval=True)
    trainer.writer.close()
    scalars = _scalars(trainer.log_dir)
    for step, value in ((1, host), (2, dev)):
        np.testing.assert_allclose(value, _joint_metric(scalars, step),
                                   rtol=1e-12)
        assert scalars["current metric"][step] == [value]
    overflowed = {t for t in TASKS
                  if scalars[f"{t}/metrics/wd_overflow_frac"][2][0] > 0}
    if not overflowed:
        np.testing.assert_allclose(dev, host, rtol=SWEEP_WD_RTOL)
    host_tags = {tag for tag, steps in scalars.items()
                 if "/metrics/" in tag and 1 in steps}
    assert {tag.split("/")[0] for tag in host_tags} == set(TASKS)
    assert host_tags | {f"{t}/metrics/wd_overflow_frac" for t in TASKS} \
        == {tag for tag, steps in scalars.items()
            if "/metrics/" in tag and 2 in steps}
    for tag in host_tags:
        if "with duration" in tag and tag.split("/")[0] in overflowed:
            continue
        tol = dict(SWEEP_TOL, rtol=SWEEP_WD_RTOL) \
            if "with duration" in tag else SWEEP_TOL
        np.testing.assert_allclose(scalars[tag][2][0], scalars[tag][1][0],
                                   err_msg=tag, **tol)


def test_human_baseline_device_matches_host(synth_root, tmp_path):
    """Each task's human baseline on the device (the CPU here) against the
    host suite's: every metric and its std."""
    trainer = _trainer(synth_root, str(tmp_path))

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v
    for task, ctx in trainer.tasks.items():
        host = ctx.human_metrics(ctx.validation_loader, False)
        dev = ctx.human_metrics(ctx.validation_loader, True)
        for h, d in zip(host, dev):
            h, d = dict(leaves(h)), dict(leaves(d))
            assert set(h) == set(d) and h
            for k in h:
                np.testing.assert_allclose(d[k], h[k], err_msg=f"{task} {k}",
                                           **SWEEP_TOL)


def test_trunk_warm_start(synth_root, tmp_path):
    """--checkpoint loads a torchvision-layout state dict, whose file name
    embeds its sha256 prefix, into the joint model's one trunk."""
    src = resnet.DilatedResNet50((1, 1, 1, 1))
    gen = torch.Generator().manual_seed(7)
    resnet.init_weights(src, gen)
    with torch.no_grad():
        src.bn1.running_mean.uniform_(-1, 1, generator=gen)
    tmp = tmp_path / "resnet50.tmp"
    torch.save(_torchvision_layout(src), tmp)
    digest = hashlib.sha256(tmp.read_bytes()).hexdigest()[:8]
    good = tmp_path / f"resnet50-{digest}.pth"
    tmp.rename(good)
    trainer = tjoint.JointTrainer(tconfig.parse_opt(_argv(
        synth_root, str(tmp_path / "logs"), ("--checkpoint", str(good)))),
        "cpu")
    got, want = trainer.model.backbone.state_dict(), src.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
