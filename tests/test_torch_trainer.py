"""The port's training driver on the CPU (``train/trainer.py``,
``cli/train.py``), at ``tests/test_e2e.py``'s geometry and argv (40x48
images, a 5x6 map, T = 4, embed 128, trunk (1,1,1,1), batch 4) over
``tools/make_synth_data.py``'s splits:

* the port's run of that argv through ``cli/train.py`` as ``test_e2e.py``
  drives the JAX package (one supervised epoch, then a resumed run that
  adds the SCST epoch): the artifact contract, resume (the Adam state
  and the schedule go on), and ``cli/test.py`` on the port's own run;
* that run against the JAX trainer's run of the same argv in one go:
  the port starts from the JAX trainer's initial weights (carried over
  with ``models/port.py::from_jax_params`` by a test-side patch of the
  port's ``init_weights``) and its sampler is fed the noise of the JAX
  trainer's key chain (a test-side patch of ``EvalCore.sample`` and
  ``steps.rl_step``; ``jax.random.categorical`` is
  ``argmax(logits + gumbel)``).  The batches of every step (image names,
  in order), the scalar tags, the ``learning_rate`` scalars (exactly),
  the losses and rewards of every step, the selection metric of each
  validation and the run record are compared;
* AiR and COCO end to end (``cli/train.py``, then ``cli/test.py``);
* the backbone warm start from a torchvision-layout file whose name
  embeds its own sha256 prefix, and the refusal of a corrupted one;
* every flag the port refuses, and ``--device cuda`` without a card.

Tolerances of the parity test, set from measurements on this geometry
(the largest gap measured in brackets): the first supervised step's
losses at rtol 1e-5 (2.7e-7: float32, the same weights and batch); the
later supervised steps' at rtol 1e-3 (1.7e-4 at the sixth step): Adam's
first steps from zero moments move each parameter by about lr times the
SIGN of its gradient, so parameters whose gradient is within rounding of
zero part between the packages, and the losses drift apart step by
step; the SCST steps' ``rl_loss`` at atol 1e-6 (4e-8) and their rewards
at rtol 1e-5 (1.1e-7); the selection metric of each validation and the
record's best metric at rtol 1e-6 (0: on the same noise the sampled
scanpaths agree).
"""

import hashlib
import json
import os
import shutil
from os.path import exists, join
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from scanpaths_tpu.core import config as jconfig
from scanpaths_tpu.train import trainer as jtrainer
from scanpaths_tpu_torch.cli import test as tcli_test
from scanpaths_tpu_torch.cli import train as tcli_train
from scanpaths_tpu_torch.core import config as tconfig
from scanpaths_tpu_torch.models import port, resnet
from scanpaths_tpu_torch.ops.sampling import random_sample_from_noise
from scanpaths_tpu_torch.train import trainer as ttrainer
from scanpaths_tpu_torch.utils import checkpointing as ck

MH, MW, T = 5, 6, 4
FIRST_RTOL = 1e-5
LOSS_RTOL = 1e-3
RL_LOSS_ATOL = 1e-6
REWARD_RTOL = 1e-5
METRIC_RTOL = 1e-6



@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: its ops are too small
    to gain from more (the AiR run takes half the time on one), and the
    suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    from tools.make_synth_data import make_all
    root = tmp_path_factory.mktemp("torch_trainer_data")
    make_all(str(root))
    return str(root)


def _argv(synth_root, log_root, extra=()):
    """test_e2e.py's argv (the port's CLIs add ``--device cpu``)."""
    return [
        "--task", "osie",
        "--img_dir", join(synth_root, "osie", "stimuli"),
        "--fix_dir", join(synth_root, "osie", "fixations"),
        "--log_root", log_root,
        "--height", "40", "--width", "48",
        "--map_height", str(MH), "--map_width", str(MW),
        "--max_length", str(T),
        "--embed", "128", "--backbone_layers", "1,1,1,1",
        "--batch", "4", "--rl_sample_number", "2",
        "--eval_repeat_num", "2",
        "--warmup_epoch", "1", "--start_rl_epoch", "1",
        "--mesh_size", "1",
        *extra,
    ]


def _task_argv(task, synth_root, log_root, extra=()):
    """test_e2e.py's AiR and COCO argv."""
    maps = {"air": ["--img_dir", join(synth_root, "air", "stimuli"),
                    "--att_dir", join(synth_root, "air", "attention")],
            "coco": ["--img_dir", join(synth_root, "coco", "images"),
                     "--detector_dir", join(synth_root, "coco",
                                            "detectors")]}[task]
    return ["--task", task, *maps,
            "--fix_dir", join(synth_root, task, "fixations"),
            "--log_root", log_root, "--height", "40", "--width", "48",
            "--map_height", str(MH), "--map_width", str(MW),
            "--max_length", str(T), "--embed", "128",
            "--backbone_layers", "1,1,1,1", "--batch", "8",
            "--rl_sample_number", "2", "--eval_repeat_num", "1",
            "--warmup_epoch", "1", "--start_rl_epoch", "1", "--epoch", "2",
            "--mesh_size", "1", *extra]


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


def _record(log_dir):
    with open(join(log_dir, "history_record.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the runs: the JAX trainer's and the port's, from the same weights
# ---------------------------------------------------------------------------

class _KeyChain:
    """The JAX trainer's key chain: PRNGKey(seed), split once per SCST
    step and per validation decode."""

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
    weights and noise: ``init_weights`` loads the flax trees, each
    validation decode draws from the next key (as the JAX trainer's
    vmapped ``random_sample`` over ``split(sub, R)``) and each SCST step
    from the next key (as ``rl_loss``: ``split(fold_in(key, 1), R)``)."""
    real_rl_step = ttrainer.steps.rl_step

    def init_weights(model, seed):
        model.load_state_dict(port.from_jax_params(params, stats, "osie",
                                                   MH, MW))

    def sample(self, out, repeat_num, stream):
        assert stream is None
        probs, mu = out["all_actions_prob"], out["log_normal_mu"]
        g, z = _jax_draws(chain.next(), repeat_num, tuple(probs.shape),
                          tuple(mu.shape))
        return random_sample_from_noise(probs, mu, out["log_normal_sigma2"],
                                        self.grid, g, z)

    def rl_step(state, batch, cfg, generator=None, noise=None):
        n, a = batch["images"].shape[0], MH * MW + 1
        key = jax.random.fold_in(chain.next(), 1)
        noise = [_jax_draws(key, cfg.rl_sample_number, (n, T, a), (n, T))]
        return real_rl_step(state, batch, cfg, noise=noise)
    return (mock.patch.object(ttrainer, "init_weights", init_weights),
            mock.patch.object(ttrainer.EvalCore, "sample", sample),
            mock.patch.object(ttrainer.steps, "rl_step", rl_step))


def _name_batches(trainer, names):
    """Record in ``names`` the image names of each batch the two train
    loaders give, in order."""
    for key, loader in (("sup", trainer.train_loader),
                        ("rl", trainer.train_rl_loader)):
        ds, real = loader.dataset, loader.dataset.get_batch

        def get_batch(indices, real=real, key=key):
            batch = real(indices)
            names[key].append(list(batch["img_names"]))
            return batch
        ds.get_batch = get_batch


@pytest.fixture(scope="module")
def runs(synth_root, tmp_path_factory):
    """test_e2e.py's argv run by the JAX trainer in one go (one supervised
    epoch, one SCST epoch, host validation), and by the port through its
    cli.train as test_e2e.py drives the JAX package: one supervised epoch
    (epoch=1), then a resumed run that adds the SCST epoch (epoch=2).
    The port's run starts from the JAX trainer's initial weights and draws
    the noise of its key chain (the chain goes on across the resume);
    both record the image names of each training batch.  Returns the two
    run dirs, the two name records and the port's rolling checkpoint
    after its supervised epoch."""
    argv = _argv(synth_root, str(tmp_path_factory.mktemp("jax_logs")),
                 ("--epoch", "2"))
    jargs = jconfig.parse_opt(argv)
    np.random.seed(jargs.seed)
    jt = jtrainer.Trainer(jargs)
    params = jax.tree.map(np.array, jt.state.params)
    stats = jax.tree.map(np.array, jt.state.batch_stats)
    jnames = {"sup": [], "rl": []}
    _name_batches(jt, jnames)
    jt.fit()

    log_root = str(tmp_path_factory.mktemp("port_logs"))
    chain = _KeyChain(jargs.seed)
    tnames = {"sup": [], "rl": []}
    real_fit = ttrainer.Trainer.fit

    def fit(self):
        _name_batches(self, tnames)
        return real_fit(self)
    p1, p2, p3 = _patched_port(chain, params, stats)
    with p1, p2, p3, mock.patch.object(ttrainer.Trainer, "fit", fit):
        tcli_train.main(_argv(synth_root, log_root,
                              ("--epoch", "1", "--device", "cpu")))
        log_dir = _run_dir(log_root)
        after_sup = ck.restore_checkpoint(join(log_dir, "checkpoints"))
        tcli_train.main(_argv(synth_root, log_root,
                              ("--epoch", "2", "--resume_dir", log_dir,
                               "--device", "cpu")))
    return dict(jax_dir=jt.log_dir, jax_names=jnames, synth_root=synth_root,
                log_root=log_root, log_dir=log_dir, names=tnames,
                after_sup=after_sup)


# ---------------------------------------------------------------------------
# the artifact contract, resume and the test CLI
# ---------------------------------------------------------------------------

def test_artifact_contract(runs):
    log_dir = runs["log_dir"]
    for name in ("hparams.json", "log_train.txt", "history_record.json",
                 "scalars.jsonl", "checkpoints/checkpoint.pth",
                 "checkpoints/checkpoint_best.pth"):
        assert exists(join(log_dir, name)), name
    # the pre-RL snapshot (reference AiR/train.py:480-482)
    assert exists(join(log_dir + "_supervised_save", "checkpoints",
                       "checkpoint.pth"))
    with open(join(log_dir, "hparams.json")) as f:
        hp = json.load(f)
    assert hp["task"] == "osie" and hp["batch"] == 4
    rec = _record(log_dir)
    # 6 supervised + 6 SCST steps, 0-indexed from the reference's -1
    assert rec["epoch"] == 1 and rec["iteration"] == 11
    assert rec["best_metric"] > 0
    tags = set(_scalars(log_dir))
    for tag in ("loss/loss", "loss/loss_actions", "loss/loss_duration",
                "learning_rate", "current metric",
                "metrics/ScanMatch-w/o duration", "perf/steps_per_sec",
                "perf/images_per_sec", "rl_loss", "reward_hmean",
                "reward_overflow_frac", "metrics_for_reward/vector",
                "metrics_for_reward/duration",
                "metrics_for_reward/w/o duration",
                "metrics_for_reward/SED best",
                "metrics_for_reward/STDE mean"):
        assert tag in tags, tag
    assert sum(t.startswith("metrics_for_reward/") for t in tags) == 11
    assert "grad_norm" not in tags
    # the reference's .pth layout: the model's keys are the reference's
    best = ck.restore_best_checkpoint(join(log_dir, "checkpoints"))
    assert "resnet.0.weight" in best


def test_resume_continues_the_run(runs):
    """The resumed run goes on from the record's iteration with the Adam
    state restored: its step count goes on from 6 to 12, each iteration's
    ``learning_rate`` is written once and equals ``lr * lr_multiplier``
    of the run's schedule (as in one run, and as the JAX trainer writes
    it); a Trainer on the finished record restores it and its fit() is a
    no-op returning the best metric."""
    synth_root, log_root, log_dir = (runs["synth_root"], runs["log_root"],
                                     runs["log_dir"])
    assert ttrainer.adam_step(runs["after_sup"]["optimizer"]) == 6
    rolled = ck.restore_checkpoint(join(log_dir, "checkpoints"))
    assert ttrainer.adam_step(rolled["optimizer"]) == 12
    lr = _scalars(log_dir)["learning_rate"]
    assert sorted(lr) == list(range(12))
    args = tconfig.parse_opt(_argv(synth_root, log_root,
                                   ("--epoch", "2", "--resume_dir",
                                    log_dir)))
    jfn = jtrainer.lr_multiplier
    for it, values in lr.items():
        want = args.lr * float(jfn(it, steps_sup=6, steps_rl=6,
                                   warmup_epoch=1, start_rl_epoch=1,
                                   epochs=2, rl_lr_initial_decay=0.5))
        assert values == [want], (it, values, want)
    trainer = ttrainer.Trainer(args, "cpu")
    assert (trainer.record_manager.get_epoch(),
            trainer.record_manager.get_iteration()) == (1, 11)
    assert trainer.state.step == 12
    assert trainer.state.optimizer.param_groups[0]["lr"] == \
        args.lr * float(jfn(12, 6, 6, 1, 1, 2, 0.5))
    assert trainer.fit() == pytest.approx(
        trainer.checkpoint_manager.get_best_metric())


def test_resume_with_a_longer_schedule(runs, tmp_path):
    """A resume with a larger ``--epoch`` applies the new schedule from
    its first step, as the JAX trainer rebuilds its lr from the flags:
    at step 12 the run's own schedule (``--epoch 2``) has decayed to 0,
    while ``--epoch 3`` gives 0.25 * lr.  The optimizer's lr right after
    the resume is the new one, and so is every ``learning_rate`` scalar
    (the lr each step applied) of the added SCST epoch."""
    log_dir = str(tmp_path / "run")
    shutil.copytree(runs["log_dir"], log_dir)
    saved = ck.restore_checkpoint(join(log_dir, "checkpoints"))["optimizer"]
    args = tconfig.parse_opt(_argv(runs["synth_root"], str(tmp_path),
                                   ("--epoch", "3", "--resume_dir",
                                    log_dir)))
    jfn = jtrainer.lr_multiplier
    old = saved["param_groups"][0]["lr"]
    assert old == args.lr * float(jfn(12, 6, 6, 1, 1, 2, 0.5)) == 0.0
    np.random.seed(args.seed)
    trainer = ttrainer.Trainer(args, "cpu")
    want = args.lr * float(jfn(12, 6, 6, 1, 1, 3, 0.5))
    assert want > 0
    assert trainer.state.optimizer.param_groups[0]["lr"] == want
    trainer.fit()
    assert _record(log_dir)["iteration"] == 17
    assert ttrainer.adam_step(ck.restore_checkpoint(
        join(log_dir, "checkpoints"))["optimizer"]) == 18
    lr = _scalars(log_dir)["learning_rate"]
    assert sorted(lr) == list(range(18))
    for it in range(12, 18):
        assert lr[it] == [args.lr * float(jfn(it, 6, 6, 1, 1, 3, 0.5))], it


@pytest.mark.parametrize("device_eval", ["false", "true"])
def test_cli_test_driver_on_the_port_run(runs, device_eval):
    """cli/test.py evaluates the run the port trained, with the model of
    the run's own checkpoint_best.pth."""
    synth_root, log_root, log_dir = (runs["synth_root"], runs["log_root"],
                                     runs["log_dir"])
    argv = _argv(synth_root, log_root, ("--evaluation_dir", log_dir,
                                        "--device_eval", device_eval))
    metrics = tcli_test.main(argv + ["--device", "cpu"])
    assert set(metrics) >= {"MultiMatch", "ScanMatch", "VAME"}
    assert set(metrics["ScanMatch"]) == {"w/o duration", "with duration"}
    with open(join(log_dir, "test_predicts.json")) as f:
        preds = json.load(f)
    assert len(preds) == 12     # 6 test images x eval_repeat_num 2
    assert set(preds[0]) == {"name", "repeat_id", "X", "Y", "T", "length"}
    assert exists(join(log_dir, "log_test.txt"))
    ev = ttrainer.Evaluator(tconfig.parse_opt(argv), log_dir, "cpu")
    want = port.load_reference_state_dict(
        ck.restore_best_checkpoint(join(log_dir, "checkpoints")), "osie")
    got = ev.model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    # one stream's decodes as host fixation vectors, repeat-major
    batch = next(iter(tcli_test.Loader(tcli_test.EvaluationDataset(
        "osie", ttrainer.data_config(ev.args), "test"), batch_size=4)))
    preds = ev.decode_batch(batch, 3)
    assert len(preds) == 3 * 4 and all(p.ndim == 1 for p in preds)


@pytest.mark.parametrize("task", ["air", "coco"])
def test_task_end_to_end(task, synth_root, tmp_path):
    """AiR and COCO through cli.train (one supervised and one SCST epoch)
    and cli.test on the run: AiR's answer-bucketed validation and its
    same/different-group rewards, COCO's validation_predicts.json."""
    log_root = str(tmp_path / f"{task}_logs")
    argv = _task_argv(task, synth_root, log_root)
    best = tcli_train.main(argv + ["--device", "cpu"])
    log_dir = _run_dir(log_root)
    assert best == _record(log_dir)["best_metric"] > 0
    tags = set(_scalars(log_dir))
    if task == "air":
        assert any(t.startswith("metrics/right_answer-") for t in tags)
        assert any(t.startswith("metrics/wrong_answer-") for t in tags)
        assert "reward_same_hmean" in tags
    else:
        assert {"reward_hmean", "reward_wod", "reward_wd"} <= tags
    metrics = tcli_test.main(argv + ["--evaluation_dir", log_dir,
                                     "--device", "cpu"])
    if task == "air":
        assert {"right_answer", "wrong_answer", "all"} <= set(metrics)
        name, keys = "test", {"img_names", "qid", "performance"}
    else:
        assert set(metrics) >= {"MultiMatch", "ScanMatch", "VAME"}
        name, keys = "validation", {"img_names", "task"}
    with open(join(log_dir, f"{name}_predicts.json")) as f:
        preds = json.load(f)
    assert set(preds[0]) == keys | {"repeat_id", "X", "Y", "T", "length"}


# ---------------------------------------------------------------------------
# parity with the JAX trainer
# ---------------------------------------------------------------------------

def test_batches_match_the_jax_trainer(runs):
    jnames, tnames = runs["jax_names"], runs["names"]
    assert len(jnames["sup"]) == len(jnames["rl"]) == 6
    assert tnames == jnames


def test_scalars_and_record_match_the_jax_trainer(runs):
    """The port's run (resumed after its supervised epoch) against the
    JAX trainer's run in one go: the same scalar tags, the
    ``learning_rate`` of every iteration exactly, the losses of each
    supervised and SCST step, the selection metric of each validation,
    and the run record."""
    jdir, tdir = runs["jax_dir"], runs["log_dir"]
    js, ts = _scalars(jdir), _scalars(tdir)
    assert set(ts) == set(js)
    assert js["learning_rate"] == ts["learning_rate"]
    assert sorted(ts["learning_rate"]) == list(range(12))
    for tag in ("loss/loss", "loss/loss_actions", "loss/loss_duration"):
        assert sorted(ts[tag]) == sorted(js[tag]) == list(range(6))
        for it in range(6):
            np.testing.assert_allclose(
                ts[tag][it], js[tag][it],
                rtol=FIRST_RTOL if it == 0 else LOSS_RTOL,
                err_msg=f"{tag} at iteration {it}")
    rl_tags = [t for t in js if t == "reward_hmean" or t.startswith(
        ("reward_", "metrics_for_reward/", "rollout_"))]
    assert len(rl_tags) == 14
    for tag in ["rl_loss"] + rl_tags:
        assert sorted(ts[tag]) == sorted(js[tag]) == list(range(6, 12)), tag
        for it in range(6, 12):
            tol = dict(atol=RL_LOSS_ATOL) if tag == "rl_loss" else \
                dict(rtol=REWARD_RTOL)
            np.testing.assert_allclose(ts[tag][it], js[tag][it],
                                       err_msg=f"{tag} at {it}", **tol)
    assert sorted(ts["current metric"]) == sorted(js["current metric"]) \
        == [5, 11]
    for it in (5, 11):
        np.testing.assert_allclose(ts["current metric"][it],
                                   js["current metric"][it],
                                   rtol=METRIC_RTOL)
    jrec, trec = _record(jdir), _record(tdir)
    assert (trec["epoch"], trec["iteration"]) == \
        (jrec["epoch"], jrec["iteration"]) == (1, 11)
    np.testing.assert_allclose(trec["best_metric"], jrec["best_metric"],
                               rtol=METRIC_RTOL)


# ---------------------------------------------------------------------------
# the backbone warm start and the refused flags
# ---------------------------------------------------------------------------

def _torchvision_layout(backbone):
    """The port trunk's weights under torchvision's resnet50 names."""
    out = {}
    for name, v in backbone.state_dict().items():
        if name.startswith("layer"):
            stage_block, rest = name.split(".", 1)
            stage, block = stage_block[len("layer"):].split("_block")
            rest = rest.replace("downsample_conv", "downsample.0") \
                .replace("downsample_bn", "downsample.1")
            name = f"layer{stage}.{block}.{rest}"
        out[name] = v.clone()
    return out


def test_backbone_warm_start(synth_root, tmp_path):
    """--checkpoint loads a torchvision-layout state dict into the trunk;
    a file whose content does not match the sha256 prefix in its name is
    refused."""
    from scanpaths_tpu_torch.models.scanpath_model import ScanpathModel
    src = ScanpathModel("osie", embed=128, seq_len=T, map_h=MH, map_w=MW,
                        backbone_layers=(1, 1, 1, 1)).backbone
    gen = torch.Generator().manual_seed(7)
    resnet.init_weights(src, gen)
    with torch.no_grad():
        src.bn1.running_mean.uniform_(-1, 1, generator=gen)
    tmp = tmp_path / "resnet50.tmp"
    torch.save(_torchvision_layout(src), tmp)
    digest = hashlib.sha256(tmp.read_bytes()).hexdigest()[:8]
    good = tmp_path / f"resnet50-{digest}.pth"
    tmp.rename(good)
    argv = _argv(synth_root, str(tmp_path / "logs"),
                 ("--epoch", "1", "--checkpoint", str(good)))
    trainer = ttrainer.Trainer(tconfig.parse_opt(argv), "cpu")
    got, want = trainer.model.backbone.state_dict(), src.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    bad = tmp_path / f"resnet50-{'0' if digest[0] != '0' else '1'}" \
        f"{digest[1:]}.pth"
    bad.write_bytes(good.read_bytes())
    argv = _argv(synth_root, str(tmp_path / "logs2"),
                 ("--epoch", "1", "--checkpoint", str(bad)))
    with pytest.raises(ValueError, match="sha256"):
        ttrainer.Trainer(tconfig.parse_opt(argv), "cpu")


@pytest.mark.parametrize("flags,item", [
    (("--task", "joint", "--mesh_size", "2"), "A13"),
    (("--mesh_size", "2"), "A13"),
    (("--model_parallel", "2"), "A13"),
    (("--ckpt_backend", "orbax"), "A17"),
    (("--bf16_moments", "true"), "A18"),
    (("--stem_impl", "s2d"), "North star"),
])
def test_refused_flags(flags, item, synth_root, tmp_path):
    argv = _argv(synth_root, str(tmp_path), ("--epoch", "1", *flags,
                                             "--device", "cpu"))
    with pytest.raises(NotImplementedError, match=item):
        tcli_train.main(argv)
    assert not os.listdir(tmp_path)


def test_cuda_without_a_card_raises(synth_root, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli_train.main(_argv(synth_root, str(tmp_path), ("--epoch", "1")))
