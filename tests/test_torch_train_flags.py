"""The trainer's last two flags on the CPU: ``--bf16_moments true``
(the port's bfloat16-moment Adam, ``train/schedule.py::Adam``) through
``cli/train.py`` for one task and for ``--task joint``, and
``--ckpt_backend orbax`` (the checkpoint triad written on a writer
thread, ``utils/checkpointing.py::AsyncCheckpointManager``): a run and
its resume write the same files as the synchronous backend's, and the
``_supervised_save`` copy holds the epoch's checkpoint even when its
write lands late (the trainer waits for it before the copy).

Geometry: ``test_torch_trainer``'s tiny argv (40x48 images, a 5x6 map,
T = 4, embed 128, trunk (1,1,1,1)); torch on one intra-op thread, so two
runs of one argv are bit-equal; TensorBoard not imported
(``scalars.jsonl`` alone).
"""

import json
import math
import os
import shutil
import time
from os.path import join
from unittest import mock

import pytest
import torch

import test_torch_eval_ranks
import test_torch_joint_run as tjoint
import test_torch_trainer as ttrainer
from scanpaths_tpu_torch.cli import train as tcli_train
from scanpaths_tpu_torch.utils import checkpointing as ck


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    from tools.make_synth_data import make_all
    root = tmp_path_factory.mktemp("torch_flags_data")
    make_all(str(root), osie=dict(n_images=4, n_subjects=3),
             air=dict(n_questions=3, n_subjects=3),
             coco=dict(n_images=3, n_subjects=3))
    return str(root)


def _train(argv):
    with test_torch_eval_ranks._no_tensorboard():
        return tcli_train.main(argv + ["--device", "cpu"])


def _run_dir(log_root):
    runs = [d for d in os.listdir(log_root)
            if d.startswith("log_") and not d.endswith("_supervised_save")]
    assert len(runs) == 1, runs
    return join(log_root, runs[0])


def _scalars(run):
    with open(join(run, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def _load(path):
    return torch.load(path, weights_only=True)


def _equal(a, b, path=""):
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


@pytest.mark.parametrize("kind,epochs", [("osie", 2), ("joint", 1)])
def test_bf16_moments_run(kind, epochs, synth_root, tmp_path):
    """cli/train.py --bf16_moments true (OSIE a supervised and an SCST
    epoch, the joint model a supervised one): every training scalar
    finite, the saved first moments bfloat16, the second float32."""
    log_root = str(tmp_path)
    argv = (tjoint._argv(synth_root, log_root) if kind == "joint"
            else ttrainer._argv(synth_root, log_root))
    _train(argv + ["--epoch", str(epochs), "--bf16_moments", "true"])
    run = _run_dir(log_root)
    losses = [r for r in _scalars(run) if r["tag"].endswith(
        ("loss/loss", "rl_loss"))]
    assert len(losses) >= 2
    assert all(math.isfinite(r["value"]) for r in losses)
    opt = _load(join(run, "checkpoints", "checkpoint.pth"))["optimizer"]
    assert int(opt["state"][0]["step"]) == len(losses)
    assert all(st["exp_avg"].dtype == torch.bfloat16
               and st["exp_avg_sq"].dtype == torch.float32
               for st in opt["state"].values())


def test_async_run_and_resume_equal_sync(synth_root, tmp_path):
    """The same run and resume with each backend: equal rolling and best
    checkpoints, an equal ``_supervised_save`` copy of the first epoch's
    checkpoint (each async write held back 0.3 s, so the copy has it
    only because the trainer waits for the write), equal scalars."""
    real = ck.save

    def late(path, obj):
        time.sleep(0.3)
        real(path, obj)

    runs = {}
    for backend in ("msgpack", "orbax"):
        log_root = str(tmp_path / backend)
        argv = ttrainer._argv(synth_root, log_root) + [
            "--epoch", "2", "--ckpt_backend", backend]
        with mock.patch.object(ck, "save", late if backend == "orbax"
                               else real):
            _train(argv)
            run = _run_dir(log_root)
            saved = join(run + "_supervised_save", "checkpoints",
                         "checkpoint.pth")
            first = _load(saved)
            _train(argv + ["--epoch", "3", "--resume_dir", run])
        runs[backend] = (run, first)
    (sync, sync_first), (run, first) = runs["msgpack"], runs["orbax"]
    _equal(first, sync_first, "supervised_save")
    for name in ("checkpoint.pth", "checkpoint_best.pth"):
        _equal(_load(join(run, "checkpoints", name)),
               _load(join(sync, "checkpoints", name)), name)
    assert sorted(os.listdir(join(run, "checkpoints"))) == \
        ["checkpoint.pth", "checkpoint_best.pth"]
    drop = ("perf/",)
    assert [r for r in _scalars(run) if not r["tag"].startswith(drop)] == \
        [r for r in _scalars(sync) if not r["tag"].startswith(drop)]
    shutil.rmtree(str(tmp_path), ignore_errors=True)
