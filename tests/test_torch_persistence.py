"""The port's persistence and input pieces on the CPU: the checkpoint
manager's triad and best semantics (as ``tests/test_checkpoint_backends.py``
holds the JAX package's msgpack backend), the reference-layout ``.pth``
round trip of a model and its Adam state, the refusal of a JAX run's
checkpoints, the run record, the prefetch
thread, and the port's batches against the JAX package's, bit for bit,
with and without the packed image store and the native batch assembly
(``SP_NATIVE=0``)."""

import json
import os
from os.path import join

import numpy as np
import pytest
import torch

from scanpaths_tpu import native as jnative
from scanpaths_tpu.core import config as jconfig
from scanpaths_tpu.data import datasets as jdata
from scanpaths_tpu.train import trainer as jtrainer
from scanpaths_tpu_torch import native as tnative
from scanpaths_tpu_torch.data import datasets as tdata
from scanpaths_tpu_torch.data.prefetch import prefetch
from scanpaths_tpu_torch.models import port
from scanpaths_tpu_torch.models.scanpath_model import (ScanpathModel,
                                                       init_weights)
from scanpaths_tpu_torch.train import steps as tsteps
from scanpaths_tpu_torch.train import trainer as ttrainer
from scanpaths_tpu_torch.utils import checkpointing as ck
from scanpaths_tpu_torch.utils.recording import RecordManager

GEOM = dict(map_h=5, map_w=6, seq_len=4, embed=32)
LAYERS = (1, 1, 1, 1)



@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One torch intra-op thread for this module: its ops are too small
    to gain from more (the AiR run takes half the time on one), and the
    suite runs several test processes side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _model_state(scale: float):
    return {"w": torch.full((2, 3), scale),
            "head.b": torch.full((4,), scale, dtype=torch.bfloat16),
            "bn.running_mean": torch.full((3,), scale)}


def _opt_state(scale: float):
    p = torch.nn.Parameter(torch.full((2, 3), scale))
    opt = torch.optim.Adam([p], lr=1e-3)
    p.grad = torch.ones_like(p)
    opt.step()
    return opt.state_dict()


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def test_triad_and_best_semantics(tmp_path):
    d = str(tmp_path / "checkpoints")
    mgr = ck.CheckpointManager(d, mode="max")
    m1, m2, m3 = _model_state(1.0), _model_state(2.0), _model_state(3.0)
    o1, o2 = _opt_state(1.0), _opt_state(2.0)

    mgr.step(0.5, m1, o1)          # falsy initial best -> adopt
    assert mgr.get_best_metric() == 0.5
    mgr.step(0.3, m2, o2)          # worse: rolling updates, best does not
    assert mgr.get_best_metric() == 0.5
    assert sorted(os.listdir(d)) == ["checkpoint.pth", "checkpoint_best.pth"]

    rolled = ck.restore_checkpoint(d)
    assert _equal(rolled["model"], m2)
    assert _equal(rolled["optimizer"], o2)
    best = ck.restore_best_checkpoint(d)
    assert _equal(best, m1)
    assert best["head.b"].dtype == torch.bfloat16

    mgr.step(0.5, m3, None)        # tie counts as improvement
    assert _equal(ck.restore_best_checkpoint(d), m3)
    assert ck.load(join(d, "checkpoint_best.pth")).keys() == {"model"}


def test_min_mode_and_a_fresh_manager(tmp_path):
    d = str(tmp_path / "ck")
    mgr = ck.CheckpointManager(d, mode="min")
    m1, m2 = _model_state(1.0), _model_state(2.0)
    mgr.step(0.9, m1, None)
    mgr.step(0.2, m2, None)        # lower is better in min mode
    assert mgr.get_best_metric() == 0.2
    assert _equal(ck.restore_best_checkpoint(d), m2)
    # a new manager (a resumed process) keeps the recorded best
    mgr2 = ck.CheckpointManager(d, mode="min", best_metric=0.2)
    mgr2.step(0.4, m1, None)
    assert _equal(ck.restore_best_checkpoint(d), m2)
    assert _equal(ck.restore_checkpoint(d)["model"], m1)
    with pytest.raises(ValueError, match="mode"):
        ck.CheckpointManager(d, mode="median")


@pytest.mark.parametrize("name", ["checkpoint.msgpack",
                                  "checkpoint_best.msgpack",
                                  "checkpoint.orbax", "checkpoint.orbax.old"])
def test_a_jax_run_is_refused(tmp_path, name):
    d = tmp_path / "checkpoints"
    d.mkdir()
    (d / name).write_bytes(b"flax")
    for call in (lambda: ck.CheckpointManager(str(d)),
                 lambda: ck.restore_checkpoint(str(d)),
                 lambda: ck.restore_best_checkpoint(str(d))):
        with pytest.raises(RuntimeError, match="JAX run"):
            call()


@pytest.mark.parametrize("task", ["osie", "air", "coco"])
def test_model_and_adam_state_round_trip_through_pth(task, tmp_path):
    """A model after one Adam step, written as the trainer writes it (the
    reference layout and the Adam state_dict), reads back into a fresh
    model and optimizer equal to the originals, tensor for tensor."""
    model = ScanpathModel(task, backbone_layers=LAYERS, **GEOM)
    init_weights(model, 1)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    mgr = ck.CheckpointManager(str(tmp_path))
    mgr.step(0.1, port.to_reference_state_dict(model.state_dict(), task,
                                               GEOM["map_h"], GEOM["map_w"]),
             opt.state_dict())
    restored = ck.restore_checkpoint(str(tmp_path))
    fresh = ScanpathModel(task, backbone_layers=LAYERS, **GEOM)
    fresh.load_state_dict(port.load_reference_state_dict(restored["model"],
                                                         task))
    assert _equal(fresh.state_dict(), model.state_dict())
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-3)
    fresh_opt.load_state_dict(restored["optimizer"])
    assert _equal(fresh_opt.state_dict(), opt.state_dict())
    assert ttrainer.adam_step(restored["optimizer"]) == 1
    # the reference layout: the test and predict drivers read it as is
    best = ck.restore_best_checkpoint(str(tmp_path))
    assert "resnet.0.weight" in best and not any(
        k.startswith("backbone.") for k in best)


def test_record_manager(tmp_path):
    rm = RecordManager(str(tmp_path))
    rm.init_record()
    assert (rm.get_epoch(), rm.get_iteration(), rm.get_best_metric()) == \
        (-1, -1, None)
    rm.save(3, 41, 0.25)
    again = RecordManager(str(tmp_path))
    again.load()
    assert again.record == {"epoch": 3, "iteration": 41, "best_metric": 0.25}
    with open(tmp_path / "history_record.json") as f:
        assert json.load(f)["iteration"] == 41


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_keeps_order_and_raises(depth):
    batches = [{"images": np.full((2, 4, 4, 3), i, np.float32),
                "gt_fix": np.zeros((2, 1, 2, 3), np.float32),
                "gt_len": np.ones((2, 1), np.int32),
                "gt_mask": np.ones((2, 1), np.float32)} for i in range(5)]

    def transfer(b):
        return tsteps.device_batch(b, "cpu", for_rl=True)
    got = list(prefetch(batches, transfer, depth=depth))
    assert [float(b["images"][0, 0, 0, 0]) for b in got] == list(range(5))
    assert set(got[0]) == {"images", "gt_fix", "gt_len", "gt_mask"}

    def failing():
        yield batches[0]
        raise OSError("disk gone")
    it = iter(prefetch(failing(), transfer, depth=depth))
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    from tools.make_synth_data import make_all
    root = tmp_path_factory.mktemp("persist_data")
    make_all(str(root))
    return str(root)


def _task_args(task, root, extra=()):
    sub = {"osie": ("stimuli", ()), "air": ("stimuli", (
        "--att_dir", join(root, "air", "attention"))),
        "coco": ("images", ("--detector_dir",
                            join(root, "coco", "detectors")))}[task]
    return jconfig.parse_opt([
        "--task", task, "--img_dir", join(root, task, sub[0]),
        "--fix_dir", join(root, task, "fixations"), "--height", "40",
        "--width", "48", "--map_height", "5", "--map_width", "6",
        "--max_length", "4", *sub[1], *extra])


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


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("task", ["osie", "air", "coco"])
def test_batches_equal_the_jax_packages(task, use_native, packed, synth_root,
                                        tmp_path, monkeypatch):
    """The train loaders' shuffled batches (supervised and SCST views)
    and the validation batches, key by key and bit for bit, against the
    JAX package's, with the packed image store on and off and the native
    assembly on and off (``SP_NATIVE=0``; the blurred soft targets in
    the supervised case, which the native path gathers from its
    table)."""
    if not use_native:
        monkeypatch.setenv("SP_NATIVE", "0")
    elif not jnative.available():
        pytest.skip("the native library does not build here (no g++), as "
                    "tests/test_native.py skips")
    extra = ("--blur_sigma", "1.0")
    if packed:
        extra += ("--packed_cache_dir", str(tmp_path / "packed"))
    args = _task_args(task, synth_root, extra)
    assert tnative.available() == jnative.available() == use_native
    for view, split, kw in (
            ("SupervisedDataset", "train",
             dict(batch_size=4, shuffle=True, seed=3, drop_last=True)),
            ("EvaluationDataset", "train",
             dict(batch_size=2, shuffle=True, seed=4, drop_last=True)),
            ("EvaluationDataset", "validation", dict(batch_size=4))):
        jds = getattr(jdata, view)(task, jtrainer.data_config(args), split)
        tds = getattr(tdata, view)(task, ttrainer.data_config(args), split)
        assert (tds._images.packed is not None) == packed
        jb, tb = list(jdata.Loader(jds, **kw)), list(tdata.Loader(tds, **kw))
        assert len(jb) == len(tb) > 0
        for a, b in zip(jb, tb):
            _assert_batches_equal(a, b)
    if packed:
        assert any(f.endswith(".npy") for f in os.listdir(tmp_path / "packed"))
