"""The port's checkpoint managers (``utils/checkpointing.py``): the
asynchronous one (``--ckpt_backend orbax``) held to the synchronous one
and to the JAX managers' semantics (``tests/test_checkpoint_backends.py``
is the model): the triad and best rules for both backends, then, for
the writer thread, a host copy taken before ``step()`` returns, crash
safety and a writer's error raised, ``close()`` twice and a ``step``
after it."""

import os
import threading
from collections import OrderedDict
from unittest import mock

import pytest
import torch

from scanpaths_tpu_torch.utils import checkpointing as ck


def _model_state(scale: float):
    return OrderedDict([
        ("w", torch.full((2, 3), scale)),
        ("head.b", torch.full((4,), scale, dtype=torch.bfloat16)),
        ("bn.num_batches_tracked", torch.tensor(int(scale)))])


def _opt_state(scale: float):
    return {"state": {0: {"step": torch.tensor(scale),
                          "exp_avg": torch.full((2, 3), scale,
                                                dtype=torch.bfloat16),
                          "exp_avg_sq": torch.full((2, 3), scale)}},
            "param_groups": [{"lr": 1e-4, "betas": (0.9, 0.999),
                              "params": [0]}]}


def _equal(a, b) -> bool:
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and \
            torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and \
            all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("backend", ["msgpack", "orbax"])
def test_triad_and_best_semantics(tmp_path, backend):
    """The rolling checkpoint every step, the best on improvement (a
    falsy initial best adopts the first metric, ties improve), dtypes
    kept; in min mode lower is better."""
    d = str(tmp_path / "checkpoints")
    mgr = ck.make_checkpoint_manager(d, mode="max", backend=backend)
    assert isinstance(mgr, ck.AsyncCheckpointManager) == \
        (backend == "orbax")
    mgr.step(0.5, _model_state(1.0), _opt_state(1.0))
    assert mgr.get_best_metric() == 0.5
    mgr.step(0.3, _model_state(2.0), _opt_state(2.0))    # worse
    assert mgr.get_best_metric() == 0.5
    mgr.wait()
    rolled = ck.restore_checkpoint(d)
    assert _equal(rolled["model"], _model_state(2.0))
    assert _equal(rolled["optimizer"], _opt_state(2.0))
    assert _equal(ck.restore_best_checkpoint(d), _model_state(1.0))
    mgr.step(0.5, _model_state(3.0), _opt_state(3.0))    # a tie improves
    mgr.close()
    best = ck.restore_best_checkpoint(d)
    assert _equal(best, _model_state(3.0))
    assert best["head.b"].dtype == torch.bfloat16
    assert sorted(os.listdir(d)) == ["checkpoint.pth", "checkpoint_best.pth"]

    d2 = str(tmp_path / "min")
    mgr = ck.make_checkpoint_manager(d2, mode="min", backend=backend)
    mgr.step(0.9, _model_state(1.0))
    mgr.step(0.2, _model_state(2.0))
    mgr.close()
    assert mgr.get_best_metric() == 0.2
    assert _equal(ck.restore_best_checkpoint(d2), _model_state(2.0))


def test_async_files_equal_the_synchronous_ones(tmp_path):
    """The same sequence of states through both managers: after
    ``close()`` the two directories' files load equal."""
    dirs = {b: str(tmp_path / b) for b in ("msgpack", "orbax")}
    for backend, d in dirs.items():
        mgr = ck.make_checkpoint_manager(d, backend=backend)
        for i, metric in enumerate((0.4, 0.6, 0.5)):
            mgr.step(metric, _model_state(i + 1.0), _opt_state(i + 1.0))
        mgr.close()
    for name in ("checkpoint.pth", "checkpoint_best.pth"):
        a, b = (ck.load(os.path.join(d, name)) for d in dirs.values())
        assert _equal(a, b), name


def test_step_copies_the_state_before_it_returns(tmp_path):
    """A mutation of the live tensors after ``step()`` (the next optimizer
    step overwrites them in place) does not reach the file, even while
    the write is still held back."""
    release = threading.Event()
    real = ck.save

    def held(path, obj):
        release.wait(10)
        real(path, obj)
    d = str(tmp_path)
    mgr = ck.AsyncCheckpointManager(d)
    model, opt = _model_state(1.0), _opt_state(1.0)
    with mock.patch.object(ck, "save", held):
        mgr.step(0.5, model, opt)
        for t in model.values():
            t.add_(7)
        opt["state"][0]["exp_avg"].mul_(3)
        release.set()
        mgr.close()
    assert _equal(ck.restore_checkpoint(d),
                  {"model": _model_state(1.0), "optimizer": _opt_state(1.0)})
    assert _equal(ck.restore_best_checkpoint(d), _model_state(1.0))


def test_writer_error_is_raised_and_the_previous_file_survives(tmp_path):
    """A write that fails midway (half a file on the temporary name)
    leaves the previous checkpoint loadable under the final name, and the
    error is raised, once, from the next ``step``, ``wait`` or
    ``close``."""
    d = str(tmp_path)
    mgr = ck.AsyncCheckpointManager(d)
    mgr.step(0.5, _model_state(1.0), _opt_state(1.0))
    mgr.wait()

    def broken(obj, path):
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04 half a zip")
        raise OSError("disk full")
    with mock.patch.object(torch, "save", broken):
        mgr.step(0.1, _model_state(2.0), _opt_state(2.0))
        with pytest.raises(OSError, match="disk full"):
            mgr.step(0.2, _model_state(3.0), _opt_state(3.0))
        assert _equal(ck.restore_checkpoint(d)["model"], _model_state(1.0))
        mgr.wait()
        mgr.step(0.2, _model_state(3.0), _opt_state(3.0))
        with pytest.raises(OSError, match="disk full"):
            mgr.wait()
        mgr.step(0.3, _model_state(4.0), _opt_state(4.0))
        with pytest.raises(OSError, match="disk full"):
            mgr.close()
    assert _equal(ck.restore_checkpoint(d)["model"], _model_state(1.0))
    assert _equal(ck.restore_best_checkpoint(d), _model_state(1.0))


def test_close_twice_and_step_after_close(tmp_path):
    mgr = ck.AsyncCheckpointManager(str(tmp_path))
    mgr.step(0.5, _model_state(1.0), _opt_state(1.0))
    mgr.close()
    mgr.close()
    assert not any(t.is_alive() for t in mgr._writer._threads)
    with pytest.raises(RuntimeError, match="after close"):
        mgr.step(0.6, _model_state(2.0))
    ck.CheckpointManager(str(tmp_path / "sync")).close()


def test_unknown_backend_and_jax_runs_raise(tmp_path):
    with pytest.raises(ValueError, match="unknown checkpoint backend"):
        ck.make_checkpoint_manager(str(tmp_path), backend="zarr")
    open(tmp_path / "checkpoint.orbax", "w").close()
    with pytest.raises(RuntimeError, match="JAX run"):
        ck.make_checkpoint_manager(str(tmp_path), backend="orbax")


def test_host_copy_keeps_structure():
    state = {"a": [torch.ones(3), (torch.zeros(2, dtype=torch.bfloat16),
                                   5)], "b": "text"}
    copy = ck.host_copy(state)
    assert _equal(copy, state)
    assert copy["a"][0].data_ptr() != state["a"][0].data_ptr()
    assert isinstance(copy["a"][1], tuple)


def test_writes_record_each_file(tmp_path):
    """``writes`` names each file written, its ms and its size."""
    mgr = ck.AsyncCheckpointManager(str(tmp_path))
    mgr.step(0.5, _model_state(1.0), _opt_state(1.0))
    mgr.step(0.4, _model_state(2.0), _opt_state(2.0))
    mgr.close()
    assert [w[0] for w in mgr.writes] == [
        "checkpoint.pth", "checkpoint_best.pth", "checkpoint.pth"]
    assert all(ms > 0 for _, ms, _ in mgr.writes)
    assert mgr.writes[-1][2] == os.path.getsize(mgr.path)
