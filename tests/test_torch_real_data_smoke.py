"""The real-data readiness drive (``scanpaths_tpu_torch/tools/
real_data_smoke.py``) on the CPU against the JAX tool
(``tools/real_data_smoke.py``):

* on an empty root both tools write the same skip report and exit 0;
* the reference prediction schemas are the JAX tool's;
* the OSIE section end to end on ``tests/test_real_data_smoke.py``'s
  synthesized release layout (``tools/synth.py::make_osie_release``) at
  its tiny geometry: preprocess, two supervised steps of the
  ``Trainer``, a validation, ``cli/test.py``'s artifact in the
  reference schema;
* a reference-layout ``.pth`` written by the JAX package's
  ``export_reference_state_dict`` loads through
  ``port_released_checkpoint``, and the port model then gives the JAX
  model's eval forward (atol = rtol = 5e-5, ``tests/test_torch_slice.py``'s
  trunk bound);
* a released checkpoint that does not load, or a section that raises,
  makes ``main`` return 1 with the error in the report (the JAX tool
  returns 0).
"""

import json
import sys

import jax
import numpy as np
import pytest
import torch

from scanpaths_tpu.models.port import export_reference_state_dict
from scanpaths_tpu.models.scanpath_model import create_model
from scanpaths_tpu_torch.tools import real_data_smoke as rds
from scanpaths_tpu_torch.tools import synth

TINY = ["--", "--height", "40", "--width", "48", "--map_height", "5",
        "--map_width", "6", "--max_length", "4", "--rl_sample_number", "2",
        "--half_precision", "false"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_tensorboard():
    """scalars.jsonl alone: importing TensorBoard pulls in TensorFlow,
    seconds a process.  Only that module's entry is set and restored."""
    name = "torch.utils.tensorboard"
    had, old = name in sys.modules, sys.modules.get(name)
    sys.modules[name] = None
    yield
    if had:
        sys.modules[name] = old
    else:
        del sys.modules[name]


def _report(path):
    with open(path) as f:
        return json.load(f)


def test_skip_report_equals_the_jax_tool(tmp_path):
    from tools import real_data_smoke as jax_rds
    root = str(tmp_path / "nothing")
    assert jax_rds.main(["--root", root, "--out",
                         str(tmp_path / "jax.json")]) == 0
    assert rds.main(["--root", root, "--out", str(tmp_path / "port.json"),
                     "--device", "cpu"]) == 0
    want, got = _report(tmp_path / "jax.json"), _report(tmp_path /
                                                        "port.json")
    assert got == want
    assert got["all_skipped"] is True and got["trunk"]["skipped"] is True
    assert [(r["task"], r["skipped"]) for r in got["tasks"]] == [
        ("osie", True), ("air", True), ("coco", True)]


def test_schema_equals_the_jax_tool():
    from tools import real_data_smoke as jax_rds
    assert rds.REFERENCE_PREDICT_SCHEMA == jax_rds.REFERENCE_PREDICT_SCHEMA


def test_osie_section_end_to_end(tmp_path, no_tensorboard):
    root = str(tmp_path / "real")
    synth.make_osie_release(root, np.random.default_rng(0))
    out = tmp_path / "smoke.json"
    rc = rds.main([
        "--root", root, "--task", "osie", "--steps", "2", "--batch", "4",
        "--eval_repeat_num", "1", "--device_eval", "false", "--device",
        "cpu", "--workdir", str(tmp_path / "work"), "--out", str(out),
        "--backbone_layers", "1,1,1,1", "--embed", "128", *TINY])
    rep = _report(out)
    assert rc == 0, rep
    (osie,) = rep["tasks"]
    assert not osie.get("skipped") and "error" not in osie, osie
    assert osie["preprocess_records"] == {"train": 32, "validation": 4,
                                          "test": 8}
    assert osie["train_steps"] == 2
    assert np.isfinite(osie["loss_last"])
    assert np.isfinite(osie["validation_selection_metric"])
    assert osie["predict_artifact"] == "test_predicts.json"
    assert osie["predict_schema_ok"] is True


def test_jax_exported_checkpoint_gives_the_jax_forward(tmp_path):
    """The JAX exporter takes the full 30x40 map only; a thin trunk and
    embed 16 keep it cheap, and two decode steps (the port model's
    ``seq_len`` set to the JAX model's; the weights do not depend on
    it)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 240, 320, 3)).astype(np.float32)
    jm = create_model("osie", seq_len=2, embed=16,
                      backbone_layers=(1, 1, 1, 1))
    vs = jax.jit(lambda k: jm.init(k, x, train=False))(
        jax.random.PRNGKey(0))
    sd = export_reference_state_dict(vs["params"], vs["batch_stats"],
                                     "osie")
    path = str(tmp_path / "checkpoint_best.pth")
    torch.save({"model": {f"module.{k}": torch.from_numpy(np.array(v))
                          for k, v in sd.items()}}, path)
    report = {}
    model = rds.port_released_checkpoint(path, "osie", report)
    rec = report["released_checkpoint"]
    assert rec["ok"] is True and rec["sha256"] == rds.sha256_of(path)
    assert rec["geometry"] == dict(embed=16, map_h=30, map_w=40,
                                   backbone_layers=(1, 1, 1, 1))
    assert rec["ported_params"] == sum(
        v.size for v in jax.tree.leaves(vs["params"]))
    model.seq_len = 2
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(vs, x)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=5e-5, rtol=5e-5, err_msg=k)


@pytest.mark.parametrize("fault", ["checkpoint", "fixations"])
def test_a_failure_makes_main_return_1(tmp_path, fault):
    root = tmp_path / "real"
    synth.make_osie_release(str(root), np.random.default_rng(0),
                            n_trainval=1, n_test=1, n_subjects=2)
    if fault == "checkpoint":
        (root / "osie" / "checkpoint_best.pth").write_bytes(b"not a pth")
    else:
        (root / "osie" / "fixations.mat").write_bytes(b"not a mat")
    out = tmp_path / "smoke.json"
    assert rds.main(["--root", str(root), "--task", "osie", "--device",
                     "cpu", "--workdir", str(tmp_path / "work"), "--out",
                     str(out)]) == 1
    (osie,) = _report(out)["tasks"]
    assert "train_steps" not in osie
    if fault == "checkpoint":
        # the section preprocessed, then ended at the load
        assert sum(osie["preprocess_records"].values()) == 4
        assert osie["released_checkpoint"]["ok"] is False
        assert osie["released_checkpoint"]["error"]
    else:
        assert osie["ok"] is False and osie["error"]
