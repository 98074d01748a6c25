"""The port's evaluation slice against the JAX package, on the CPU: the
device sweep (``metrics/device_eval.py``), the eval split's data, the
copied host modules, the reference-layout exporter, and the whole
``cli.test`` path at small geometry.

Scanpaths and the synthetic OSIE split come from seeded numpy
generators; model weights from a flax init handed to both packages
(``models/port.from_jax_params``).  Tolerances: the pair rows at rtol
1e-5 / atol 1e-6 (float ``exp``/``atan2``/cumsum differ in the last bit
between ATen and XLA); the aggregated metric trees at the host suite's
bound, rtol 2e-4 / atol 2e-5 (tests/test_device_eval.py).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanpaths_tpu.core import config as jconfig
from scanpaths_tpu.core.grid import GridSpec, fix_vector, pad_fix_vectors
from scanpaths_tpu.data import datasets as jdata
from scanpaths_tpu.metrics import device_eval as jdev
from scanpaths_tpu.metrics import evaluation as jheval
from scanpaths_tpu.metrics import jax_metrics as jm
from scanpaths_tpu.models.scanpath_model import create_model
from scanpaths_tpu.ops import sampling as js
from scanpaths_tpu.train import trainer as jtrainer
from scanpaths_tpu_torch.cli import test as tcli
from scanpaths_tpu_torch.core import config as tconfig
from scanpaths_tpu_torch.data import datasets as tdata
from scanpaths_tpu_torch.metrics import device_eval as tdev
from scanpaths_tpu_torch.metrics import evaluation as theval
from scanpaths_tpu_torch.metrics import torch_metrics as tm
from scanpaths_tpu_torch.models import port
from scanpaths_tpu_torch.models.scanpath_model import ScanpathModel
from scanpaths_tpu_torch.ops import sampling as ts
from scanpaths_tpu_torch.train import trainer as ttrainer

ROW_TOL = dict(rtol=1e-5, atol=1e-6, equal_nan=True)
TREE_TOL = dict(rtol=2e-4, atol=2e-5)
GEOM = dict(map_h=10, map_w=12, seq_len=4, embed=64,
            backbone_layers=(1, 1, 1, 1))
FLAGS = ["--task", "osie", "--map_height", "10", "--map_width", "12",
         "--height", "80", "--width", "96", "--max_length", "4",
         "--backbone_layers", "1,1,1,1", "--embed", "64", "--batch", "2",
         "--seed", "3"]


def _assert_tree(want, got, path=""):
    assert set(want) == set(got), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree(want[k], got[k], f"{path}/{k}")
        else:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       err_msg=f"{path}/{k}", **TREE_TOL)


def _grid_path(rng, n):
    return fix_vector(rng.integers(0, 40, n) * 8 + 4.0,
                      rng.integers(0, 30, n) * 8 + 4.0,
                      rng.integers(2, 12, n) * 0.05)


def _padded_gt(rng, n_img, n_subj, length):
    gts = [[_grid_path(rng, 2 if (i, s) == (1, 0) else
                       int(rng.integers(3, 9))) for s in range(n_subj)]
           for i in range(n_img)]
    packed = [pad_fix_vectors(g, length, n_subj) for g in gts]
    return gts, [np.stack([p[k] for p in packed]) for k in range(3)]


def _spec_pair(wd_symbols, wod_symbols):
    kw = [dict(temp_bin=50.0, max_symbols=wd_symbols),
          dict(temp_bin=0.0, max_symbols=wod_symbols)]
    return ([jm.ScanMatchSpec(**k) for k in kw],
            [tm.ScanMatchSpec(**k) for k in kw])


def test_pair_and_human_rows_match_jax(rng):
    """pair_rows and the ordered subject-vs-subject rows against the JAX
    sweep's, row by row; the human matrix is not symmetric (STDE,
    MultiMatch), so a transposed layout would fail."""
    gts, (gt_fix, gt_len, _) = _padded_gt(rng, 3, 4, 10)
    preds = [_grid_path(rng, int(rng.integers(3, 9))) for _ in range(3)]
    pred_fix, pred_len = pad_fix_vectors(preds, 10)
    (jwd, jwod), (twd, twod) = _spec_pair(128, 10)
    t = torch.from_numpy
    want = np.asarray(jdev.pair_rows(jwd, jwod, gt_fix, gt_len, pred_fix,
                                     pred_len))
    got = tdev.pair_rows(twd, twod, t(gt_fix), t(gt_len), t(pred_fix),
                         t(pred_len)).numpy()
    np.testing.assert_allclose(got, want, **ROW_TOL)

    want_h = jdev.human_rows(jwd, jwod, gt_fix, gt_len)
    got_h = tdev.human_rows(twd, twod, t(gt_fix), t(gt_len))
    assert got_h.shape == (3, 4, 4, 9)
    np.testing.assert_allclose(got_h, want_h, **ROW_TOL)
    assert not np.allclose(got_h[0, 0, 1, 8], got_h[0, 1, 0, 8])  # STDE
    sm_wd, sm_wod = theval.make_scanmatch_pair()
    np.testing.assert_allclose(
        got_h[0, 2, 3], theval.pair_metrics(gts[0][2], gts[0][3], sm_wd,
                                            sm_wod), rtol=2e-4, atol=2e-5)


def test_device_sweep_and_human_baseline_match_jax(rng):
    """DeviceSweep.result(), its overflow count and
    human_evaluation_device against the JAX package's on the same GT
    and predictions, and against the port's host suite."""
    gts, (gt_fix, gt_len, gt_mask) = _padded_gt(rng, 4, 3, 9)
    gt_mask[2, 2] = 0                       # a missing subject
    gts[2] = gts[2][:2]
    preds = [_grid_path(rng, int(rng.integers(3, 9))) for _ in range(4)]
    preds[3]["duration"][:] = 40.0          # overflows the w/-duration table
    pred_fix, pred_len = pad_fix_vectors(preds, 9)
    (jwd, jwod), (twd, twod) = _spec_pair(64, 9)
    t = torch.from_numpy
    jsweep, tsweep = jdev.DeviceSweep(jwd, jwod), tdev.DeviceSweep(twd, twod)
    jsweep.add_batch(gt_fix, gt_len, gt_mask, pred_fix, pred_len)
    tsweep.add_batch(t(gt_fix), t(gt_len), t(gt_mask), t(pred_fix),
                     t(pred_len))
    assert tsweep.overflow == jsweep.overflow == {
        "count": 1, "total": 4, "frac": 0.25}
    for w, g in zip(jsweep.result(), tsweep.result()):
        _assert_tree(w, g)

    batch = {"fix_vectors": gts, "img_names": [f"{i}.jpg" for i in range(4)],
             "gt_fix": gt_fix, "gt_len": gt_len, "gt_mask": gt_mask}
    want_m, want_s, want_img = jdev.human_evaluation_device(
        [batch], jwd, jwod)
    got_m, got_s, got_img = tdev.human_evaluation_device([batch], twd, twod,
                                                         device="cpu")
    _assert_tree(want_m, got_m)
    _assert_tree(want_s, got_s)
    for k in want_img:
        np.testing.assert_allclose(got_img[k], want_img[k], **TREE_TOL)
    host_m, host_s, _ = theval.human_evaluation([batch])
    _assert_tree(host_m, got_m)
    _assert_tree(host_s, got_s)

    # the AiR bucketing of the human baseline (host code over the rows)
    batch.update(performances=[[True, True, False], [False, False, False],
                               [True, False], [True, True, True]],
                 question_ids=[f"q{i}" for i in range(4)])
    want = jdev.human_evaluation_device([batch], jwd, jwod, task="air")
    got = tdev.human_evaluation_device([batch], twd, twod, task="air",
                                       device="cpu")
    for cat in ("all", "right_answer", "wrong_answer"):
        _assert_tree(want[0][cat], got[0][cat], cat)
        _assert_tree(want[1][cat], got[1][cat], cat)
    for q in want[2]:
        for flag in (True, False):
            np.testing.assert_allclose(got[2][q][flag], want[2][q][flag],
                                       **TREE_TOL)


def _write_split(root, rng, n_images=3, n_subjects=4):
    """A synthetic OSIE test split: 800x600 coordinates, 3-9 fixations
    of 100-800 ms per subject."""
    from PIL import Image
    img_dir, fix_dir = root / "stimuli", root / "fixations"
    img_dir.mkdir()
    fix_dir.mkdir()
    recs = []
    for i in range(n_images):
        name = f"{1001 + i}.png"
        Image.fromarray(rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)) \
            .save(img_dir / name)
        for s in range(n_subjects):
            n = int(rng.integers(3, 10))
            recs.append({"name": name, "subject": s,
                         "X": rng.uniform(0, 800, n).tolist(),
                         "Y": rng.uniform(0, 600, n).tolist(),
                         "T": rng.uniform(100, 800, n).tolist(),
                         "length": n})
    with open(fix_dir / "osie_fixations_test.json", "w") as f:
        json.dump(recs, f)
    return str(img_dir), str(fix_dir)


def test_eval_slice_matches_jax(tmp_path, rng):
    """The OSIE eval slice at small geometry on a synthetic split: the
    same batches from both data layers, the eval forward from the same
    weights, the samplers on JAX's noise, then both device sweeps over
    two repeats give the same metric tree."""
    img_dir, fix_dir = _write_split(tmp_path, rng)
    args = jconfig.parse_opt(FLAGS + ["--img_dir", img_dir,
                                      "--fix_dir", fix_dir])
    jds = jdata.EvaluationDataset("osie", jtrainer.data_config(args), "test")
    tds = tdata.EvaluationDataset("osie", ttrainer.data_config(args), "test")
    assert (tds.pad_subjects, tds.pad_gt_len, tds.wd_symbols_needed) == \
        (jds.pad_subjects, jds.pad_gt_len, jds.wd_symbols_needed)
    jb = list(jdata.Loader(jds, batch_size=2))
    tb = list(tdata.Loader(tds, batch_size=2))
    for a, b in zip(jb, tb):
        assert set(a) == set(b)
        for k in ("images", "gt_fix", "gt_len", "gt_mask"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    grid = ttrainer.grid_spec(args)
    jspecs = jtrainer.eval_specs(jds, grid)
    tspecs = ttrainer.eval_specs(tds, grid)
    assert tuple(tuple(s) for s in tspecs) == tuple(tuple(s) for s in jspecs)
    assert tspecs[0].max_symbols == 256

    jmodel = create_model("osie", **GEOM)
    vs = jax.tree.map(np.array, jax.jit(lambda k, x: jmodel.init(
        k, x, train=False))(jax.random.PRNGKey(0), jb[0]["images"]))
    jforward = jax.jit(lambda x: jmodel.apply(vs, x, train=False))
    tmodel = ScanpathModel("osie", **GEOM)
    tmodel.load_state_dict(port.from_jax_params(vs["params"],
                                                vs["batch_stats"], "osie",
                                                10, 12))
    tmodel.eval()

    jsample = jax.jit(lambda k, p, m, s2: js.random_sample(k, p, m, s2,
                                                          grid))
    jsweep, tsweep = jdev.DeviceSweep(*jspecs), tdev.DeviceSweep(*tspecs)
    key = jax.random.PRNGKey(5)
    t = torch.from_numpy
    for batch in jb:
        jout = jforward(batch["images"])
        tout = tmodel(t(batch["images"]))
        for r in range(2):
            key, sub = jax.random.split(key)
            k_act, k_dur = jax.random.split(sub)
            probs = jout["all_actions_prob"]
            jsamp = jsample(sub, probs, jout["log_normal_mu"],
                            jout["log_normal_sigma2"])
            tsamp = ts.random_sample_from_noise(
                tout["all_actions_prob"], tout["log_normal_mu"],
                tout["log_normal_sigma2"], grid,
                t(np.array(jax.random.gumbel(k_act, probs.shape))),
                t(np.array(jax.random.normal(k_dur, probs.shape[:-1]))))
            np.testing.assert_array_equal(tsamp.actions.numpy(),
                                          np.asarray(jsamp.actions))
            gt = [batch[k] for k in ("gt_fix", "gt_len", "gt_mask")]
            jsweep.add_batch(*gt, jsamp.fix, jsamp.fix_len)
            tsweep.add_batch(*map(t, gt), tsamp.fix, tsamp.fix_len)
    for w, g in zip(jsweep.result(), tsweep.result()):
        _assert_tree(w, g)
    # the human baseline against the JAX package's is held in
    # test_device_sweep_and_human_baseline_match_jax; here against the
    # host suite on the split's own batches
    for w, g in zip(theval.human_evaluation(tb)[:2],
                    tdev.human_evaluation_device(tb, *tspecs,
                                                 device="cpu")[:2]):
        _assert_tree(w, g)


def test_human_evaluation_device_defaults_to_the_card():
    """Like the CLIs, the device human baseline runs on the card unless
    the caller asks for the CPU (the tests here pass device="cpu")."""
    import inspect
    sig = inspect.signature(tdev.human_evaluation_device)
    assert sig.parameters["device"].default == "cuda"


def test_cli_test_runs_on_cpu(tmp_path, rng):
    """``cli.test --device cpu`` end to end at small geometry from a
    reference-layout checkpoint: the prediction schema, the log, and the
    device sweep's tree against the host suite's on the same samples."""
    img_dir, fix_dir = _write_split(tmp_path, rng)
    run = tmp_path / "run"
    (run / "checkpoints").mkdir(parents=True)
    model = ScanpathModel("osie", **GEOM)
    from scanpaths_tpu_torch.models.scanpath_model import init_weights
    init_weights(model, 0)
    torch.save(port.to_reference_state_dict(model.state_dict(), "osie", 10,
                                            12),
               run / "checkpoints" / "checkpoint_best.pth")
    argv = FLAGS + ["--img_dir", img_dir, "--fix_dir", fix_dir,
                    "--evaluation_dir", str(run), "--eval_repeat_num", "2",
                    "--device", "cpu"]
    got = tcli.main(argv + ["--device_eval", "true"])
    recs = json.loads((run / "test_predicts.json").read_text())
    log = (run / "log_test.txt").read_text()
    want = tcli.main(argv + ["--device_eval", "false"])
    if "table overflow" in log:
        # seed weights sample huge LogNormal durations: the with-duration
        # column of a truncated rollout differs by design
        for tree in (want, got):
            del tree["ScanMatch"]["with duration"]
    _assert_tree(want, got)
    assert len(recs) == 3 * 2
    for r in recs:
        assert set(r) == {"name", "repeat_id", "X", "Y", "T", "length"}
        assert r["repeat_id"] in (1, 2) and 0 <= r["length"] <= 4
        assert len(r["X"]) == len(r["Y"]) == len(r["T"]) == r["length"]
        assert all(0 <= x <= 96 for x in r["X"])
        assert all(0 <= y <= 80 for y in r["Y"])
    assert "human performance" in log
    with pytest.raises(ValueError, match="joint run one task at a time"):
        tcli.main(["--task", "joint", "--evaluation_dir", str(run),
                   "--device", "cpu"])


def _drop_with_duration(tree):
    """The metric tree without its with-duration ScanMatch entries."""
    return {k: (_drop_with_duration(v) if isinstance(v, dict) else v)
            for k, v in tree.items() if k != "with duration"}


@pytest.mark.parametrize("task", ["air", "coco"])
def test_cli_test_runs_air_and_coco_on_cpu(task, tmp_path, rng):
    """``cli.test --device cpu`` for AiR (test split, both streams, the
    answer-correctness buckets) and COCO (validation split): the output
    file, the records' extra fields, and the device sweep's tree against
    the host suite's on the same samples."""
    from test_torch_tasks import write_task_split
    from scanpaths_tpu_torch.models.scanpath_model import init_weights
    data = write_task_split(task, tmp_path, rng)
    run = tmp_path / "run"
    (run / "checkpoints").mkdir(parents=True)
    model = ScanpathModel(task, **GEOM)
    init_weights(model, 0)
    torch.save(port.to_reference_state_dict(model.state_dict(), task, 10,
                                            12),
               run / "checkpoints" / "checkpoint_best.pth")
    argv = data + FLAGS[2:] + ["--evaluation_dir", str(run),
                               "--eval_repeat_num", "2", "--device", "cpu"]
    got = tcli.main(argv + ["--device_eval", "true"])
    out = "test" if task == "air" else "validation"
    recs = json.loads((run / f"{out}_predicts.json").read_text())
    log = (run / "log_test.txt").read_text()
    want = tcli.main(argv + ["--device_eval", "false"])
    if task == "air":
        assert set(got) == {"all", "right_answer", "wrong_answer"}
    if "table overflow" in log:
        # seed weights sample huge LogNormal durations: the with-duration
        # column of a truncated rollout differs by design
        want, got = _drop_with_duration(want), _drop_with_duration(got)
    _assert_tree(want, got)
    streams = 2 if task == "air" else 1
    assert len(recs) == 3 * 2 * streams
    extra = {"qid", "performance"} if task == "air" else {"task"}
    for r in recs:
        assert set(r) == {"img_names", "repeat_id", "X", "Y", "T",
                          "length"} | extra
        assert r["repeat_id"] in (1, 2) and 0 <= r["length"] <= 4
        assert len(r["X"]) == len(r["Y"]) == len(r["T"]) == r["length"]
    if task == "air":
        # one batch's records: good stream, then poor, repeat-major
        assert [r["performance"] for r in recs[:8]] == [True] * 4 + \
            [False] * 4
        assert recs[0]["qid"] == "q00000"
    else:
        assert recs[0]["task"] == "bottle"


def test_reference_layout_exporter_round_trip():
    """to_reference_state_dict is the inverse of load_reference_state_dict
    and writes the JAX package's reference layout (the same keys and
    values as the port's flax -> reference conversion)."""
    jmodel = create_model("osie", **GEOM)
    shapes = jax.eval_shape(lambda k: jmodel.init(
        k, jnp.zeros((1, 80, 96, 3)), train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(6)
    vs = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32), shapes)
    want = port._flax_to_reference(vs["params"], vs["batch_stats"], "osie",
                                   10, 12)
    sd = port.from_jax_params(vs["params"], vs["batch_stats"], "osie", 10, 12)
    got = port.to_reference_state_dict(sd, "osie", 10, 12)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    back = port.load_reference_state_dict(got)
    assert all(torch.equal(back[k], sd[k]) for k in sd)


def test_copied_modules_match_the_jax_package():
    """The port's copies of the numpy modules read the same flags and
    grid as the JAX package's."""
    ja = vars(jconfig.parse_opt(["--task", "osie"]))
    ta = vars(tconfig.parse_opt(["--task", "osie"]))
    assert ja == ta
    assert tconfig.build_parser().format_help() == \
        jconfig.build_parser().format_help()
    from scanpaths_tpu_torch.core import grid as tgrid
    assert tgrid.GridSpec() == tgrid.GridSpec(**vars(GridSpec()))
    assert tgrid.FIX_DTYPE == jdata.FIX_DTYPE
    # the same data settings, the packed image store among them
    # (test_torch_persistence.py holds its batches to the JAX package's)
    assert [(f.name, f.default) for f in dataclasses.fields(tdata.DataConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(jdata.DataConfig)]
    assert os.path.basename(jheval.__file__) == \
        os.path.basename(theval.__file__)
