"""The port's AiR and COCO-Search18 task plugins against the JAX package,
on the CPU: the dual and bank conditioner+head compositions, the whole
eval forward of each task, the weight layouts, the data layers and the
device sweeps.

Geometry: 80x96 images, a 10x12 map, T = 4, embed 64; trunk (2,2,2,1)
for the forward (every stage 1-3 has a uniform block, so the stage path
runs) and (1,1,1,1) where only the decode matters.  Weights come from a
flax init with every BN statistic and bias randomised
(``test_torch_block.randomize_bn``, plus the COCO bank's biases), inputs
from seeded numpy generators.  Tolerances: the whole forward at atol
2e-4 / rtol 1e-4, the JAX package's own whole-model bound for its fused
cell (tests/test_pallas_cell.py); the compositions at 1e-5; the metric
trees at the host suite's bound, rtol 2e-4 / atol 2e-5.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanpaths_tpu.core import config as jconfig
from scanpaths_tpu.data import datasets as jdata
from scanpaths_tpu.metrics import device_eval as jdev
from scanpaths_tpu.models import components as jc
from scanpaths_tpu.models.port import export_reference_state_dict
from scanpaths_tpu.models.scanpath_model import create_model
from scanpaths_tpu.ops import sampling as js
from scanpaths_tpu.train import trainer as jtrainer
from scanpaths_tpu_torch.data import datasets as tdata
from scanpaths_tpu_torch.metrics import device_eval as tdev
from scanpaths_tpu_torch.models import components as tc
from scanpaths_tpu_torch.models import port
from scanpaths_tpu_torch.models.scanpath_model import ScanpathModel
from scanpaths_tpu_torch.ops import sampling as ts
from scanpaths_tpu_torch.train import trainer as ttrainer
from test_torch_block import randomize_bn

TASKS = ("air", "coco")
GEOM = dict(map_h=10, map_w=12, seq_len=4, embed=64)
FWD_TOL = dict(atol=2e-4, rtol=1e-4)
TREE_TOL = dict(rtol=2e-4, atol=2e-5)
t = torch.from_numpy


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


def _inputs(task, rng, n=3):
    """Images, attention maps and (COCO) task ids: samples 0 and 1 share
    an image and map, so the two AiR streams and two COCO heads can be
    told apart on one input; sample 2 repeats sample 0's task id."""
    imgs = rng.standard_normal((n, 80, 96, 3)).astype(np.float32)
    imgs[1] = imgs[0]
    att = rng.uniform(0, 1, (n, 10, 12, 1)).astype(np.float32)
    att[1] = att[0]
    kw = {"attention_maps": att}
    if task == "coco":
        kw["task_ids"] = np.array([5, 2, 5][:n], np.int32)
    return imgs, kw


def _jax_variables(task, rng, imgs, kw, layers):
    jm = create_model(task, backbone_layers=layers, **GEOM)
    vs = randomize_bn(_np_tree(jax.jit(lambda k: jm.init(
        k, imgs, train=False, **kw))(jax.random.PRNGKey(0))), rng)
    cond = vs["params"]["conditioner"]
    if "bank_bias" in cond:
        cond["bank_bias"] = (rng.standard_normal(cond["bank_bias"].shape)
                             * 0.3).astype(np.float32)
    return jm, vs


def _port_model(task, vs, layers):
    tm = ScanpathModel(task, backbone_layers=layers, **GEOM)
    tm.load_state_dict(port.from_jax_params(vs["params"], vs["batch_stats"],
                                            task, 10, 12))
    return tm.eval()


def _port_call(tm, imgs, kw):
    return tm(t(imgs), t(kw["attention_maps"]),
              t(kw["task_ids"]) if "task_ids" in kw else None)


@pytest.mark.parametrize("mode", ["dual", "bank"])
def test_conditioner_heads_match_jax(mode):
    """The port's Conditioner holds the flax Conditioner's parameters in
    the same stream / head order, and its composition with the head, per
    stream (dual) or per sample from the bank (bank: a batch with
    repeated and distinct task ids, one grouped conv for all samples),
    equals jc.fuse_cond_head + apply_fused_cond_head applied stream by
    stream or sample by sample.  atol = rtol = 1e-5."""
    rng = np.random.default_rng(11)
    c, mh, mw, heads = 16, 10, 15, 5
    r = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)  # noqa
    h = rng.standard_normal((4, mh, mw, c)).astype(np.float32)
    cond = jc.Conditioner(mode=mode, embed=c, num_heads=heads)
    p = _np_tree(cond.init(jax.random.PRNGKey(1), method=cond.kernels))
    p = jax.tree.map(lambda v: v + r(*v.shape), p)   # nonzero biases
    ours = tc.Conditioner(mode, c, heads)
    if mode == "dual":
        ours.load_state_dict({
            f"sal_layer_{s}.{w}": t(np.ascontiguousarray(
                p["params"][f"sal_layer_{s}"][k].transpose(3, 2, 0, 1)
                if k == "kernel" else p["params"][f"sal_layer_{s}"][k]))
            for s in ("true", "false")
            for w, k in (("weight", "kernel"), ("bias", "bias"))})
    else:
        ours.load_state_dict({"bank_kernel": t(p["params"]["bank_kernel"]),
                              "bank_bias": t(p["params"]["bank_bias"])})
    want_k = cond.apply(p, method=cond.kernels)
    got_k = ours.kernels()
    assert len(got_k) == len(want_k) == (2 if mode == "dual" else 1)
    for (gk, gb), (wk, wb) in zip(got_k, want_k):
        np.testing.assert_array_equal(gk.detach().numpy(), np.asarray(wk))
        np.testing.assert_array_equal(gb.detach().numpy(), np.asarray(wb))

    raw = {"w2": (r(1, 1, c, 1), r(1)), "w3": (r(1, 1, c, 1), r(1)),
           "kd": (r(7, 7, c, 1), r(1)), "kd2": (r(2, 3, 1, 2), r(2))}
    raw_t = {k: (t(a), t(b)) for k, (a, b) in raw.items()}
    tol = dict(atol=1e-5, rtol=1e-5)
    if mode == "dual":
        outs = []
        for (gk, gb), (wk, wb) in zip(got_k, want_k):
            fj = jc.fuse_cond_head(np.asarray(wk), np.asarray(wb), raw, mh,
                                   mw)
            want = jc.apply_fused_cond_head(h, fj, jnp.float32)
            got = tc.apply_fused_cond_head(
                t(h), tc.fuse_cond_head(gk.detach(), gb.detach(), raw_t, mh,
                                        mw), torch.float32)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
            outs.append(got[1].numpy())
        assert not np.allclose(outs[0], outs[1])     # the streams differ
        return

    ids = np.array([3, 1, 3, 0], np.int32)           # repeated and distinct
    (bk, bb), = got_k
    fused = tc.fuse_bank_heads(bk.detach(), bb.detach(), t(ids), raw_t, mh,
                               mw)
    assert all(v.shape[0] == len(ids) for v in fused.values())
    got = tc.apply_fused_cond_head(t(h), fused, torch.float32)
    bank_k, bank_b = (np.asarray(v) for v in want_k[0])
    for i, k in enumerate(ids):
        fj = jc.fuse_cond_head(bank_k[k], bank_b[k], raw, mh, mw)
        for key in fj:
            if key in fused:
                np.testing.assert_allclose(fused[key][i].numpy(),
                                           np.asarray(fj[key]), **tol,
                                           err_msg=key)
        want = jc.apply_fused_cond_head(h[i:i + 1], fj, jnp.float32)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i:i + 1].numpy(), np.asarray(w),
                                       **tol)
    with pytest.raises(ValueError, match="outside the bank"):
        tc.fuse_bank_heads(bk, bb, t(np.array([0, heads], np.int32)), raw_t,
                           mh, mw)


@pytest.mark.parametrize("task", TASKS)
def test_task_forward_matches_jax(task):
    """The whole eval forward of each task from the JAX model's weights:
    every output key at atol 2e-4 / rtol 1e-4.  The AiR streams differ
    from each other, and the COCO heads differ by task id on one input
    while a repeated id gives the same output."""
    layers = (2, 2, 2, 1)
    rng = np.random.default_rng(3)
    imgs, kw = _inputs(task, rng)
    jm, vs = _jax_variables(task, rng, imgs, kw, layers)
    ref = jax.jit(lambda v, x, a: jm.apply(v, x, train=False, **a))(
        vs, imgs, kw)
    out = _port_call(_port_model(task, vs, layers), imgs, kw)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **FWD_TOL)
    if task == "air":
        assert len(out) == 8
        assert not np.allclose(out["good_all_actions_prob"].numpy(),
                               out["poor_all_actions_prob"].numpy(),
                               atol=1e-4)
    else:
        probs = out["all_actions_prob"].numpy()
        assert not np.allclose(probs[0], probs[1], atol=1e-4)
        imgs2 = imgs.copy()
        imgs2[2] = imgs[0]
        kw2 = dict(kw, attention_maps=kw["attention_maps"].copy())
        kw2["attention_maps"][2] = kw["attention_maps"][0]
        again = _port_call(_port_model(task, vs, layers), imgs2, kw2)
        np.testing.assert_allclose(again["all_actions_prob"][2].numpy(),
                                   again["all_actions_prob"][0].numpy(),
                                   atol=1e-6, rtol=1e-5)


def test_air_forward_matches_the_interpreted_pallas_cell():
    """The port's AiR forward against the JAX model running its Pallas
    decode cell in interpret mode (two signal streams in one call), on
    the same weights; trunk (1,1,1,1).  atol 2e-4 / rtol 1e-4."""
    layers = (1, 1, 1, 1)
    rng = np.random.default_rng(4)
    imgs, kw = _inputs("air", rng, n=2)
    _, vs = _jax_variables("air", rng, imgs, kw, layers)
    jm = create_model("air", backbone_layers=layers, cell_impl="interpret",
                      **GEOM)
    ref = jm.apply(vs, imgs, train=False, **kw)
    out = _port_call(_port_model("air", vs, layers), imgs, kw)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **FWD_TOL)


@pytest.mark.parametrize("task", TASKS)
def test_task_weights_match_the_reference_exporter(task):
    """At the full 30x40 map (the only geometry the JAX exporter takes)
    the port's flax -> reference conversion equals
    export_reference_state_dict for the task's names (AiR's _pos/_neg
    gates and True/False conditioners, COCO's per-category bank), and
    reference -> port -> reference is the identity."""
    kw = dict(seq_len=2, embed=16, backbone_layers=(1, 1, 1, 1))
    jm = create_model(task, **kw)
    extra = {"attention_maps": jnp.zeros((1, 30, 40, 1))}
    if task == "coco":
        extra["task_ids"] = jnp.zeros((1,), jnp.int32)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 240, 320, 3)), train=False, **extra),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    vs = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32), shapes)
    want = export_reference_state_dict(vs["params"], vs["batch_stats"], task)
    got = port._flax_to_reference(vs["params"], vs["batch_stats"], task, 30,
                                  40)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    sd = port.from_jax_params(vs["params"], vs["batch_stats"], task, 30, 40)
    tm = ScanpathModel(task, **kw)
    tm.load_state_dict(sd)
    back = port.to_reference_state_dict(sd, task, 30, 40)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k].numpy(), want[k], err_msg=k)
    again = port.load_reference_state_dict({"model": back}, task)
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    if task == "air":
        np.testing.assert_array_equal(
            tm.lstm.gates_s1.bias.detach().numpy(),
            np.asarray(vs["params"]["lstm"]["gates_s1"]["bias"]))


def write_task_split(task, root, rng, n_groups=3, n_subjects=4):
    """A synthetic AiR test split (per-question frames, an attention .npy
    per question, right and wrong answers) or COCO validation split (the
    320x512 frame, several categories, detector boxes above and below
    the 0.8 threshold).  Returns the CLI flags that read it."""
    from PIL import Image
    from scanpaths_tpu_torch.data.datasets import COCO_OBJECT_NAMES
    img_dir, fix_dir, att_dir = root / "images", root / "fix", root / "att"
    for d in (img_dir, fix_dir, att_dir):
        d.mkdir()
    recs, dets = [], []
    for g in range(n_groups):
        if task == "air":
            h, w = int(rng.integers(300, 700)), int(rng.integers(400, 900))
            name, qid = f"img_{g}.png", f"q{g:05d}"
            np.save(att_dir / f"{qid}.npy",
                    rng.uniform(0.05, 1.0, (15, 20)).astype(np.float32))
        else:
            h, w = 320, 512
            cat = COCO_OBJECT_NAMES[(3 * g) % 18]
            name = f"coco_{g:04d}.png"
            (img_dir / cat).mkdir(exist_ok=True)
            for score in (0.9, 0.5):               # kept, then dropped
                x0, y0 = rng.uniform(0, 400), rng.uniform(0, 240)
                dets.append({"image_id": name.split(".")[0],
                             "category": cat, "score": score,
                             "bbox": [x0, y0, x0 + 100, y0 + 80]})
        path = img_dir / (cat if task == "coco" else "") / name
        Image.fromarray(rng.integers(0, 256, (h // 8, w // 8, 3),
                                     dtype=np.uint8)).save(path)
        for s in range(n_subjects):
            n = int(rng.integers(3, 10))
            x, y = rng.uniform(0, w, n).tolist(), rng.uniform(0, h, n)
            dur = rng.uniform(100, 800, n)
            if task == "air":
                start = np.concatenate([[0.0], np.cumsum(dur)[:-1]])
                recs.append({"image_id": name, "question_id": qid,
                             "height": h, "width": w, "X": x,
                             "Y": y.tolist(), "T_start": start.tolist(),
                             "T_end": (start + dur).tolist(), "length": n,
                             "answer": "yes",
                             "subject_answer": "yes" if s % 2 else "no"})
            else:
                recs.append({"name": name, "task": cat, "X": x,
                             "Y": y.tolist(), "T": dur.tolist(),
                             "length": n})
    if task == "air":
        fn = "AiR_fixations_test.json"
    else:
        fn = "coco_search18_fixations_TP_validation_split1.json"
        with open(att_dir / "coco_search18_detector.json", "w") as f:
            json.dump(dets, f)
    with open(fix_dir / fn, "w") as f:
        json.dump(recs, f)
    return ["--task", task, "--img_dir", str(img_dir), "--fix_dir",
            str(fix_dir), "--att_dir" if task == "air" else "--detector_dir",
            str(att_dir)]


FLAGS = ["--map_height", "10", "--map_width", "12", "--height", "80",
         "--width", "96", "--max_length", "4", "--backbone_layers",
         "1,1,1,1", "--embed", "64", "--batch", "2", "--seed", "3"]


def _datasets(task, tmp_path, rng):
    args = jconfig.parse_opt(write_task_split(task, tmp_path, rng) + FLAGS)
    split = "validation" if task == "coco" else "test"
    return (args, jdata.EvaluationDataset(task, jtrainer.data_config(args),
                                          split),
            tdata.EvaluationDataset(task, ttrainer.data_config(args), split))


@pytest.mark.parametrize("task", TASKS)
def test_task_data_matches_jax(task, tmp_path, rng):
    """The AiR and COCO eval batches of both data layers, key by key:
    images, GT, attention maps, task ids, answer flags, names."""
    _, jds, tds = _datasets(task, tmp_path, rng)
    assert (tds.pad_subjects, tds.pad_gt_len, tds.wd_symbols_needed) == \
        (jds.pad_subjects, jds.pad_gt_len, jds.wd_symbols_needed)
    jb = list(jdata.Loader(jds, batch_size=2))
    tb = list(tdata.Loader(tds, batch_size=2))
    assert len(jb) == len(tb) == 2
    for a, b in zip(jb, tb):
        assert set(a) == set(b)
        for k in a:
            if k == "fix_vectors":
                for ga, gb in zip(a[k], b[k]):
                    for va, vb in zip(ga, gb):
                        np.testing.assert_array_equal(va, vb)
            elif isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
    maps = np.concatenate([b["attention_maps"] for b in tb])
    assert maps.shape == (3, 10, 12, 1) and maps.max() <= 1.0
    if task == "air":
        assert all(any(p) and not all(p) for p in tb[0]["performances"])
        assert tb[0]["gt_performance"].shape == (2, 4)
    else:
        assert [int(v) for b in tb for v in b["tasks"]] == [0, 3, 6]
        assert all(m.max() > 0.99 for m in maps)    # the kept boxes


@pytest.mark.parametrize("task", TASKS)
def test_task_sweep_matches_jax(task, tmp_path, rng):
    """The device sweep of each task against the JAX package's on JAX's
    noise: the same eval forward from the same weights, the samplers fed
    the same Gumbel and normal draws, then DeviceSweep.add_batch_air
    (AiR, both streams, bucketed by answer correctness) or add_batch
    (COCO) over two repeats gives the same metric tree."""
    args, jds, tds = _datasets(task, tmp_path, rng)
    layers = (1, 1, 1, 1)
    grid = ttrainer.grid_spec(args)
    jspecs = jtrainer.eval_specs(jds, grid)
    tspecs = ttrainer.eval_specs(tds, grid)
    jb = list(jdata.Loader(jds, batch_size=2))
    kw0 = {"attention_maps": jb[0]["attention_maps"]}
    if task == "coco":
        kw0["task_ids"] = jb[0]["tasks"]
    jm, vs = _jax_variables(task, rng, jb[0]["images"], kw0, layers)
    jforward = jax.jit(lambda x, a, v=vs: jm.apply(v, x, train=False, **a))
    tm = _port_model(task, vs, layers)
    jsample = jax.jit(lambda k, p, m, s2: js.random_sample(k, p, m, s2,
                                                          grid))
    jsweep, tsweep = jdev.DeviceSweep(*jspecs), tdev.DeviceSweep(*tspecs)
    streams = (("good", True), ("poor", False)) if task == "air" else \
        ((None, None),)
    key = jax.random.PRNGKey(5)
    for batch in jb:
        kw = {"attention_maps": batch["attention_maps"]}
        if task == "coco":
            kw["task_ids"] = batch["tasks"]
        jout, tout = jforward(batch["images"], kw), _port_call(
            tm, batch["images"], kw)
        gt = [batch[k] for k in ("gt_fix", "gt_len", "gt_mask")]
        for stream, flag in streams:
            pre = f"{stream}_" if stream else ""
            probs = jout[pre + "all_actions_prob"]
            for _ in range(2):
                key, sub = jax.random.split(key)
                k_act, k_dur = jax.random.split(sub)
                jsamp = jsample(sub, probs, jout[pre + "log_normal_mu"],
                                jout[pre + "log_normal_sigma2"])
                tsamp = ts.random_sample_from_noise(
                    tout[pre + "all_actions_prob"],
                    tout[pre + "log_normal_mu"],
                    tout[pre + "log_normal_sigma2"], grid,
                    t(np.array(jax.random.gumbel(k_act, probs.shape))),
                    t(np.array(jax.random.normal(k_dur, probs.shape[:-1]))))
                np.testing.assert_array_equal(tsamp.actions.numpy(),
                                              np.asarray(jsamp.actions))
                if task == "air":
                    jsweep.add_batch_air(*gt, jsamp.fix, jsamp.fix_len,
                                         batch["performances"], flag)
                    tsweep.add_batch_air(*map(t, gt), tsamp.fix,
                                         tsamp.fix_len,
                                         batch["performances"], flag)
                else:
                    jsweep.add_batch(*gt, jsamp.fix, jsamp.fix_len)
                    tsweep.add_batch(*map(t, gt), tsamp.fix, tsamp.fix_len)
    want, got = jsweep.result(), tsweep.result()
    if task == "air":
        assert set(got[0]) == {"all", "right_answer", "wrong_answer"}
    _assert_tree(want[0], got[0])
    _assert_tree(want[1], got[1])


def _assert_tree(want, got, path=""):
    assert set(want) == set(got), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree(want[k], got[k], f"{path}/{k}")
        else:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       err_msg=f"{path}/{k}", **TREE_TOL)
