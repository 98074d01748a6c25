"""The port's serving export (scanpaths_tpu_torch/serve/export.py,
cli/export.py, cli/predict.py --bundle) on the CPU, at the JAX export
tests' tiny geometry: the bundle against the port's live serving module
and against the JAX package's bundle on the same weights (converted by
models/port.py), the sampled bundle on JAX's noise, a symbolic batch, a
host that imports only the op registrations, the CLIs, and the cell and
stage kernels as registered ops.  The JAX side runs as
tests/test_export.py runs it.

Tolerance against JAX: fixation positions and lengths exact, durations
and action probabilities rtol 1e-4 (tests/test_torch_serve.py's greedy
one); against the port's own live module: exact."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from scanpaths_tpu.core.config import parse_opt
from scanpaths_tpu.serve import export as jax_export
from scanpaths_tpu.train.trainer import build_model, grid_spec
from scanpaths_tpu.utils.checkpointing import save_pytree
from scanpaths_tpu_torch.cli import export as export_cli
from scanpaths_tpu_torch.cli import predict as predict_cli
from scanpaths_tpu_torch.models import port, prepared
from scanpaths_tpu_torch.models.scanpath_model import ScanpathModel, \
    init_weights
from scanpaths_tpu_torch.ops import block, cell
from scanpaths_tpu_torch.serve import export as serve_export
from scanpaths_tpu_torch.serve.predictor import Predictor
from scanpaths_tpu_torch.utils import tracing

TINY = ["--map_height", "10", "--map_width", "12", "--height", "80",
        "--width", "96", "--max_length", "4", "--backbone_layers",
        "1,1,1,1", "--embed", "16", "--batch", "2"]
KEYS = ("fix", "fix_len", "action_probs")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _feed(args, task, b, seed=None):
    """tests/test_export.py's inputs: [seed,] images[, maps[, ids]]."""
    rng = np.random.default_rng(3)
    feed = [] if seed is None else [seed]
    feed.append(rng.normal(size=(b, args.height, args.width, 3))
                .astype(np.float32))
    if task in ("air", "coco"):
        feed.append(rng.uniform(size=(b, args.map_height, args.map_width,
                                      1)).astype(np.float32))
    if task == "coco":
        # repeated and distinct bank heads in one batch
        feed.append(np.array([5, 2, 5][:b], np.int32))
    return feed


def _assert_exact(got, want):
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k


def _assert_close_to_jax(got, want):
    """Positions and lengths exact, durations and action probabilities
    rtol 1e-4."""
    fix, jfix = got["fix"].numpy(), np.asarray(want["fix"])
    assert fix.shape == jfix.shape
    np.testing.assert_array_equal(got["fix_len"].numpy(),
                                  np.asarray(want["fix_len"]))
    np.testing.assert_array_equal(fix[..., :2], jfix[..., :2])
    np.testing.assert_allclose(fix[..., 2], jfix[..., 2], rtol=1e-4)
    np.testing.assert_allclose(got["action_probs"].numpy(),
                               np.asarray(want["action_probs"]), rtol=1e-4,
                               atol=1e-7)


def _setup(task, tmp):
    """JAX weights (tests/test_export.py's init), the same weights in a
    port run dir (reference-layout checkpoint_best.pth), and the port's
    live model and predictor on the CPU."""
    torch.set_num_threads(1)
    args = parse_opt(["--task", task] + TINY)
    jm = build_model(args)
    kw = {}
    if task in ("air", "coco"):
        kw["attention_maps"] = np.zeros((1, 10, 12, 1), np.float32)
    if task == "coco":
        kw["task_ids"] = np.zeros((1,), np.int32)
    vs = dict(jm.init(jax.random.PRNGKey(0),
                      np.zeros((1, 80, 96, 3), np.float32), train=False,
                      **kw))
    tree = jax.tree.map(np.array, vs)
    if task == "coco":   # distinct bank heads
        rng = np.random.default_rng(1)
        cond = tree["params"]["conditioner"]
        cond["bank_bias"] = (rng.standard_normal(cond["bank_bias"].shape)
                             * 0.3).astype(np.float32)
        vs = tree
    run = tmp / "run"
    (run / "checkpoints").mkdir(parents=True)
    (run / "hparams.json").write_text(json.dumps({"task": task}))
    sd = port._flax_to_reference(tree["params"], tree["batch_stats"], task,
                                 10, 12)
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()}},
               run / "checkpoints" / "checkpoint_best.pth")
    save_pytree(str(run / "checkpoints" / "checkpoint_best.msgpack"),
                {"model": {"params": vs["params"],
                           "batch_stats": vs["batch_stats"]}})
    pred = Predictor(parse_opt(["--task", task, "--evaluation_dir",
                                str(run)] + TINY), "cpu")
    return dict(args=args, jm=jm, vs=vs, run=run, pred=pred, tmp=tmp)


def _export(s, name, **kw):
    out = s["tmp"] / name
    manifest = serve_export.export_bundle(
        str(out), s["pred"].model, s["pred"].grid, map_h=10, map_w=12, **kw)
    return out, manifest


def _jax_bundle(s, name, **kw):
    out = s["tmp"] / name
    jax_export.export_bundle(str(out), s["jm"], s["vs"],
                             grid_spec(s["args"]), platforms=["cpu"],
                             map_h=10, map_w=12, **kw)
    return jax_export.load_bundle(str(out))[0]


@pytest.fixture(scope="module")
def osie(tmp_path_factory):
    """The OSIE run, its bundles written by cli/export.py: greedy at batch
    2 (checked by --export_check) and symbolic."""
    s = _setup("osie", tmp_path_factory.mktemp("osie"))
    base = ["--task", "osie", "--device", "cpu", "--evaluation_dir",
            str(s["run"])] + TINY
    s["greedy"] = s["tmp"] / "greedy"
    s["manifest"] = export_cli.main(base + ["--export_dir",
                                            str(s["greedy"]),
                                            "--export_batch", "2"])
    s["sym"] = s["tmp"] / "sym"
    export_cli.main(base + ["--export_dir", str(s["sym"]),
                            "--export_batch", "sym", "--export_check",
                            "false"])
    return s


@pytest.fixture(scope="module")
def air(tmp_path_factory):
    s = _setup("air", tmp_path_factory.mktemp("air"))
    s["greedy"], _ = _export(s, "greedy", batch=2)
    return s


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    s = _setup("coco", tmp_path_factory.mktemp("coco"))
    s["greedy"], _ = _export(s, "greedy", batch=3)
    # symbolic: COCO's per-sample head convs group by the batch
    s["sample"], _ = _export(s, "sample", batch="sym", decode="sample",
                             num_samples=3)
    return s


def _live(s, decode="greedy", manifest=None, name="greedy"):
    if manifest is None:
        with open(s[name] / "manifest.json") as f:
            manifest = json.load(f)
    module = serve_export.ServeModule(s["pred"].model, s["pred"].grid,
                                      decode).eval()
    return serve_export.serving_fn(module, manifest, "cpu")


def test_greedy_round_trip_osie(osie):
    m = osie["manifest"]
    assert m["bytes"] > 0 and m["platforms"] == ["cpu", "cuda"]
    assert [i["name"] for i in m["inputs"]] == ["images"]
    assert m["torch_version"] == torch.__version__
    assert m["model_dtype"] == "float32" and m["batch"] == 2
    assert sorted(os.listdir(osie["greedy"])) == ["manifest.json",
                                                  "serve.pt2"]
    fn, mf = serve_export.load_bundle(str(osie["greedy"]))
    feed = _feed(osie["args"], "osie", 2)
    got = fn(*feed)
    _assert_exact(got, _live(osie)(*feed))
    lens = got["fix_len"].numpy()
    assert lens.min() >= 1 and lens.max() <= 4


@pytest.mark.parametrize("task", ["osie", "air", "coco"])
def test_greedy_bundle_matches_the_jax_bundle(task, request):
    s = request.getfixturevalue(task)
    b = 3 if task == "coco" else 2
    fn, mf = serve_export.load_bundle(str(s["greedy"]))
    assert mf["stream"] == ("good" if task == "air" else None)
    feed = _feed(s["args"], task, b)
    _assert_close_to_jax(fn(*feed), _jax_bundle(s, "jax_greedy",
                                                batch=b)(*feed))
    # COCO's bank is composed once, outside the program: its weights are
    # not in the bundle; the other tasks compose in the program
    keys = torch.export.load(str(s["greedy"] / "serve.pt2")).state_dict
    assert any("conditioner" in k for k in keys) == (task != "coco")
    assert any(k.startswith("bank_") for k in keys) == (task == "coco")


def test_sampled_coco_bundle_on_the_jax_noise(coco):
    """The program fed the noise the JAX bundle draws from its seed
    (keys split from PRNGKey(seed), each split into the categorical's
    Gumbel draw and the durations' normal draw) gives the JAX bundle's
    samples; the callable's own draw is seed-deterministic; the
    symbolic batch also serves one image (the grouped head convs are
    not specialised to the traced batch)."""
    feed = _feed(coco["args"], "coco", 3, seed=7)
    want = _jax_bundle(coco, "jax_sample", batch=3, decode="sample",
                       num_samples=3)(np.uint32(7), *feed[1:])
    with open(coco["sample"] / "manifest.json") as f:
        mf = json.load(f)
    assert [i["name"] for i in mf["inputs"]] == \
        ["seed", "images", "attention_maps", "tasks"]
    r, sym, t, a = mf["noise"][0]["shape"]
    assert sym == "b"
    b = 3
    gumbel, normal = [], []
    for k in jax.random.split(jax.random.PRNGKey(7), r):
        k_act, k_dur = jax.random.split(k)
        gumbel.append(np.asarray(jax.random.gumbel(k_act, (b, t, a))))
        normal.append(np.asarray(jax.random.normal(k_dur, (b, t))))
    program = torch.export.load(str(coco["sample"] / "serve.pt2")).module()
    with torch.no_grad():
        got = program(torch.from_numpy(np.stack(gumbel)),
                      torch.from_numpy(np.stack(normal)),
                      *(torch.from_numpy(v) for v in feed[1:]))
    _assert_close_to_jax(got, want)

    fn, _ = serve_export.load_bundle(str(coco["sample"]))
    first = fn(*feed)
    assert tuple(first["fix"].shape[:2]) == (3, 3)
    _assert_exact(fn(*feed), first)
    _assert_exact(first, _live(coco, "sample", name="sample")(*feed))
    assert not torch.equal(fn(8, *feed[1:])["fix"], first["fix"])
    assert tuple(fn(7, *(v[:1] for v in feed[1:]))["fix"].shape[:2]) == \
        (3, 1)


def test_symbolic_batch_serves_1_and_3(osie):
    fn, mf = serve_export.load_bundle(str(osie["sym"]))
    assert mf["batch"] == "sym" and mf["inputs"][0]["shape"][0] == "b"
    live = _live(osie, name="sym")
    for b in (1, 3):
        feed = _feed(osie["args"], "osie", b)
        got = fn(*feed)
        assert got["fix"].shape[0] == b
        _assert_exact(got, live(*feed))


def test_bundle_runs_without_model_code(osie):
    """A fresh interpreter that imports torch and the port's op
    registrations, and nothing else of either package, loads the bundle
    and reproduces the live output; so does serve.load_bundle, which
    imports none of the port's models or CLIs either."""
    feed = _feed(osie["args"], "osie", 2)
    want = _live(osie)(*feed)
    np.save(osie["tmp"] / "images.npy", feed[0])
    script = (
        "import sys, json, numpy as np, torch\n"
        "import scanpaths_tpu_torch.ops\n"
        # as in this process: the CPU kernels split their sums by thread
        "torch.set_num_threads(1)\n"
        "d = sys.argv[1]\n"
        "absent = ('jax', 'scanpaths_tpu', 'scanpaths_tpu_torch.models',"
        " 'scanpaths_tpu_torch.cli')\n"
        "def check():\n"
        "    bad = [m for m in absent if m in sys.modules]\n"
        "    assert not bad, bad\n"
        "program = torch.export.load(d + '/greedy/serve.pt2').module()\n"
        "images = torch.from_numpy(np.load(d + '/images.npy'))\n"
        "with torch.no_grad():\n"
        "    out = program(images)\n"
        "check()\n"
        "from scanpaths_tpu_torch.serve import load_bundle\n"
        "fn, _ = load_bundle(d + '/greedy')\n"
        "again = fn(images.numpy())\n"
        "check()\n"
        "assert all(torch.equal(out[k], again[k]) for k in out)\n"
        "print(json.dumps({k: v.tolist() for k, v in out.items()}))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", script, str(osie["tmp"])],
                       capture_output=True, text=True, env=env, cwd="/")
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k].numpy())


def test_export_cli_refuses_joint_and_checks(osie, monkeypatch):
    """cli/export.py: --task joint and a missing card raise; a bundle
    that disagrees with the live model fails --export_check."""
    base = ["--device", "cpu", "--evaluation_dir", str(osie["run"]),
            "--export_dir", str(osie["tmp"] / "x"), "--export_batch",
            "2"] + TINY
    with pytest.raises(ValueError, match="one task head at a time"):
        export_cli.main(["--task", "joint"] + base)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export_cli.main(["--task", "osie", "--device", "cuda"]
                            + base[2:])
    # the greedy bundle stands for a new export; the reloaded bundle is
    # made to disagree with the live module
    def reuse(out_dir, *args, **kw):
        shutil.copytree(osie["greedy"], out_dir)
        return dict(osie["manifest"])
    monkeypatch.setattr(export_cli, "export_bundle", reuse)
    real = serve_export.serving_fn

    def off_by_one(module, manifest, device):
        fn = real(module, manifest, device)
        if isinstance(module, serve_export.ServeModule):
            return fn
        return lambda *a: dict(fn(*a), fix_len=fn(*a)["fix_len"] + 1)
    monkeypatch.setattr(export_cli, "serving_fn", off_by_one)
    monkeypatch.setattr(serve_export, "serving_fn", off_by_one)
    with pytest.raises(RuntimeError, match="disagrees with the live"):
        export_cli.main(["--task", "osie"] + base)


def _images(tmp, n=3):
    from PIL import Image
    rng = np.random.default_rng(0)
    d = tmp / "images"
    d.mkdir(exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, (60, 90, 3), dtype=np.uint8)) \
            .save(d / f"img_{i}.png")
    return str(d)


@pytest.mark.parametrize("bundle", ["greedy", "sym"])
def test_predict_from_bundle_matches_live_predict(osie, bundle, capsys):
    """cli/predict.py --bundle gives the live CLI's records exactly: the
    batch-2 bundle with a padded tail chunk, the symbolic one chunked by
    --batch; a bundle of another task is refused."""
    imgs = _images(osie["tmp"])
    base = ["--task", "osie", "--device", "cpu", "--predict_images",
            imgs] + TINY
    live = predict_cli.main(base + ["--evaluation_dir", str(osie["run"])])
    served = predict_cli.main(base + ["--bundle", str(osie[bundle]),
                                      "--decode", "sample"])
    assert "--decode sample is ignored" in capsys.readouterr().err
    assert len(served) == 3 and served == live
    with pytest.raises(ValueError, match="task"):
        predict_cli.main(["--task", "air", "--device", "cpu",
                          "--predict_images", imgs, "--bundle",
                          str(osie[bundle])] + TINY)


def test_bank_heads_composed_once_and_gathered_equal_fuse_bank_heads():
    """compose_bank_heads gathered by task id is fuse_bank_heads exactly,
    on ids with repeats and distinct entries; the model's forward with
    the composed heads is its forward."""
    m = ScanpathModel("coco", embed=16, seq_len=3, map_h=10, map_w=10,
                      backbone_layers=(1, 1, 1, 1)).eval()
    init_weights(m, 0)
    torch.manual_seed(0)
    with torch.no_grad():
        m.conditioner.bank_bias.normal_(0, 0.3)
        ids = torch.tensor([4, 0, 4, 17, 0], dtype=torch.int32)
        (bank_k, bank_b), = m.conditioner.kernels()
        raw = m.head.raw()
        want = prepared.fuse_bank_heads(bank_k, bank_b, ids, raw, 10, 10)
        heads = prepared.heads(m)
        got = {k: v[ids] for k, v in heads[0].items()}
        assert heads[0]["k_sa"].shape[0] == 18
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        images = torch.randn(2, 80, 80, 3)
        maps = torch.rand(2, 10, 10, 1)
        out = m(images, maps, ids[:2])
        again = m(images, maps, ids[:2], heads=heads)
    for k in out:
        assert torch.equal(out[k], again[k]), k


def _cell_args(seed=0, n=2, h=4, w=5, c=32, s=2):
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g)  # noqa: E731
    return (r(n, h, w, c), r(n, h, w, c), r(n, h, w, 4 * c) * 0.1,
            r(n, h, w, s), r(n, s, 9, 3 * c) * 0.1, r(3, 3, c, 4 * c) * 0.05)


def _stage_args(seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g)  # noqa: E731
    return (r(1, 3, 4, 64), 2, r(2, 64, 32) * 0.1, r(2, 32),
            r(2, 288, 32) * 0.1, r(2, 32), r(2, 32, 64) * 0.1, r(2, 64))


def test_kernels_are_registered_ops():
    """opcheck (schema with c declared mutated, fake kernel, dispatch
    under tracing) passes for both ops on CPU tensors; the wrappers give
    the plain versions' outputs bit for bit and update c in place."""
    assert torch.ops.scanpaths_tpu_torch.cell_step.default is not None
    assert torch.ops.scanpaths_tpu_torch.stage_apply.default is not None
    torch.library.opcheck(cell.cell_step_op, _cell_args())
    torch.library.opcheck(block.stage_apply_op, _stage_args())

    h, c, *rest = _cell_args(1)
    c_plain = c.clone()
    hp, cp = cell.cell_step_plain(h, c_plain, *rest)
    hw, cw = cell.cell_step(h, c, *rest)
    assert cw is c and torch.equal(hw, hp) and torch.equal(cw, cp)
    assert torch.equal(block.stage_apply(*_stage_args(1)),
                       block.stage_apply_plain(*_stage_args(1)))


@pytest.mark.gpu
def test_bundle_on_the_card_launches_the_kernels(tmp_path):
    """On the card: a bundle exported there launches the cell kernel once
    a step and the stage kernel once a stage inside the program, and
    equals the live serving module."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    args = parse_opt(["--task", "osie", "--seed", "3"] + TINY[:-6]
                     + ["--backbone_layers", "2,2,2,1", "--embed", "32",
                        "--batch", "2"])
    pred = Predictor(args, "cuda")
    serve_export.export_bundle(str(tmp_path), pred.model, pred.grid,
                               batch=2, map_h=10, map_w=12)
    fn, mf = serve_export.load_bundle(str(tmp_path))
    feed = _feed(args, "osie", 2)
    before = tracing.launches()
    got = fn(*feed)
    torch.cuda.synchronize()
    after = tracing.launches()
    assert after["cell_step"] - before["cell_step"] == 4
    assert after["stage_apply"] - before["stage_apply"] == 3
    live = serve_export.serving_fn(
        serve_export.ServeModule(pred.model, pred.grid).eval(), mf, "cuda")
    _assert_exact(got, live(*feed))
