"""The port's OSIE serving slice against the JAX package, on the CPU:
the trunk (eval modules and the folded stage path), the decoder
components, the fused conditioner+head, the whole eval forward, both
samplers, plus the port's packaging contracts (no JAX import, the
kernel builder's refusal without nvcc, chip_smoke.py's refusal without
a card).

Inputs come from seeded numpy generators (or from a flax init whose
arrays are then handed to both packages), in float32.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanpaths_tpu.core.grid import GridSpec
from scanpaths_tpu.models import components as jc
from scanpaths_tpu.models.port import export_reference_state_dict
from scanpaths_tpu.models.resnet import DilatedResNet50 as FlaxResNet
from scanpaths_tpu.models.scanpath_model import create_model
from scanpaths_tpu.ops import sampling as js
from scanpaths_tpu_torch.models import components as tc
from scanpaths_tpu_torch.models import port, resnet
from scanpaths_tpu_torch.models.scanpath_model import ScanpathModel
from scanpaths_tpu_torch.ops import _build, block
from scanpaths_tpu_torch.ops import sampling as ts
from test_torch_block import randomize_bn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(tree):
    return jax.tree.map(lambda v: np.array(v), tree)


def _torchvision_names(params, stats):
    """Flax trunk trees -> a torchvision-era resnet50 state dict."""
    sd = {}

    def conv(name, leaf):
        sd[f"{name}.weight"] = np.asarray(leaf["kernel"]).transpose(3, 2, 0, 1)

    def bn(name, p, s):
        sd[f"{name}.weight"] = p["scale"]
        sd[f"{name}.bias"] = p["bias"]
        sd[f"{name}.running_mean"] = s["mean"]
        sd[f"{name}.running_var"] = s["var"]

    conv("conv1", params["conv1"])
    bn("bn1", params["bn1"], stats["bn1"])
    for key, p in params.items():
        if not key.startswith("layer"):
            continue
        si, bi = key[len("layer"):].split("_block")
        pre = f"layer{si}.{bi}"
        for ci in (1, 2, 3):
            conv(f"{pre}.conv{ci}", p[f"conv{ci}"])
            bn(f"{pre}.bn{ci}", p[f"bn{ci}"], stats[key][f"bn{ci}"])
        if "downsample_conv" in p:
            conv(f"{pre}.downsample.0", p["downsample_conv"])
            bn(f"{pre}.downsample.1", p["downsample_bn"],
               stats[key]["downsample_bn"])
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def test_backbone_matches_flax(monkeypatch):
    """Eval modules and the folded forward (uniform blocks of layers 1-3
    through stage_apply) against DilatedResNet50.apply(train=False).
    layers=(2,2,2,1): every stage 1-3 has a uniform block, so the stage
    path runs.  Tolerance 5e-5 (tests/test_pallas_block.py's bound for
    the JAX package's own folded trunk)."""
    layers = (2, 2, 2, 1)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 48, 64, 3)).astype(np.float32)
    mod = FlaxResNet(layers=layers)
    vs = randomize_bn(_np_tree(mod.init(jax.random.PRNGKey(0), x)), rng)
    ref = np.asarray(mod.apply(vs, x, train=False))

    net = resnet.DilatedResNet50(layers)
    net.load_state_dict(resnet.load_torch_state_dict(
        _torchvision_names(vs["params"], vs["batch_stats"]), layers))
    net.eval()
    calls = []
    real = block.stage_apply
    monkeypatch.setattr(block, "stage_apply",
                        lambda *a: calls.append(a[1]) or real(*a))
    with torch.no_grad():
        out_eval = net(torch.from_numpy(x)).numpy()
        out_fused = resnet.fused_forward(net, torch.from_numpy(x)).numpy()
    assert calls == [1, 1, 2]          # layers 1-3, layer3 dilated
    assert out_fused.shape == ref.shape == (2, 6, 8, 2048)
    np.testing.assert_allclose(out_eval, ref, atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(out_fused, ref, atol=5e-5, rtol=5e-5)


def test_verify_torchvision_sha(tmp_path):
    import hashlib
    data = b"weights"
    digest = hashlib.sha256(data).hexdigest()[:8]
    good = tmp_path / f"resnet50-{digest}.pth"
    good.write_bytes(data)
    bad = tmp_path / "resnet50-00000000.pth"
    bad.write_bytes(data)
    assert resnet.verify_torchvision_sha(str(good))
    assert not resnet.verify_torchvision_sha(str(bad))
    assert resnet.verify_torchvision_sha(str(tmp_path / "custom.pth"))


def _init(mod, key, *args, method=None):
    return _np_tree(mod.init(jax.random.PRNGKey(key), *args,
                             method=method)["params"])


def _load(mod, params, rename=None):
    """Flax leaves -> a torch module: conv HWIO -> OIHW, Dense
    [in, out] -> [out, in]."""
    sd = {}
    for name, leaf in params.items():
        ours = (rename or {}).get(name, name)
        k = np.asarray(leaf["kernel"])
        sd[f"{ours}.weight"] = torch.from_numpy(np.ascontiguousarray(
            k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T))
        sd[f"{ours}.bias"] = torch.from_numpy(np.asarray(leaf["bias"]))
    mod.load_state_dict(sd)
    return mod


def test_components_match_flax():
    """XGates, SignalGates.kp, both history attentions and the duration
    tail against their flax modules (atol = rtol = 1e-5)."""
    rng = np.random.default_rng(1)
    f = np.float32
    n, h, w, e, t1 = 2, 5, 10, 16, 5
    tol = dict(atol=1e-5, rtol=1e-5)
    t = torch.from_numpy

    visual = rng.standard_normal((n, h, w, e)).astype(f)
    p = _init(jc.XGates(embed=e), 0, visual)
    ours = _load(tc.XGates(e), p)
    np.testing.assert_allclose(
        ours(t(visual)).detach().numpy(),
        np.asarray(jc.XGates(embed=e).apply({"params": p}, visual)), **tol)

    cv = rng.standard_normal((n, e)).astype(f)
    smap = rng.standard_normal((n, h, w)).astype(f)
    sg = jc.SignalGates(3 * e, e)
    p = _init(sg, 1, smap, cv)
    ours = tc.SignalGates(3 * e, e)
    ours.weight.data = t(p["kernel"].transpose(3, 2, 0, 1).copy())
    np.testing.assert_allclose(
        ours.kp(t(cv)).detach().numpy(),
        np.asarray(sg.apply({"params": p}, cv, method=sg.kp)), **tol)

    valid = np.arange(t1) <= 2
    hist = rng.standard_normal((n, t1, e)).astype(f)
    proj = rng.standard_normal((n, t1, e)).astype(f)
    sa = jc.SemanticAttention(embed=e)
    both = lambda m, hf, hp, cf, v: (m.project(cf), m(hf, hp, cf, v))  # noqa
    p = _init(sa, 2, hist, proj, cv, valid, method=both)
    ours = _load(tc.SemanticAttention(e), p)
    want = sa.apply({"params": p}, hist, proj, cv, valid, method=both)
    got = (ours.project(t(cv)), ours(t(hist), t(proj), t(cv), t(valid)))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(wv), **tol)

    hw = h * w
    hist = rng.standard_normal((n, t1, hw)).astype(f)
    hconv = rng.standard_normal((n, t1, hw)).astype(f)
    cur = rng.standard_normal((n, hw)).astype(f)
    spa = jc.SpatialAttention(map_h=h, map_w=w)
    p = _init(spa, 3, hist, hconv, cur, valid, method=both)
    ours = _load(tc.SpatialAttention(h, w), p)
    want = spa.apply({"params": p}, hist, hconv, cur, valid, method=both)
    got = (ours.project(t(cur)), ours(t(hist), t(hconv), t(cur), t(valid)))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(wv), **tol)

    head = jc.PredictHead(map_h=h, map_w=w, embed=e)
    d = rng.standard_normal((n, h // 5, w // 5)).astype(f)
    p = _init(head, 4, method=lambda m: m.raw())
    p = jax.tree.map(lambda v: (v + rng.standard_normal(v.shape) * 0.1)
                     .astype(f), p)
    ours = _load(tc.PredictHead(h, w, e), p)
    mu, s2 = head.apply({"params": p}, d, method=head.finish_duration)
    omu, os2 = ours.finish_duration(t(d))
    np.testing.assert_allclose(omu.detach().numpy(), np.asarray(mu), **tol)
    np.testing.assert_allclose(os2.detach().numpy(), np.asarray(s2), **tol)


def test_fused_cond_head_matches_jax():
    """fuse_cond_head + apply_fused_cond_head against the JAX functions
    on identical HWIO kernels, border corrections included (map 10x15:
    both sides divisible by 5).  atol = rtol = 1e-5."""
    rng = np.random.default_rng(2)
    f = np.float32
    c, mh, mw, n = 24, 10, 15, 2
    r = lambda *s: (rng.standard_normal(s) * 0.1).astype(f)  # noqa: E731
    k1, b1 = r(5, 5, c, c), r(c)
    raw = {"w2": (r(1, 1, c, 1), r(1)), "w3": (r(1, 1, c, 1), r(1)),
           "kd": (r(7, 7, c, 1), r(1)), "kd2": (r(2, 3, 1, 2), r(2))}
    h = rng.standard_normal((n, mh, mw, c)).astype(f)

    fj = jc.fuse_cond_head(k1, b1, raw, mh, mw)
    want = jc.apply_fused_cond_head(h, fj, jnp.float32)
    t = torch.from_numpy
    ft = tc.fuse_cond_head(t(k1), t(b1),
                           {k: (t(a), t(b)) for k, (a, b) in raw.items()},
                           mh, mw)
    for key, v in ft.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(fj[key]),
                                   atol=1e-5, rtol=1e-5, err_msg=key)
    got = tc.apply_fused_cond_head(t(h), ft, torch.float32)
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=1e-5,
                                   rtol=1e-5)


def test_osie_forward_matches_jax():
    """The whole OSIE eval forward (80x80 images, 10x10 map, T=4, embed
    64, trunk (2,2,2,1) so the stage path runs) from the JAX model's
    weights, every BN statistic and bias randomised.  atol 2e-4 / rtol
    1e-4, the JAX package's own whole-model bound for its fused cell
    (tests/test_pallas_cell.py)."""
    kw = dict(map_h=10, map_w=10, seq_len=4, embed=64,
              backbone_layers=(2, 2, 2, 1))
    rng = np.random.default_rng(3)
    imgs = rng.standard_normal((2, 80, 80, 3)).astype(np.float32)
    jm = create_model("osie", **kw)
    vs = randomize_bn(_np_tree(jm.init(jax.random.PRNGKey(0), imgs,
                                       train=False)), rng)
    ref = jm.apply(vs, imgs, train=False)

    tm = ScanpathModel("osie", **kw)
    tm.load_state_dict(port.from_jax_params(vs["params"], vs["batch_stats"],
                                            "osie", 10, 10))
    out = tm.eval()(torch.from_numpy(imgs))
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=2e-4, rtol=1e-4, err_msg=k)


def test_reference_state_dict_round_trip():
    """At the full 30x40 map (the only geometry the JAX package's
    exporter takes) the port's flax->reference conversion equals
    export_reference_state_dict, and the result loads into the port's
    model.  Shapes come from jax.eval_shape; values from numpy."""
    kw = dict(seq_len=2, embed=16, backbone_layers=(1, 1, 1, 1))
    jm = create_model("osie", **kw)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, jnp.zeros((1, 240, 320, 3)), train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    vs = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32), shapes)
    want = export_reference_state_dict(vs["params"], vs["batch_stats"],
                                       "osie")
    got = port._flax_to_reference(vs["params"], vs["batch_stats"], "osie",
                                  30, 40)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    tm = ScanpathModel("osie", **kw)
    tm.load_state_dict(port.load_reference_state_dict(
        {"model": {f"module.{k}": v for k, v in want.items()}}))
    np.testing.assert_array_equal(
        tm.spatial_att.att.weight.detach().numpy(),
        vs["params"]["spatial_att"]["att"]["kernel"].T)


def _sampler_inputs(seed):
    rng = np.random.default_rng(seed)
    grid = GridSpec(map_width=5, map_height=4, width=80, height=64,
                    max_length=6, min_length=2)
    z = rng.standard_normal((3, 6, grid.num_actions)) * 2
    z[0, 3, 0] = 9.0                    # a STOP mid-path
    z[1, 0, 0] = 9.0                    # a masked index-0 STOP
    probs = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    mu = rng.standard_normal((3, 6)) * 0.3
    s2 = np.exp(rng.standard_normal((3, 6)) * 0.3)
    return (grid, probs.astype(np.float32), mu.astype(np.float32),
            s2.astype(np.float32))


def _assert_same_sample(got, want):
    """Every choice, mask, length and position exactly; the durations
    (and the duration column of ``fix``) to 2 ulp, because XLA's and
    ATen's float32 ``exp`` differ in the last bit."""
    for field in js.SampleOut._fields:
        g = getattr(got, field).numpy()
        w = np.asarray(getattr(want, field))
        assert g.shape == w.shape, field
        if field == "durations":
            np.testing.assert_allclose(g, w, rtol=2.4e-7, atol=0,
                                       err_msg=field)
        elif field == "fix":
            np.testing.assert_array_equal(g[..., :2], w[..., :2])
            np.testing.assert_allclose(g[..., 2], w[..., 2], rtol=2.4e-7,
                                       atol=0, err_msg=field)
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w,
                                          err_msg=field)


def test_greedy_sample_matches_jax_exactly():
    grid, probs, mu, s2 = _sampler_inputs(5)
    want = js.greedy_sample(jnp.asarray(probs), jnp.asarray(mu),
                            jnp.asarray(s2), grid)
    t = torch.from_numpy
    got = ts.greedy_sample(t(probs), t(mu), t(s2), grid)
    _assert_same_sample(got, want)
    assert int(want.actions[1, 0]) != 0   # STOP masked below min_length
    np.testing.assert_allclose(ts.sample_checksum(got).numpy(),
                               np.asarray(js.sample_checksum(want)),
                               rtol=1e-6)
    for a, b in zip(ts.to_fix_vectors(got), js.to_fix_vectors(want)):
        for k in ("start_x", "start_y"):
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_allclose(a["duration"], b["duration"], rtol=2.4e-7)


def test_random_sample_from_noise_matches_jax_exactly():
    """JAX's noise, rebuilt from its key (categorical is argmax of
    logits + Gumbel), fed to the port gives JAX's samples exactly."""
    grid, probs, mu, s2 = _sampler_inputs(6)
    key = jax.random.PRNGKey(7)
    want = js.random_sample(key, jnp.asarray(probs), jnp.asarray(mu),
                            jnp.asarray(s2), grid)
    k_act, k_dur = jax.random.split(key)
    gumbel = np.array(jax.random.gumbel(k_act, probs.shape))
    normal = np.array(jax.random.normal(k_dur, mu.shape))
    t = torch.from_numpy
    got = ts.random_sample_from_noise(t(probs), t(mu), t(s2), grid,
                                      t(gumbel), t(normal))
    _assert_same_sample(got, want)

    # the generator-driven draw: valid samples, reproducible per seed
    draws = [ts.random_sample(t(probs), t(mu), t(s2), grid,
                              torch.Generator().manual_seed(3))
             for _ in range(2)]
    assert torch.equal(draws[0].actions, draws[1].actions)
    assert bool(((draws[0].actions >= 0)
                 & (draws[0].actions < grid.num_actions)).all())
    assert bool((draws[0].actions[:, :grid.min_length] != 0).all())


def test_port_imports_no_jax():
    """No module of the port imports JAX (run in a fresh interpreter)."""
    mods = ["scanpaths_tpu_torch.cli.predict",
            "scanpaths_tpu_torch.serve.predictor",
            "scanpaths_tpu_torch.models.port",
            "scanpaths_tpu_torch.models.scanpath_model",
            "scanpaths_tpu_torch.ops.sampling",
            "scanpaths_tpu_torch.ops.cell", "scanpaths_tpu_torch.ops.block",
            "scanpaths_tpu_torch.ops._build"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith(('jax.', 'flax', 'scanpaths_tpu.models', "
              "'scanpaths_tpu.ops', 'scanpaths_tpu.train')))\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
    for root, _, files in os.walk(os.path.join(REPO, "scanpaths_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as fh:
                    src = fh.read()
                assert "import jax" not in src and "from jax" not in src, \
                    name


def test_builder_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    _build.library.cache_clear()
    _build.kernel.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.library()
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.kernel("sp_cell_step", 7, 6)
    finally:
        _build.library.cache_clear()
        _build.kernel.cache_clear()


def test_chip_smoke_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                          capture_output=True, text=True, cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
