"""The port's entry points (``scanpaths_tpu_torch/entry.py``)
against ``__graft_entry__.py``'s on the CPU, at a tiny geometry:

* ``entry()``'s ``fn(state, images)`` on the JAX model's weights
  (``models/port.py::from_jax_params``) against the JAX model's eval
  ``apply`` (atol = rtol = 5e-5, ``tests/test_torch_slice.py``'s bound
  for the trunk; the eval forward draws no noise); ``state`` is the
  forward's only source of weights;
* ``dryrun_multichip(4, device="cpu")``: four gloo ranks under torchrun
  take the data-parallel supervised and SCST steps, then the 2 x 2
  row-parallel ones, whose supervised loss must equal the replicated
  step's within 1e-4 relative (``__graft_entry__.py``'s bound).
"""

import re
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from scanpaths_tpu.models.scanpath_model import create_model
from scanpaths_tpu_torch import entry
from scanpaths_tpu_torch.models import port

GEO = dict(batch=2, height=80, width=96, map_h=10, map_w=12, seq_len=4,
           embed=64, backbone_layers=(1, 1, 1, 1))
TOL = dict(atol=5e-5, rtol=5e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_forward_matches_jax():
    fn, (state, images) = entry.entry(device="cpu", **GEO)
    assert images.shape == (2, 80, 96, 3) and images.dtype == torch.float32
    assert not images.any()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 80, 96, 3)).astype(np.float32)
    jm = create_model("osie", seq_len=4, map_h=10, map_w=12, embed=64,
                      backbone_layers=(1, 1, 1, 1))
    vs = jax.tree.map(np.asarray, jax.jit(lambda k: jm.init(
        k, x, train=False))(jax.random.PRNGKey(0)))
    ref = jax.jit(lambda v, x: jm.apply(v, x, train=False))(vs, x)
    jstate = port.from_jax_params(vs["params"], vs["batch_stats"], "osie",
                                  10, 12)
    assert set(jstate) == set(state)
    out = fn(jstate, torch.from_numpy(x))
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   err_msg=k, **TOL)
    # the weights come from the state alone
    moved = dict(jstate, **{"sal_conv.bias": jstate["sal_conv.bias"] + 0.5})
    assert not torch.equal(fn(moved, torch.from_numpy(x))["log_normal_mu"],
                           out["log_normal_mu"])
    own = fn(state, images)
    assert own["all_actions_prob"].shape == (2, 4, 1 + 10 * 12)
    assert all(bool(torch.isfinite(v).all()) for v in own.values())


def test_entry_defaults_to_the_card_at_full_geometry():
    import inspect
    sig = inspect.signature(entry.entry)
    assert sig.parameters["device"].default == "cuda"
    assert {k: sig.parameters[k].default for k in entry.FULL} == entry.FULL
    assert entry.FULL == dict(batch=8, height=240, width=320, map_h=30,
                              map_w=40, seq_len=16, embed=512,
                              backbone_layers=(3, 4, 6, 3))
    with mock.patch.object(torch.cuda, "is_available", return_value=False), \
            pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)


def test_dryrun_multichip_four_ranks():
    out = entry.dryrun_multichip(4, device="cpu", timeout=600)
    lines = [l for l in out.splitlines() if l.startswith("dryrun")]
    assert len(lines) == 6, out
    sup, rl, tp_sup, tp_rl, launches, scaling = lines
    assert sup.startswith("dryrun supervised step ok on 4 ranks")
    assert "backend gloo" in sup
    assert rl.startswith("dryrun rl step ok on 4 ranks: reward=")
    assert tp_sup.startswith("dryrun row-parallel supervised step ok on 2x2")
    assert "sliced 128->64" in tp_sup
    assert tp_rl.startswith("dryrun row-parallel rl step ok: reward=")
    # world 1 runs on rank 0 once the process group is closed
    assert scaling.startswith("dryrun scaling: supervised step 4 ranks")
    # the plain versions run on the CPU: no kernel launches
    assert launches.endswith('{"cell_step": 0, "stage_apply": 0, '
                             '"nw_scores_bins": 0, "cond_head": 0, '
                             '"cond_compose": 0}')
    loss = float(re.search(r"loss=([-\d.]+)", sup).group(1))
    loss_tp = float(re.search(r"loss=([-\d.]+)", tp_sup).group(1))
    gap = float(re.search(r"to ([-\d.e+]+) \(bound", tp_sup).group(1))
    assert np.isfinite(loss) and gap <= 1e-4 * max(abs(loss), 1.0)
    assert abs(loss_tp - loss) <= 1e-4 * max(abs(loss), 1.0) + 1e-4
    for line in (rl, tp_rl):
        assert np.isfinite(float(re.search(r"reward=([-\d.]+)",
                                           line).group(1)))
