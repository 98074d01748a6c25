"""The port's NW ScanMatch kernel module (scanpaths_tpu_torch/ops/nw.py)
against the JAX package's Pallas kernel and its XLA scan.

Inputs come from a seeded numpy generator, are quantized by the JAX
package's ``quantize`` for both specs of the framework, and go through
``pallas_nw.nw_scores_bins(..., interpret=True)``, ``jax_metrics.
nw_scores`` and the port's ``nw_scores_bins`` (its plain version, since
the tensors lie on the CPU).  Tolerance rtol 1e-6 / atol 1e-7 (the JAX
package's own bound between its two formulations); NaN in the same
places.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanpaths_tpu.metrics import jax_metrics as jm
from scanpaths_tpu.ops.pallas_nw import nw_scores_bins as pallas_nw
from scanpaths_tpu_torch.ops import nw

L = 18
TOL = dict(rtol=1e-6, atol=1e-7, equal_nan=True)


def _batch(rng, b, min_len=1):
    lens = rng.integers(min_len, L + 1, size=b).astype(np.int32)
    fix = np.zeros((b, L, 3), np.float32)
    for i, n in enumerate(lens):
        fix[i, :n, 0] = rng.uniform(0, 320, n)
        fix[i, :n, 1] = rng.uniform(0, 240, n)
        fix[i, :n, 2] = rng.uniform(0.03, 0.9, n)
    return fix, lens


def _symbols(rng, spec, b):
    fa, la = _batch(rng, b)
    fb, lb = _batch(rng, b)
    la[0] = 0                        # empty A
    lb[1] = 0                        # empty B
    la[2] = lb[2] = 0                # both empty -> nan
    sa, na = jm.quantize(spec, jnp.asarray(fa), jnp.asarray(la))
    sb, nb = jm.quantize(spec, jnp.asarray(fb), jnp.asarray(lb))
    return [np.array(v, np.int32) for v in (sa, na, sb, nb)]


@pytest.mark.parametrize("spec", [
    jm.ScanMatchSpec(temp_bin=0.0, max_symbols=L),
    jm.ScanMatchSpec(temp_bin=50.0, max_symbols=160)],
    ids=["wod", "wd"])
def test_nw_plain_matches_pallas_and_xla(rng, spec):
    sa, na, sb, nb = _symbols(rng, spec, 12)
    want_pallas = np.asarray(pallas_nw(spec.threshold, spec.xbin, spec.ybin,
                                       sa, na, sb, nb, interpret=True))
    want_xla = np.asarray(jm.nw_scores(jm.sub_matrix(spec), sa, na, sb, nb))
    t = torch.from_numpy
    got = nw.nw_scores_bins(spec.threshold, spec.xbin, spec.ybin,
                            t(sa), t(na), t(sb), t(nb)).numpy()
    np.testing.assert_allclose(got, want_pallas, **TOL)
    np.testing.assert_allclose(got, want_xla, **TOL)
    assert np.isnan(got[2]) and not np.isnan(got[[0, 1]]).any()
    assert got[0] == 0 and got[1] == 0


def test_nw_plain_ragged_widths_and_self_match(rng):
    """Ta != Tb, lengths at the bound, a perfect self-match scores 1."""
    spec = jm.ScanMatchSpec(temp_bin=0.0, max_symbols=L)
    ta, tb, b = 7, 11, 6
    sa = rng.integers(0, spec.num_bins, (b, ta)).astype(np.int32)
    sb = rng.integers(0, spec.num_bins, (b, tb)).astype(np.int32)
    na = np.array([7, 0, 3, 7, 5, 0], np.int32)
    nb = np.array([11, 4, 0, 11, 2, 0], np.int32)
    sb[3, :7] = sa[3]
    nb[3] = 7
    want = np.asarray(pallas_nw(spec.threshold, spec.xbin, spec.ybin,
                                sa, na, sb, nb, interpret=True))
    t = torch.from_numpy
    got = nw.nw_scores_bins_plain(spec.threshold, spec.xbin, spec.ybin,
                                  t(sa), t(na), t(sb), t(nb)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert got[3] == pytest.approx(1.0, abs=1e-7)
    assert np.isnan(got[5])


def test_nw_wrapper_checks_inputs():
    a = torch.zeros(2, 3, dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        nw.nw_scores_bins(3.5, 16, 12, a.long(), n, a, n)
    with pytest.raises(ValueError, match="must be"):
        nw.nw_scores_bins(3.5, 16, 12, a, n[:1], a, n)
    before = nw.nw_launches
    nw.nw_scores_bins(3.5, 16, 12, a, n, a, n)     # CPU: plain, no launch
    assert nw.nw_launches == before


@pytest.mark.gpu
def test_nw_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card: exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    for ta, tb in ((256, 256), (20, 20), (33, 70), (5, 1024)):
        b = 300
        sa = torch.from_numpy(rng.integers(0, 192, (b, ta)).astype(np.int32))
        sb = torch.from_numpy(rng.integers(0, 192, (b, tb)).astype(np.int32))
        na = torch.from_numpy(rng.integers(0, ta + 1, b).astype(np.int32))
        nb = torch.from_numpy(rng.integers(0, tb + 1, b).astype(np.int32))
        na[:3], nb[1:4] = 0, 0
        args = [x.cuda() for x in (sa, na, sb, nb)]
        got = nw.nw_scores_bins(3.5, 16, 12, *args)
        want = nw.nw_scores_bins_plain(3.5, 16, 12, *args)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        assert torch.equal(got[ok], want[ok])
