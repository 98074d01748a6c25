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
from scanpaths_tpu_torch.utils import tracing

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
    before = tracing.counter("nw_scores_bins.launches")
    nw.nw_scores_bins(3.5, 16, 12, a, n, a, n)     # CPU: plain, no launch
    assert tracing.counter("nw_scores_bins.launches") == before


def test_nw_plain_out_of_table_symbols(rng):
    """Symbols at and beyond xbin * ybin, and negative ones (the kernel
    scores them without its table): the plain version against the
    Pallas kernel."""
    spec = jm.ScanMatchSpec(temp_bin=0.0, max_symbols=L)
    b = 8
    sa = rng.integers(-400, 600, (b, L)).astype(np.int32)
    sb = rng.integers(150, 260, (b, L)).astype(np.int32)
    sa[0, :4] = spec.num_bins                       # the first beyond
    na = rng.integers(1, L + 1, b).astype(np.int32)
    nb = rng.integers(1, L + 1, b).astype(np.int32)
    want = np.asarray(pallas_nw(spec.threshold, spec.xbin, spec.ybin,
                                sa, na, sb, nb, interpret=True))
    t = torch.from_numpy
    got = nw.nw_scores_bins_plain(spec.threshold, spec.xbin, spec.ybin,
                                  t(sa), t(na), t(sb), t(nb)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("threshold,xbin,ybin", [(3.5, 16, 12), (2.0, 5, 3)])
def test_kernel_table_is_the_plain_score(threshold, xbin, ybin):
    """The kernel's table gives, bit for bit, the plain version's s for
    every pair of in-range bins, at index [ya - yb + ybin - 1, xa - xb +
    xbin - 1]; and the JAX package's sub_matrix within TOL (its hypot is
    not the correctly rounded sqrt, 1 ulp apart in some entries)."""
    n = (2 * ybin - 1) * (2 * xbin - 1)
    table = nw.kernel_table(threshold, xbin, ybin)[:n].view(2 * ybin - 1,
                                                            2 * xbin - 1)
    assert table.dtype == torch.float32
    sym = torch.arange(xbin * ybin, dtype=torch.int32)
    x, y = sym % xbin, sym // xbin
    xa, ya = x[:, None].float(), y[:, None].float()
    xb, yb = x[None, :].float(), y[None, :].float()
    plain = threshold - torch.sqrt((xa - xb) ** 2 + (ya - yb) ** 2)
    got = table[(y[:, None] - y[None, :]) + ybin - 1,
                (x[:, None] - x[None, :]) + xbin - 1]
    assert torch.equal(got, plain)
    spec = jm.ScanMatchSpec(xbin=xbin, ybin=ybin, threshold=threshold)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.sub_matrix(spec)),
                               **TOL)


def test_kernel_table_layout():
    """The scores by offset, then the masked rows' -3.4e38 entries (as
    many as a masked row's code reaches, (n + 1) / 2), padded to a
    multiple of 4 floats; the kernel's shared table holds 1536."""
    cpu = torch.device("cpu")
    table = nw._device_table(3.5, 16, 12, cpu)
    n = 23 * 31
    assert table.shape == (1072,) and table.numel() % 4 == 0
    assert torch.equal(table, nw.kernel_table(3.5, 16, 12))
    assert torch.all(table[n:] == np.float32(nw.NEG))
    assert torch.all(table[:n] > np.float32(nw.NEG))
    assert table.numel() - n >= (n + 1) // 2
    widest = nw._device_table(3.5, 16, 16, cpu)         # 31 x 31 scores
    assert widest.numel() <= 1536
    assert nw._device_table(3.5, 17, 17, cpu) is None   # 33 x 33 > 1024
    assert nw._device_table(3.5, 16, 0, cpu) is None


@pytest.mark.parametrize("b,tb,want", [
    (3600, 256, (8, 4)),      # the human baseline, w/ duration
    (3600, 20, (1, 4)),       # the human baseline, w/o duration
    (240, 256, (8, 1)),       # pair_rows: one pair a block over 132 SMs
    (240, 20, (1, 1)),
    (1000, 256, (8, 2)),
    (32, 33, (8, 1)),
    (300, 1024, (32, 1)),     # the widest table the kernel takes
    (0, 0, (1, 1))])
def test_launch_geometry(b, tb, want):
    assert nw.launch_geometry(b, tb, 132) == want


def test_launch_geometry_refuses_wide_tables():
    with pytest.raises(ValueError, match="at most 1024"):
        nw.launch_geometry(4, 1025, 132)


@pytest.mark.gpu
def test_nw_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card: exact, at
    the test driver's shapes (3600 and 240 pairs, tables of 256 and 20
    symbols), ragged ones, and symbols outside the table."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    for bins, b, ta, tb, lo, hi in (
            ((16, 12), 300, 256, 256, 0, 192), ((16, 12), 300, 20, 20, 0, 192),
            ((16, 12), 3600, 256, 256, 0, 192),
            ((16, 12), 240, 256, 256, 0, 192),
            ((16, 12), 240, 20, 20, 0, 192), ((16, 12), 300, 33, 70, 0, 192),
            ((16, 12), 300, 5, 1024, 0, 192), ((16, 12), 300, 40, 33, 150, 260),
            ((16, 12), 300, 20, 20, -2 ** 31, 2 ** 31 - 1),
            ((16, 12), 32, 10, 700, -5, 400), ((40, 30), 64, 50, 90, 0, 1200)):
        sa = torch.from_numpy(rng.integers(lo, hi, (b, ta)).astype(np.int32))
        sb = torch.from_numpy(rng.integers(lo, hi, (b, tb)).astype(np.int32))
        na = torch.from_numpy(rng.integers(0, ta + 1, b).astype(np.int32))
        nb = torch.from_numpy(rng.integers(0, tb + 1, b).astype(np.int32))
        na[:3], nb[1:4] = 0, 0
        args = [x.cuda() for x in (sa, na, sb, nb)]
        got = nw.nw_scores_bins(3.5, *bins, *args)
        want = nw.nw_scores_bins_plain(3.5, *bins, *args)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        ok = ~torch.isnan(want)
        assert torch.equal(got[ok], want[ok])
