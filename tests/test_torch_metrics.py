"""The port's device metrics (scanpaths_tpu_torch/metrics/torch_metrics.py)
against the JAX package's (scanpaths_tpu/metrics/jax_metrics.py), on
the CPU.

Random padded scanpath batches come from a seeded numpy generator and
go through both packages in float32.  Tolerances: the integer outputs
(``quantize``, ``expansion_overflow``, ``levenshtein``/SED) exactly;
ScanMatch at rtol 1e-6 / atol 1e-7 (the same adds and maxes, in another
order only inside ``max``); STDE and MultiMatch at rtol 1e-5 / atol
1e-6, because float ``exp``, ``atan2`` and cumulative sums differ in the
last bit between ATen and XLA.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanpaths_tpu.metrics import jax_metrics as jm
from scanpaths_tpu_torch.metrics import torch_metrics as tm

L = 18
SM_TOL = dict(rtol=1e-6, atol=1e-7, equal_nan=True)
FLOAT_TOL = dict(rtol=1e-5, atol=1e-6, equal_nan=True)
SPECS = [(0.0, L), (50.0, 352), (50.0, 64)]


def random_batch(rng, b, min_len=1, max_len=L):
    lens = rng.integers(min_len, max_len + 1, size=b).astype(np.int32)
    fix = np.zeros((b, L, 3), np.float32)
    for i, n in enumerate(lens):
        fix[i, :n, 0] = rng.uniform(0, 320, n)
        fix[i, :n, 1] = rng.uniform(0, 240, n)
        fix[i, :n, 2] = rng.uniform(0.03, 0.9, n)
    return fix, lens


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])


def _specs(temp_bin, max_symbols):
    return (jm.ScanMatchSpec(temp_bin=temp_bin, max_symbols=max_symbols),
            tm.ScanMatchSpec(temp_bin=temp_bin, max_symbols=max_symbols))


@pytest.mark.parametrize("temp_bin,max_symbols", SPECS)
def test_quantize_and_overflow_exact(rng, temp_bin, max_symbols):
    """Symbols, counts and overflow flags are equal, including values on
    the clip edges, negative and past-the-screen coordinates, and
    durations on a .5 rounding boundary (round half to even)."""
    fix, lens = random_batch(rng, 20)
    fix[0, :3, :2] = [[-5.0, -1.0], [320.0, 240.0], [400.7, 239.99]]
    fix[1, :4, 2] = [0.025, 0.075, 0.125, 40.0]
    lens[1] = 4
    js, ts = _specs(temp_bin, max_symbols)
    (jf, jl), (tf, tl) = _both(fix, lens)
    want_s, want_n = jm.quantize(js, jf, jl)
    got_s, got_n = tm.quantize(ts, tf, tl)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert got_s.dtype == torch.int32
    np.testing.assert_array_equal(
        tm.expansion_overflow(ts, tf, tl).numpy(),
        np.asarray(jm.expansion_overflow(js, jf, jl)))


@pytest.mark.parametrize("temp_bin,max_symbols", SPECS)
def test_scanmatch_matches_jax(rng, temp_bin, max_symbols):
    """scanmatch_scores (through ops/nw.py) against the JAX XLA scan,
    and the generic table-driven nw_scores against jax_metrics'."""
    fa, la = random_batch(rng, 16)
    fb, lb = random_batch(rng, 16)
    la[0] = 0
    la[1] = lb[1] = 0
    js, ts = _specs(temp_bin, max_symbols)
    (jfa, jla, jfb, jlb), (tfa, tla, tfb, tlb) = _both(fa, la, fb, lb)
    want = np.asarray(jm.scanmatch_scores(js, jfa, jla, jfb, jlb,
                                          use_pallas=False))
    got = tm.scanmatch_scores(ts, tfa, tla, tfb, tlb).numpy()
    np.testing.assert_allclose(got, want, **SM_TOL)
    assert np.isnan(got[1])

    np.testing.assert_allclose(tm.sub_matrix(ts).numpy(),
                               np.asarray(jm.sub_matrix(js)), rtol=1e-6)
    sa, na = tm.quantize(ts, tfa, tla)
    sb, nb = tm.quantize(ts, tfb, tlb)
    got_generic = tm.nw_scores(tm.sub_matrix(ts), sa, na, sb, nb).numpy()
    np.testing.assert_allclose(got_generic, want, **SM_TOL)


def test_sed_and_levenshtein_exact(rng):
    fa, la = random_batch(rng, 24)
    fb, lb = random_batch(rng, 24)
    la[0] = 0
    lb[1] = 0
    (jfa, jla, jfb, jlb), (tfa, tla, tfb, tlb) = _both(fa, la, fb, lb)
    np.testing.assert_array_equal(
        tm.sed_scores(tfa, tla, tfb, tlb).numpy(),
        np.asarray(jm.sed_scores(jfa, jla, jfb, jlb)))
    sym_a = rng.integers(0, 25, (8, 5)).astype(np.int32)
    sym_b = rng.integers(0, 25, (8, 9)).astype(np.int32)
    n_a = rng.integers(0, 6, 8).astype(np.int32)
    n_b = rng.integers(0, 10, 8).astype(np.int32)
    (ja, jna, jb, jnb), (ta, tna, tb, tnb) = _both(sym_a, n_a, sym_b, n_b)
    np.testing.assert_array_equal(
        tm.levenshtein(ta, tna, tb, tnb).numpy(),
        np.asarray(jm.levenshtein(ja, jna, jb, jnb)))


def test_stde_matches_jax(rng):
    fa, la = random_batch(rng, 24)
    fb, lb = random_batch(rng, 24)
    lb[2] = 0                                        # nan row
    (jfa, jla, jfb, jlb), (tfa, tla, tfb, tlb) = _both(fa, la, fb, lb)
    got = tm.stde_scores(tfa, tla, tfb, tlb).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jm.stde_scores(jfa, jla, jfb, jlb)), **FLOAT_TOL)
    assert np.isnan(got[2])


def test_multimatch_matches_jax(rng):
    """MultiMatch rows, including <3-fixation NaN rows, grid-centred
    paths (exact ties) and the DP table itself."""
    fa, la = random_batch(rng, 16, min_len=2)
    fb, lb = random_batch(rng, 16, min_len=2)
    fa[4:8, :, :2] = np.floor(fa[4:8, :, :2] / 8) * 8 + 4    # grid centres
    fb[4:8, :, :2] = np.floor(fb[4:8, :, :2] / 8) * 8 + 4
    (jfa, jla, jfb, jlb), (tfa, tla, tfb, tlb) = _both(fa, la, fb, lb)
    got = tm.multimatch_scores(tfa, tla, tfb, tlb).numpy()
    want = np.asarray(jax.jit(jm.multimatch_scores)(jfa, jla, jfb, jlb))
    np.testing.assert_allclose(got, want, **FLOAT_TOL)
    assert np.isnan(got[(la < 3) | (lb < 3)]).all()

    m = np.abs(rng.standard_normal((L - 1, L - 1))).astype(np.float32)
    np.testing.assert_allclose(
        tm._mm_align_table(torch.from_numpy(m)[None])[0].numpy(),
        np.asarray(jm._mm_align_table(jnp.asarray(m))), rtol=1e-5, atol=1e-6)


def test_multimatch_exact_alignment_tie():
    """The JAX package's tie regression pair (tests/test_metrics_jax.py::
    test_multimatch_jax_exact_alignment_tie): saccade 0 == saccade 1 of
    the prediction, so whole DP columns tie exactly; the traceback's
    tolerance keeps the host's diag > up > left order."""
    gt = np.array([
        [28.637657, 17.975346, 0.571892], [5.826118, 8.386845, 0.132733],
        [17.664713, 12.10556, 0.604229], [30.110462, 24.06101, 0.219451],
        [36.353935, 17.330498, 0.320491], [30.968199, 19.8957, 0.128302],
        [45.647884, 27.97657, 0.226726], [16.720411, 10.860298, 0.368716],
        [37.81781, 26.949255, 0.410576], [4.596786, 10.206927, 0.597115],
        [9.773601, 6.566147, 0.521667], [21.472595, 35.86916, 0.222975],
        [31.736494, 36.20962, 0.442775]], np.float32)
    pred = np.array([[44.0, 28.0, 0.166949], [28.0, 20.0, 4.857131],
                     [12.0, 12.0, 0.789355], [20.0, 36.0, 0.55234]],
                    np.float32)
    gt_pad = np.zeros((1, 20, 3), np.float32)
    gt_pad[0, :13] = gt
    pr_pad = np.zeros((1, 20, 3), np.float32)
    pr_pad[0, :4] = pred
    la, lb = np.array([13], np.int32), np.array([4], np.int32)
    (jg, jla, jp, jlb), (tg, tla, tp, tlb) = _both(gt_pad, la, pr_pad, lb)
    got = tm.multimatch_scores(tg, tla, tp, tlb).numpy()
    want = np.asarray(jax.jit(jm.multimatch_scores)(jg, jla, jp, jlb))
    np.testing.assert_allclose(got, want, **FLOAT_TOL)
    # and the host suite's alignment (the JAX test's bound)
    from scanpaths_tpu_torch.metrics.multimatch import docomparison
    np.testing.assert_allclose(got[0], docomparison(gt, pred,
                                                    screensize=(320, 240)),
                               rtol=2e-5, atol=2e-5)


def test_masked_median_matches_jax(rng):
    vals = rng.standard_normal((6, 9)).astype(np.float32)
    valid = rng.integers(0, 2, (6, 9)).astype(bool)
    valid[0] = False                                 # empty -> nan
    vals[1, 2], valid[1, 2] = np.nan, True           # nan propagates
    got = tm._masked_median(torch.from_numpy(vals), torch.from_numpy(valid))
    want = [np.asarray(jm._masked_median(jnp.asarray(v), jnp.asarray(m)))
            for v, m in zip(vals, valid)]
    np.testing.assert_array_equal(got.numpy(), np.array(want))


def test_pair_grid_matches_jax(rng):
    n, s = 3, 5
    gt = np.zeros((n, s, L, 3), np.float32)
    gl = np.zeros((n, s), np.int32)
    gm = np.zeros((n, s), np.float32)
    for i in range(n):
        gt[i], gl[i] = random_batch(rng, s)
        gm[i, :rng.integers(1, s + 1)] = 1
    pf, pl = random_batch(rng, n)
    jwd, twd = _specs(50.0, 128)
    jwod, twod = _specs(0.0, L)
    jargs, targs = _both(gt, gl, gm, pf, pl)
    want = jm.scanmatch_pair_grid(jwd, jwod, *jargs)
    got = tm.scanmatch_pair_grid(twd, twod, *targs)
    for g, w in zip(got, want):
        assert g.shape == (n, s)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SM_TOL)
