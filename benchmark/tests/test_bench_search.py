"""The visual-search cell (``coco.generate``) on the CPU at a tiny
geometry: the per-sample reference's weight layout is the program's
reference layout for ``coco``; the program's eval forward (its plain head
on the CPU) matches the reference for target ids all equal, all distinct
and repeated; a run is correct, and neither the reference in bfloat16
nor a program that gathers each sample's neighbouring bank entry is.  On
a card (marked ``gpu``), at the cell's own size: the TF32 control fails
the cell's limits and a short window of the program passes them."""

import time

import pytest
import torch
from conftest import TINY, run_tiny, tiny_context

from benchmark import harness
from benchmark.reference import compare, search

CELL = "coco.generate"
IDS = {"all equal": [5, 5, 5, 5], "all distinct": [0, 6, 13, 17],
       "repeated": [2, 9, 2, 16]}


def _driver():
    return harness.load_module(harness.HERE / "drivers" / "search.py",
                               "driver_search")


def _net(cfg):
    from scanpaths_tpu_torch.models.scanpath_model import ScanpathModel
    return ScanpathModel("coco", embed=cfg["embed"],
                         seq_len=cfg["max_length"],
                         map_h=cfg["map_height"], map_w=cfg["map_width"],
                         backbone_layers=tuple(cfg["backbone_layers"]))


def test_the_layout_is_the_programs_reference_layout():
    from scanpaths_tpu_torch.models.port import to_reference_state_dict
    cfg = {**harness.Cell.find(CELL).cfg, **TINY}
    ref = to_reference_state_dict(_net(cfg).state_dict(), "coco",
                                  cfg["map_height"], cfg["map_width"])
    ours = {k: shape for k, shape, _, _ in search.layout(cfg)}
    assert ours == {k: tuple(v.shape) for k, v in ref.items()}


def test_detector_maps_and_targets_follow_the_mix():
    ctx = tiny_context(CELL)
    cfg = {**ctx.cfg, "map_height": 30, "map_width": 40}
    mix = ctx.mix
    gen = torch.Generator().manual_seed(3)
    maps, ids = search.boxes(gen, 512, cfg, mix, "cpu")
    again, _ = search.boxes(torch.Generator().manual_seed(3), 512, cfg, mix,
                            "cpu")
    assert torch.equal(maps, again) and maps.shape == (512, 30, 40, 1)
    assert set(maps.unique().tolist()) == {0.0, 1.0}
    assert ids.min() >= 0 and ids.max() < 18 and len(ids.unique()) == 18
    cells = maps.flatten(1).sum(1)
    empty = (cells == 0).float().mean()
    assert 0.07 < empty < 0.19          # 1 in 8, over 512 draws
    lo, hi = mix["box_cells"]
    full = cells[cells > 0]
    assert full.min() >= lo * lo and full.max() <= 3 * hi * hi


@pytest.fixture(scope="module")
def forward_pair():
    """The program (f32, the eval forward) and the seed's weights."""
    from scanpaths_tpu_torch.models.port import load_reference_state_dict
    ctx = tiny_context(CELL)
    sd, _ = search.make_state_dict(ctx.cfg, 21, "cpu")
    net = _net(ctx.cfg)
    net.load_state_dict(load_reference_state_dict(sd, "coco"))
    images, maps, _ = _driver().inputs(ctx.cfg, ctx.mix, 4, 21, 0, "cpu")
    return ctx.cfg, sd, net.eval(), images, maps


# The program computes in float32 in another order than the reference
# (the conditioner composed with the head, the gates fused, the batch's
# bank entries gathered).  Over three seeds at this geometry its log
# probabilities spread by at most 3.3e-5 a step about the reference's
# and its mu and log(sigma2) differ by at most 1.3e-6, against the
# float32 reference and the float64 one alike: its own float32 rounding
# through 4 recurrent steps, which the float64 reference isolates.  Each
# tolerance is about ten times that; a neighbour's bank entry (the
# planted fault below) moves the three by 5 and more, 0.06 and more.
LOGP_TOL, DURATION_TOL = 3e-4, 2e-5


@pytest.mark.parametrize("precision", [torch.float32, torch.float64])
@pytest.mark.parametrize("pattern", list(IDS))
def test_the_eval_forward_matches_the_per_sample_reference(
        forward_pair, pattern, precision):
    cfg, sd, net, images, maps = forward_pair
    ids = torch.tensor(IDS[pattern])
    with torch.no_grad():
        got = net(images, attention_maps=maps, task_ids=ids)
    want = search.forward({k: v.to(precision) for k, v in sd.items()}, cfg,
                          images.to(precision), maps, ids)
    logp = torch.log_softmax(want["logits"].double(), dim=-1)
    err = torch.log(got["all_actions_prob"].double()) - logp
    # a shift common to a step's actions cancels in the softmax
    assert (err.amax(-1) - err.amin(-1)).max() < LOGP_TOL
    assert torch.allclose(got["log_normal_mu"].double(),
                          want["mu"].double(), atol=DURATION_TOL, rtol=0)
    assert torch.allclose(torch.log(got["log_normal_sigma2"].double()),
                          torch.log(want["sigma2"].double()),
                          atol=DURATION_TOL, rtol=0)


def test_a_run_is_correct_and_the_control_is_not():
    """A tiny run reads inside a tenth of every limit; the reference in
    bfloat16 in the program's place (the CPU has no TF32) fails at least
    one."""
    out = run_tiny(CELL)
    assert out.correct, out.numbers
    assert all(v <= 0.1 * out.limits[k] for k, v in out.numbers.items()
               if v is not None), out.numbers
    ctx = tiny_context(CELL)
    got = _driver().check(ctx, [(0, None), (1, None)], ctx.mix["batch"],
                          ctx.mix["rollouts"], control_precision="bfloat16")
    assert not compare.verdict(got, ctx.spec["limits"]), got


def test_a_neighbours_bank_entry_fails(monkeypatch):
    """Each sample is served with the next category's composed head."""
    from scanpaths_tpu_torch.models import scanpath_model
    real = scanpath_model.fuse_bank_heads

    def neighbour(bank_k, bank_b, task_ids, *rest):
        return real(bank_k, bank_b, (task_ids + 1) % bank_k.shape[0], *rest)
    monkeypatch.setattr(scanpath_model, "fuse_bank_heads", neighbour)
    out = run_tiny(CELL)
    assert not out.correct, out.numbers


@pytest.mark.gpu
def test_on_the_card_the_control_fails_and_the_program_passes(card):
    """``test_bench_chip.py``'s check of a cell, through the driver's own
    output check (``harness.check`` computes the free-viewing and VQA
    references only)."""
    harness.no_tf32()
    cell = harness.Cell.find(CELL)
    driver = _driver()

    def context(seed, seconds):
        return harness.Context(cfg=cell.cfg, mix=cell.mix, spec=cell.spec,
                               seed=seed, seconds=seconds, trace=False,
                               device=card, t0=time.perf_counter())
    units = [(i, None) for i in range(cell.spec["check_units"])]
    for seed in (4_000_000_001, 4_000_000_002, 4_000_000_003):
        got = driver.check(context(seed, 0), units, cell.mix["batch"],
                           cell.mix["rollouts"], control_precision="tf32")
        assert not compare.verdict(got, cell.spec["limits"]), got
    out = driver.run(context(4_000_000_004, 3.0))
    assert out.correct, out.numbers
