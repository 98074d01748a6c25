"""The plain reference against the program, on the CPU at a tiny
geometry: its weight layout is the program's reference layout, each
cell's run through the program's plain path comes out correct against
it, and its control in a lower precision does not."""

import pytest
import torch
from conftest import TINY, run_tiny, tiny_context

from benchmark import harness
from benchmark.reference import compare, model, sampler, weights


@pytest.mark.parametrize("task", ["osie", "air"])
def test_the_layout_is_the_programs_reference_layout(task):
    from scanpaths_tpu_torch.models.port import to_reference_state_dict
    from scanpaths_tpu_torch.models.scanpath_model import ScanpathModel
    cfg = {**harness.Cell.find(f"{task}.generate").cfg, **TINY}
    net = ScanpathModel(task, embed=cfg["embed"], seq_len=cfg["max_length"],
                        map_h=cfg["map_height"], map_w=cfg["map_width"],
                        backbone_layers=tuple(cfg["backbone_layers"]))
    ref = to_reference_state_dict(net.state_dict(), task, cfg["map_height"],
                                  cfg["map_width"])
    ours = {k: shape for k, shape, _, _ in weights.layout(cfg)}
    assert ours == {k: tuple(v.shape) for k, v in ref.items()}


def test_weights_follow_the_seed():
    cfg = {**harness.Cell.find("osie.generate").cfg, **TINY}
    a, scales = weights.make_state_dict(cfg, 5, "cpu")
    b, again = weights.make_state_dict(cfg, 5, "cpu", scales)
    c, _ = weights.make_state_dict(cfg, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a) and again is scales
    assert not torch.equal(a["sal_conv.weight"], c["sal_conv.weight"])
    assert a["resnet.1.running_var"].min() > 0
    assert torch.allclose(a["object_head.drt_layer_2.bias"],
                          torch.log(torch.tensor([0.25, 0.3])))


def test_the_reference_trunk_is_the_programs():
    from scanpaths_tpu_torch.models.port import load_reference_state_dict
    from scanpaths_tpu_torch.models.resnet import fused_forward
    from scanpaths_tpu_torch.models.scanpath_model import ScanpathModel
    cfg = {**harness.Cell.find("osie.generate").cfg, **TINY}
    sd, _ = weights.make_state_dict(cfg, 11, "cpu")
    net = ScanpathModel("osie", embed=cfg["embed"], seq_len=cfg["max_length"],
                        map_h=cfg["map_height"], map_w=cfg["map_width"],
                        backbone_layers=tuple(cfg["backbone_layers"]))
    net.load_state_dict(load_reference_state_dict(sd, "osie"))
    images, _ = harness.inputs(cfg, 2, 11, 0, "cpu")
    with torch.no_grad():
        got = fused_forward(net.backbone, images)
    want = model.trunk(sd, cfg, images).permute(0, 2, 3, 1)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cell", ["osie.generate", "air.generate",
                                  "osie.request"])
def test_the_program_is_correct_and_the_control_is_not(cell):
    """A run of the cell at the tiny geometry reads inside a tenth of
    every limit; the reference in bfloat16 in the program's place (the
    CPU has no TF32) fails at least one."""
    out = run_tiny(cell)
    assert out.correct, out.numbers
    assert all(v <= 0.1 * out.limits[k] for k, v in out.numbers.items()
               if v is not None), \
        out.numbers
    ctx = tiny_context(cell)
    rollouts = ctx.mix["rollouts"] if ctx.mix["decode"] == "sample" \
        else None
    got = harness.check(ctx, [(0, None), (1, None)], ctx.mix["batch"],
                        rollouts, control_precision="bfloat16")
    assert not compare.verdict(got, ctx.spec["limits"]), got


def test_the_sampler_rules():
    cfg = {**harness.Cell.find("osie.generate").cfg, **TINY}
    steps = cfg["max_length"]
    logits = torch.zeros(1, steps, 101)
    logits[0, :, 0] = 50.0          # STOP everywhere but where barred
    logits[0, 0, 12] = 10.0
    actions, durations, fix, length = sampler.greedy(
        logits, torch.zeros(1, steps), cfg)
    assert actions[0, 0].tolist() == [12, 0, 0, 0]
    assert length.tolist() == [[1]]
    # action 12 is cell 11: row 1, column 1 of a 10-wide map of 8 px cells
    assert fix[0, 0, 0].tolist() == [12.0, 12.0, 1.0]
    assert fix[0, 0, 1:].abs().sum() == 0
