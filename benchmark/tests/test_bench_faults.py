"""The output check catches the faults a cell can have: each test drives
the rest of a run (the harness's look for a card skipped, on the CPU at
a tiny geometry) with the timed path broken underneath, and sees
``correct`` come out false.  A cell on one card has no exchange between
chips to leave out."""

import pytest
from conftest import run_tiny

CELLS = ["osie.generate", "air.generate", "osie.request"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_unchanged(cell, monkeypatch):
    from scanpaths_tpu_torch.ops import cell as cell_ops
    monkeypatch.setattr(cell_ops, "cell_step",
                        lambda h, c, *args: (h, c))
    out = run_tiny(cell)
    assert not out.correct, out.numbers


@pytest.mark.parametrize("cell", ["osie.generate", "air.generate"])
def test_half_of_the_batch_left_out(cell, monkeypatch):
    """The trunk runs the first half of the batch and serves its grid
    for the second half too."""
    import torch

    from scanpaths_tpu_torch.models import resnet
    real = resnet.fused_forward

    def half(net, images, dtype=torch.float32):
        x = real(net, images[: images.shape[0] // 2], dtype)
        return torch.cat([x, x])
    monkeypatch.setattr(resnet, "fused_forward", half)
    out = run_tiny(cell)
    assert not out.correct, out.numbers


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced(cell, monkeypatch):
    """The decoder's first fixation of the first scanpath moves one cell
    to the right (the last cell wraps to the first)."""
    from scanpaths_tpu_torch.ops import sampling
    real = sampling._decode

    def altered(probs, actions, durations, grid):
        actions = actions.clone()
        first = actions.reshape(-1, actions.shape[-1])
        first[0, 0] = first[0, 0] % grid.num_cells + 1
        return real(probs, actions, durations, grid)
    monkeypatch.setattr(sampling, "_decode", altered)
    out = run_tiny(cell)
    assert not out.correct, out.numbers
