"""Helpers of the benchmark's CPU tests: the cells' files at a tiny
geometry, run on the CPU through the program's plain kernels."""

import time

import pytest
import torch

from benchmark import harness

# the tiny geometry: 80x80 images, a 10x10 map (divisible by 5, as the
# composed head needs), T = 4, embed 64, two blocks in stages 1-3 so
# that the stage path runs
TINY = dict(height=80, width=80, map_height=10, map_width=10, max_length=4,
            embed=64, backbone_layers=[2, 2, 2, 1])


def tiny_context(cell: str, seed: int = 2**31 + 7, seconds: float = 0.5,
                 **mix) -> harness.Context:
    """The context of ``cell`` at the tiny geometry on the CPU, its mix at
    a batch of 2 (1 for requests) and 3 rollouts, two units checked."""
    c = harness.Cell.find(cell)
    cfg = {**c.cfg, **TINY}
    m = {**c.mix, "batch": min(c.mix["batch"], 2),
         "rollouts": min(c.mix["rollouts"], 3), **mix}
    spec = {**c.spec, "check_units": 2}
    return harness.Context(cfg=cfg, mix=m, spec=spec, seed=seed,
                           seconds=seconds, trace=False,
                           device=torch.device("cpu"),
                           t0=time.perf_counter())


def run_tiny(cell: str, **kw) -> harness.Outcome:
    ctx = tiny_context(cell, **kw)
    driver = harness.load_module(
        harness.HERE / "drivers" / f"{ctx.mix['driver']}.py",
        f"driver_{ctx.mix['driver']}")
    return driver.run(ctx)


@pytest.fixture(autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    """Skips a test unless the machine has a CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


