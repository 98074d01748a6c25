"""The output check at each cell's own size, on the card: the control
(the reference in TF32 in the program's place) fails the cell's limits
on three seeds, and a short window of the program passes them.  Skips
without a card; run on one with

    python3 -m pytest benchmark/tests/test_bench_chip.py -q
"""

import json
import time

import pytest
import torch

from benchmark import harness
from benchmark.reference import compare

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _context(cell, seed, seconds, device):
    return harness.Context(cfg=cell.cfg, mix=cell.mix, spec=cell.spec,
                           seed=seed, seconds=seconds, trace=False,
                           device=device, t0=time.perf_counter())


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_passes(name, card):
    harness.no_tf32()
    cell = harness.Cell.find(name)
    rollouts = cell.mix["rollouts"] if cell.mix["decode"] == "sample" \
        else None
    units = [(i, None) for i in range(cell.spec["check_units"])]
    for seed in (4_000_000_001, 4_000_000_002, 4_000_000_003):
        got = harness.check(_context(cell, seed, 0, card), units,
                            cell.mix["batch"], rollouts,
                            control_precision="tf32")
        assert not compare.verdict(got, cell.spec["limits"]), got
    driver = harness.load_module(
        harness.HERE / "drivers" / f"{cell.mix['driver']}.py", "driver")
    out = driver.run(_context(cell, 4_000_000_004, 3.0, card))
    assert out.correct, out.numbers
    assert torch.cuda.is_available()
