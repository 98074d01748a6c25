"""The readings that a cell's output limits are set from, in one process
on the card: the program's numbers over many seeds (each a short window
at the cell's own load, checked as a run checks it) and the control's
(the reference in TF32 in the program's place) over a few more.

    python3 benchmark/tools/readings.py --workload <cell> \\
        --seeds 12 --control-seeds 3 [--seconds 2] [--first-seed N]

prints one JSON line a reading and a summary line with each number's
largest program reading and smallest control reading, and writes the
lines to ``chiprun_out/readings/<cell>.jsonl``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402
from benchmark.reference import compare  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = p.parse_args(argv)
    cell = harness.Cell.find(args.workload)
    harness.require_cards(cell.entry["chips"])
    print(harness.card_line(), flush=True)
    harness.no_tf32()
    driver = harness.load_module(
        harness.HERE / "drivers" / f"{cell.mix['driver']}.py", "driver")
    out_dir = ROOT / "chiprun_out" / "readings"
    out_dir.mkdir(parents=True, exist_ok=True)
    lines = []

    def ctx(seed, seconds):
        return harness.Context(cfg=cell.cfg, mix=cell.mix, spec=cell.spec,
                               seed=seed, seconds=seconds, trace=False,
                               device=torch.device("cuda", 0),
                               t0=time.perf_counter())

    def emit(record):
        lines.append(record)
        print(json.dumps(record), flush=True)

    for k in range(args.seeds):
        seed = args.first_seed + k
        out = driver.run(ctx(seed, args.seconds))
        emit({"side": "program", "seed": seed, "units": out.attempted,
              "numbers": out.numbers, "correct": out.correct})
    rollouts = cell.mix["rollouts"] if cell.mix["decode"] == "sample" \
        else None
    for k in range(args.control_seeds):
        seed = args.first_seed + 1000 + k
        units = [(i, None) for i in range(cell.spec["check_units"])]
        got = harness.check(ctx(seed, 0), units, cell.mix["batch"], rollouts,
                            control_precision="tf32")
        emit({"side": "control", "seed": seed, "numbers": got})
    program = [r["numbers"] for r in lines if r["side"] == "program"]
    ctrl = [r["numbers"] for r in lines if r["side"] == "control"]
    summary = {"workload": args.workload,
               "program_max": compare.worst(program) if program else None,
               "control_min": {k: min((r[k] for r in ctrl
                                       if r[k] is not None), default=None)
                               for k in compare.NUMBERS} if ctrl else None,
               "seconds": time.perf_counter() - T0}
    emit(summary)
    with open(out_dir / f"{args.workload}.jsonl", "a") as f:
        for r in lines:
            f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
