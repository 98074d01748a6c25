"""Runs a cell as the benchmark's check does, each run a process of its
own, and gives each metric's spread: a first run that builds the
kernels (recorded apart), then ``--sets`` sets of runs on the same
seeds, then ``--traced`` runs with ``--trace 1``.

    python3 benchmark/tools/sets.py --workload <cell> --seconds 20 \\
        --seeds 11,12,13,14,15,16 [--sets 2] [--traced 21,22,23]

prints one JSON line a run and a summary (each metric's median and
spread in each set: the distance between the quartiles of
``statistics.quantiles(values, n=4)`` over the median), and writes the
lines to ``chiprun_out/sets/<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.yardstick import stats  # noqa: E402


def run_once(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    lines = proc.stdout.strip().splitlines()
    record = {"seed": seed, "trace": trace, "rc": proc.returncode,
              "wall_s": time.perf_counter() - t}
    try:
        record["result"] = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        record["result"] = None
    if proc.returncode != 0 or record["result"] is None:
        record["stderr"] = proc.stderr[-4000:]
    else:
        record["stderr"] = proc.stderr[-600:]
    return record


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--traced", default="")
    p.add_argument("--prime-seed", type=int, default=2_999_999_999,
                   help="the seed of the first run (a negative one skips it)")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    traced = [int(s) for s in args.traced.split(",") if s]
    out_dir = ROOT / "chiprun_out" / "sets"
    out_dir.mkdir(parents=True, exist_ok=True)
    records = []

    def emit(record):
        records.append(record)
        print(json.dumps(record), flush=True)

    if args.prime_seed >= 0:
        emit({"set": "first", **run_once(args.workload, args.prime_seed,
                                         args.seconds, 0)})
    for k in range(args.sets):
        for seed in seeds:
            emit({"set": k, **run_once(args.workload, seed, args.seconds, 0)})
    for seed in traced:
        emit({"set": "traced", **run_once(args.workload, seed, args.seconds,
                                          1)})
    summary = {"workload": args.workload, "sets": {}}
    for k in range(args.sets):
        rows = [r["result"] for r in records
                if r["set"] == k and r["result"] is not None]
        per = {}
        for name in rows[0]["metrics"] if rows else []:
            vals = [r["metrics"][name]["value"] for r in rows]
            per[name] = {"median": statistics.median(vals),
                         "spread": stats.spread(vals) if len(vals) > 1
                         else None, "values": vals}
        summary["sets"][k] = {"runs": len(rows),
                              "correct": sum(r["correct"] for r in rows),
                              "metrics": per}
    emit(summary)
    with open(out_dir / f"{args.workload}.jsonl", "a") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
