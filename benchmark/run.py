"""Runs one cell of the benchmark of ``scanpaths_tpu_torch`` once, on the
card of the machine it starts on:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``; its configuration, traffic mix and output check
come from the files that entry names (``harness.py``).  The run makes
its weights and inputs from ``--seed``, warms up its own shapes, measures
for ``--seconds``, checks what the timed path produced against the plain
reference, and prints as the last line of standard output one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, read by
``metrics/<name>.py``), ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each number compared beside its limit (also the last
lines of standard error).

Without a CUDA card, or fewer than the cell asks for, it exits 2 and
prints no result; if JAX or the JAX package is loaded once the window
has closed, it exits 3 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if sys.path[0] == str(ROOT / "benchmark"):
    sys.path[0] = str(ROOT)
else:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def read_metrics(cell: harness.Cell, outcome: harness.Outcome,
                 trace: bool) -> dict:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones, each read by its reader (a reader that finds nothing to read
    leaves its metric out)."""
    out = {}
    if not trace:
        for m in cell.end_to_end():
            value = outcome.setup_s if m["name"] == "setup_s" \
                else outcome.e2e[m["name"]]
            out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
    for m in cell.per_layer():
        reader = harness.load_module(
            harness.HERE / "metrics" / f"{m['name']}.py",
            f"metric_{m['name'].replace('.', '_')}")
        value = reader.read(outcome, cell)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    print(f"setup: torch imported at {time.perf_counter() - T0:.2f} s",
          file=sys.stderr, flush=True)
    cell = harness.Cell.find(args.workload)
    harness.require_cards(cell.entry["chips"])
    print(harness.card_line(), flush=True)
    harness.no_tf32()
    ctx = harness.Context(cfg=cell.cfg, mix=cell.mix, spec=cell.spec,
                          seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace),
                          device=torch.device("cuda", 0), t0=T0)
    driver = harness.load_module(
        harness.HERE / "drivers" / f"{cell.mix['driver']}.py",
        f"driver_{cell.mix['driver']}")
    outcome = driver.run(ctx)
    metrics = read_metrics(cell, outcome, ctx.trace)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.entry["chips"],
              "memory_peak_bytes": outcome.peak_bytes}
    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics,
              "device": device}
    if ctx.trace:
        trace = outcome.trace
        device["busy_s"] = trace.busy_us() / 1e6
        device["window_s"] = trace.window_us / 1e6
        result["breakdown"] = {"device_ops": trace.top_ops(10),
                               "idle_gaps": trace.idle_gaps(10)}
    result["checks"] = {k: {"value": v, "limit": outcome.limits[k]}
                        for k, v in outcome.numbers.items() if v is not None}
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"loaded in the run's process: {', '.join(loaded)}",
              file=sys.stderr)
        return harness.NO_RESULT
    for k, v in outcome.numbers.items():
        print(f"check {k}: " + ("not read: the reference's duration head "
                                "is constant" if v is None else
                                f"{v:.6g} (limit {outcome.limits[k]:.6g})"),
              file=sys.stderr)
    print(f"check failed requests: {outcome.failed} (limit 0)",
          file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
