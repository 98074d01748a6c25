"""``readings.py`` for a cell whose driver brings its own output check
(a ``check`` in ``drivers/<driver>.py`` with ``harness.check``'s
arguments, as ``drivers/search.py`` has): the control's readings go
through that check in place of ``harness.check``, whose reference
computes the free-viewing and VQA models only.

    python3 benchmark/tools/own_check_readings.py --workload coco.generate \\
        --seeds 16 --control-seeds 5 [--seconds 2] [--first-seed N]

Its arguments, output and files are ``readings.py``'s.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--workload", required=True)
    workload = p.parse_known_args(argv)[0].workload
    cell = harness.Cell.find(workload)
    driver = harness.load_module(
        harness.HERE / "drivers" / f"{cell.mix['driver']}.py", "driver")
    harness.check = driver.check
    readings = harness.load_module(harness.HERE / "tools" / "readings.py",
                                   "readings")
    return readings.main(argv)


if __name__ == "__main__":
    sys.exit(main())
