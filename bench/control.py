"""The readings a cell's limits are set from, in one process on a card.

    python3 bench/control.py --workload <cell> [--seeds N ...] [--control-seeds N ...]

For each of ``--seeds`` it runs the cell's program once (one unit) and
checks the answers as a benchmark run does: the lower readings.  For each of ``--control-seeds`` it puts the
plain reference, computed in float32, in the program's place at the cell's
own size and checks that the same way: the upper readings, which have to
fail the limits.  Prints one JSON line a reading.  Without a card it exits
with 2.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, device, control: bool, driver) -> dict:
    """Every check of one seed: the program's, or the control's."""
    work = driver.prepare(cell, seed, device)
    t0 = time.perf_counter()
    out = driver.control_unit(work, 0) if control else work.unit(0)
    wall = time.perf_counter() - t0
    verdict = work.check([out])
    return {"workload": cell.name, "seed": seed, "side": "control" if control else "program",
            "correct": verdict.correct, "unit_s": wall,
            "checks": {c.name: c.value for c in verdict.checks}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("control.py: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    driver = harness.load_driver(cell.driver)
    device = torch.device("cuda", 0)
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            print(json.dumps(readings(cell, seed, device, control, driver)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
