"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It loads the port (``src/repro_torch``),
warms the cell's own shapes with one whole unit of work, runs units back
to back for ``--seconds`` (``--trace 1``: under ``torch.profiler``), checks
every unit's answers against the plain reference in ``bench/reference/``,
prints each number compared beside its limit on standard error and the
result as one JSON line on standard output.  Without as many CUDA cards as
the cell asks for it exits with 2 and prints no result; with a module of
the JAX stack or of the JAX package loaded, with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a workload name of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench import harness

    cell = harness.load_cell(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA card(s), found {found}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), T_START)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"run.py: modules of the JAX stack or package are loaded: {bad}", file=sys.stderr)
        return 3
    print(f"setup_s includes a kernel build of {out['build_s']!r} s", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
