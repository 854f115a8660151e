"""Recompute ``trace_analysis`` for every dry-run record from its saved
trace: lets the cost model evolve without tracing again (analysis from the
artifact).  Port of ``repro.launch.reanalyze``.

    PYTHONPATH=src python -m repro_torch.launch.reanalyze results/dryrun
"""

import glob
import json
import sys

from repro_torch.launch.trace_analysis import analyze_trace, read_trace


def main(dirs):
    n = 0
    for d in dirs:
        for path in sorted(glob.glob(f"{d}/*.json")):
            with open(path) as f:
                rec = json.load(f)
            if rec.get("status") != "ok":
                continue
            try:
                trace = read_trace(path.replace(".json", ".trace.jsonl.gz"))
            except FileNotFoundError:
                continue
            rec["trace_analysis"] = analyze_trace(trace)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            n += 1
    print(f"reanalyzed {n} records")


if __name__ == "__main__":
    main(sys.argv[1:] or ["results/dryrun"])
