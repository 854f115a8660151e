"""Quickstart on the PyTorch port: the paper in 60 seconds.

    PYTHONPATH=src python examples/quickstart_torch.py                # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

1. Computes the optimal heSRPT allocation for a job set (Theorem 7).
2. Simulates it and checks the closed-form total flow time (Theorem 8).
3. Shows the makespan-optimal heLRPT allocation (Theorem 2).
4. Runs the cluster scheduler with quantized (whole-chip) allocations.

Everything runs in float64 on ``--device``; the lines printed are those of
``examples/quickstart.py``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (  # noqa: E402
    helrpt,
    hesrpt,
    hesrpt_total_flowtime,
    optimal_makespan,
    simulate,
)
from repro_torch.device import DTYPE, resolve_device  # noqa: E402
from repro_torch.sched import ClusterScheduler, Job  # noqa: E402

TWO_JOBS = (1.0, 1.0)  # the paper's section 1 example: the 75/25 split
SIZES = (8.0, 5.0, 3.0, 2.0, 1.0)  # descending
P, N_SERVERS, N_CHIPS = 0.5, 100.0, 64


def quickstart(device="cuda", sizes=SIZES, p=P, n_servers=N_SERVERS, n_chips=N_CHIPS) -> dict:
    """Every number the example prints, as numpy arrays, floats and the
    cluster's chip allocation."""
    dev = resolve_device(device)

    def t(x):
        return torch.tensor(x, dtype=DTYPE, device=dev)

    def host(x):
        return x.cpu().numpy()

    x = t(sizes)
    res = simulate(x, p, n_servers, hesrpt, device=dev)
    mk = simulate(x, p, n_servers, helrpt, device=dev)
    sched = ClusterScheduler(n_chips, policy="hesrpt", device=dev)
    for i, s in enumerate(sizes):
        sched.add_job(Job(f"job{i}", size=float(s), p=p))
    alloc = sched.allocations()
    fluid = sched.run_fluid_to_completion()
    return {
        "theta_two": host(hesrpt(t(TWO_JOBS), 0.5)),
        "theta": host(hesrpt(x, p)),
        "total_flowtime": float(res.total_flowtime),
        "total_flowtime_closed": float(hesrpt_total_flowtime(x, p, n_servers)),
        "gamma": host(helrpt(x, p)),
        "makespan": float(mk.makespan),
        "makespan_closed": float(optimal_makespan(x, p, n_servers)),
        "completion_times": host(mk.completion_times),
        "alloc": alloc,
        "cluster_total_flow_time": float(fluid["total_flow_time"]),
        "fluid_optimum": float(hesrpt_total_flowtime(x, p, float(n_chips))),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    out = quickstart(args.device)
    print("two unit jobs, p=0.5  ->  theta* =", out["theta_two"])
    print("\n5 jobs (descending size), theta* =", np.round(out["theta"], 4))
    print(f"total flow time: simulated={out['total_flowtime']:.6f} "
          f"closed-form={out['total_flowtime_closed']:.6f}")
    print(f"\nheLRPT gamma* = {np.round(out['gamma'], 4)}")
    print(f"makespan: simulated={out['makespan']:.6f} "
          f"closed-form={out['makespan_closed']:.6f}")
    print("completion times:", np.round(out["completion_times"], 6))
    print(f"\n{N_CHIPS}-chip cluster, quantized heSRPT allocation:", out["alloc"])
    print(f"cluster total flow time: {out['cluster_total_flow_time']:.4f} "
          f"(fluid optimum {out['fluid_optimum']:.4f})")
    return out


if __name__ == "__main__":
    main()
