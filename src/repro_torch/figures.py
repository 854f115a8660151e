"""The paper's two figures through the port: Fig 3's trace and Fig 4's
comparison of heSRPT with SRPT, EQUI, HELL and KNEE.

Port of ``benchmarks/fig3_trace.py`` and ``benchmarks/fig4_policies.py``
(same tapes, same sizes).  Fig 4's sizes come from
``numpy.random.default_rng(seed).pareto(shape, M) + 1``, sorted
descending, so both packages see identical tapes.  For each ``p`` each
policy is one batch run over all its rows (``simulator.total_flowtime``):
one row a seed, and for KNEE one a (seed, alpha) pair, its best alpha
taken afterwards, as the paper treats KNEE.  The heSRPT column runs the
rule's fused allocate: one alloc-kernel launch per event step on the card.

``python -m repro_torch.figures [--quick] [--device cpu]`` prints both.
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.paper import FIG3, FIG4
from repro_torch.core import simulator
from repro_torch.core.policies import hesrpt, knee, make_policy
from repro_torch.device import as_tensor, resolve_device

#: KNEE's alpha grid: N_ALPHA log-spaced points over the range, its best
#: taken, as the reference's.
KNEE_ALPHA_RANGE = (-6.0, 2.0)
N_ALPHA = 12
QUICK = dict(n_jobs=100, n_seeds=3, n_alpha=6)


def fig3_trace(sizes=(3000.0, 2000.0, 1000.0), p: float = FIG3.p_values[0],
               n_servers: float = FIG3.n_servers, *, device="cuda") -> dict:
    """heSRPT's trajectory on Fig 3's three jobs: completion times, epoch
    start times, and the shares and remaining sizes at each epoch."""
    res = simulator.simulate(torch.tensor(sizes), p, n_servers, hesrpt, device=device)
    return {
        "completion_times": res.completion_times.cpu().numpy(),
        "epoch_times": res.epoch_times.cpu().numpy(),
        "theta_trace": res.theta_trace.cpu().numpy(),
        "sizes_trace": res.sizes_trace.cpu().numpy(),
    }


class Fig4Result(NamedTuple):
    medians: dict  # {p: {policy: median over seeds of the mean flow time}}
    flows: dict  # {p: {policy: ndarray [n_seeds] of mean flow times}}
    sizes: np.ndarray  # [n_seeds, n_jobs] the tapes, descending


def fig4_tapes(n_jobs: int, n_seeds: int, pareto_shape: float) -> np.ndarray:
    """Fig 4's job sizes, one descending row a seed."""
    return np.stack([
        np.sort(np.random.default_rng(seed).pareto(pareto_shape, n_jobs) + 1.0)[::-1]
        for seed in range(n_seeds)
    ])


def fig4_policies(quick: bool = False, device="cuda") -> Fig4Result:
    """Fig 4 at ``FIG4``'s size: the median over seeds of each policy's mean
    flow time, per ``p``; ``quick`` cuts it to :data:`QUICK`'s size."""
    n_servers, p_values = FIG4.n_servers, FIG4.p_values
    n_jobs, n_seeds, n_alpha = FIG4.n_jobs, FIG4.n_seeds, N_ALPHA
    if quick:
        n_jobs, n_seeds, n_alpha = QUICK["n_jobs"], QUICK["n_seeds"], QUICK["n_alpha"]
    dev = resolve_device(device)
    sizes = fig4_tapes(n_jobs, n_seeds, FIG4.pareto_shape)
    x = as_tensor(sizes, dev)
    alphas = np.logspace(*KNEE_ALPHA_RANGE, n_alpha)
    # KNEE's rows: seed-major, each seed once per alpha.
    x_knee = x.repeat_interleave(n_alpha, 0)
    alpha_col = as_tensor(np.tile(alphas, n_seeds)[:, None], dev)
    medians, flows = {}, {}
    for p in p_values:
        medians[p], flows[p] = {}, {}
        for name in FIG4.policies:
            if name == "knee":
                pol = functools.partial(knee, n_servers=n_servers, alpha=alpha_col)
                total = simulator.total_flowtime(x_knee, p, n_servers, pol, device=dev)
                total = total.reshape(n_seeds, n_alpha).amin(-1)
            else:
                total = simulator.total_flowtime(
                    x, p, n_servers, make_policy(name, n_servers=n_servers),
                    fused=name == "hesrpt", device=dev,
                )
            f = total.cpu().numpy() / n_jobs
            flows[p][name] = f
            medians[p][name] = float(np.median(f))
    return Fig4Result(medians=medians, flows=flows, sizes=sizes)


def advantage(medians: dict) -> dict:
    """Per ``p``: the best competitor's median over heSRPT's."""
    return {
        p: min(v for k, v in meds.items() if k != "hesrpt") / meds["hesrpt"]
        for p, meds in medians.items()
    }


def fig4_table(medians: dict) -> str:
    """The medians as the reference's table, with heSRPT's advantage."""
    names = FIG4.policies
    lines = [f"{'p':>5s} " + " ".join(f"{n:>12s}" for n in names)]
    for p, meds in medians.items():
        lines.append(f"{p:5.2f} " + " ".join(f"{meds[n]:12.4g}" for n in names))
    adv = advantage(medians)
    lines.append("heSRPT advantage vs best competitor per p: "
                 + ", ".join(f"p={p}: {a:.2f}x" for p, a in adv.items()))
    lines.append(f"max advantage: {max(adv.values()):.2f}x (paper claims >= 1.3x)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="100 jobs, 3 seeds, 6 alphas")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    tr = fig3_trace(device=args.device)
    print("Fig 3: epoch | theta | remaining sizes")
    for t, th, xs in zip(tr["epoch_times"], tr["theta_trace"], tr["sizes_trace"], strict=True):
        print(f"{t:8.2f} | " + " ".join(f"{v:7.4f}" for v in th) + " | "
              + " ".join(f"{v:7.1f}" for v in xs))
    print(f"completions: {tr['completion_times'].round(2).tolist()}")
    t0 = time.perf_counter()
    res = fig4_policies(quick=args.quick, device=args.device)
    print(f"Fig 4 ({'quick' if args.quick else 'full'} size, {args.device}, "
          f"{time.perf_counter() - t0:.2f} s):")
    print(fig4_table(res.medians))
    return 0


if __name__ == "__main__":
    sys.exit(main())
