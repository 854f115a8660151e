"""Driver ``sweep``: one unit is one whole grid of the online heSRPT model,
every (rate, seed) cell of it, through the port's ``core.sweeps.run_sweep``.

Traffic keys: ``n_seeds`` (the grid's seeds), ``whole_chips`` (round the
shares to the configuration's ``n_chips``), ``fused`` (the fused allocate),
``check_seeds`` (how many seeds, all their rates, the reference re-runs).
The grid's seed is the run's ``--seed``; every unit runs the same grid.

The answers are each cell's mean flow time and makespan.  The check draws
the sampled seeds' tapes again with the benchmark's own sampler, runs the
plain event loop on them in float64 and takes the largest relative gap of
each answer over every unit; a non-finite answer anywhere is a failure.
"""

from __future__ import annotations

import numpy as np
import torch

from bench import harness, yardstick
from bench.reference import scheduler, tapes

#: Each answer of a grid cell, and the name of its check.
ANSWERS = {"mean_flowtime": "flow_gap", "makespan": "makespan_gap"}


def sample_seeds(seed: int, n_seeds: int, k: int) -> np.ndarray:
    """``k`` distinct seed indices of ``n_seeds``, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n_seeds, min(k, n_seeds), replace=False))


def reference_answers(cell, seed: int, seeds, device, dtype=torch.float64) -> dict:
    """The plain reference's answers ``[R, len(seeds)]`` for grid seeds
    ``seeds``; ``dtype`` float32 gives the control."""
    cfg, tr = cell.config, cell.traffic
    rates, M = cfg["rates"], cfg["n_jobs"]
    drawn = [tapes.poisson_pareto(seed, int(s), rates, M, cfg["size_alpha"], device)
             for s in seeds]
    x0 = torch.cat([x for x, _ in drawn]).to(dtype)
    arr = torch.cat([a for _, a in drawn]).to(dtype)
    p = cfg["p"]
    times = scheduler.completion_times(
        x0, arr, p, cfg["n_servers"], lambda x: scheduler.hesrpt(x, p),
        n_chips=cfg["n_chips"] if tr["whole_chips"] else None, min_chips=cfg["min_chips"])
    R, k = len(rates), len(seeds)
    flows = (times - arr).to(torch.float64)
    out = {"mean_flowtime": flows.mean(-1), "makespan": times.to(torch.float64).amax(-1)}
    return {m: v.reshape(k, R).T.cpu().numpy() for m, v in out.items()}


class SweepWork(harness.Work):
    def __init__(self, cell, seed: int, device):
        from repro_torch.core.sweeps import Sweep

        cfg, tr = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        kw = {}
        if tr["whole_chips"]:
            kw = dict(n_chips=cfg["n_chips"], min_chips=cfg["min_chips"], fused=tr["fused"])
        self.spec = Sweep.create(
            ("hesrpt",), cfg["rates"], scenario="poisson", n_jobs=cfg["n_jobs"],
            n_seeds=tr["n_seeds"], seed=seed, p=cfg["p"], n_servers=cfg["n_servers"],
            size_alpha=cfg["size_alpha"], metrics=tuple(ANSWERS), **kw)
        M = cfg["n_jobs"]
        rows = len(cfg["rates"]) * tr["n_seeds"]  # the grid's [C, M]
        quantized = bool(tr["whole_chips"])
        self.jobs_per_unit = self.spec.total_jobs()
        self.steps_per_unit = 2 * M
        self.loop_bytes_per_unit = 2 * M * yardstick.event_step_bytes(rows, M, "float64",
                                                                      quantized)
        if tr.get("fused"):
            self.alloc_launch_bytes = yardstick.alloc_launch_bytes(rows, M, "float64", quantized)

    def unit(self, k: int) -> dict:
        from repro_torch.core.sweeps import run_sweep

        res = run_sweep(self.spec, log=False, device=self.device)
        return {m: res.stats["hesrpt"][m] for m in ANSWERS}

    def check(self, outputs: list) -> harness.Verdict:
        tr, limits = self.cell.traffic, self.cell.limits
        S = tr["n_seeds"]
        seeds = sample_seeds(self.seed, S, tr["check_seeds"])
        ref = reference_answers(self.cell, self.seed, seeds, self.device)
        failed = sum(int((~np.isfinite(o[m])).sum()) for o in outputs for m in ANSWERS)
        checks = []
        for m, name in ANSWERS.items():
            gaps = np.stack([np.abs(o[m][:, seeds] - ref[m]) / np.abs(ref[m]) for o in outputs])
            gaps = np.where(np.isfinite(gaps), gaps, np.inf)
            failed += int((gaps > limits[name]).sum())
            checks.append(harness.Check(name, float(gaps.max()), limits[name]))
        return harness.Verdict(checks, attempted=len(outputs) * self.spec.n_seeds
                               * len(self.spec.rates), failed=failed)


def prepare(cell, seed: int, device) -> SweepWork:
    return SweepWork(cell, seed, device)


def control_unit(work: SweepWork, k: int) -> dict:
    """The reference in float32 in the program's place: the whole grid."""
    return reference_answers(work.cell, work.seed, range(work.cell.traffic["n_seeds"]),
                             work.device, dtype=torch.float32)
