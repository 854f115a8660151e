"""Driver ``class_sweep``: one unit is one whole grid of the multi-class
online model, every (rate, seed) cell of it under one class-aware policy,
through the port's ``core.sweeps.run_sweep`` (``Sweep(classes=)``, the
``multiclass_poisson`` tapes, per-job exponents through ``engine.run``).

Traffic keys: ``policy`` (the class-aware policy; the reference has
water-filling), ``n_seeds`` (the grid's seeds), ``check_seeds`` (how many
seeds, all their rates, the reference re-runs).  The grid's seed is the
run's ``--seed``; every unit runs the same grid.

The answers are each cell's mean flow time, mean slowdown, makespan and
per-class mean flow time.  The check draws the sampled seeds' tapes again
with the reference's own copy of the draw, runs the plain event loop on them
in float64 and takes the largest relative gap of each answer over every
unit; a non-finite answer anywhere is a failure.
"""

from __future__ import annotations

import numpy as np
import torch

from bench import harness, yardstick
from bench.drivers.sweep import sample_seeds
from bench.reference import multiclass, tapes

#: Each answer of a grid cell, and the name of its check.
ANSWERS = {"mean_flowtime": "flow_gap", "mean_slowdown": "slowdown_gap",
           "makespan": "makespan_gap", "class_flowtime": "class_flow_gap"}


def reference_answers(cell, seed: int, seeds, device, dtype=torch.float64) -> dict:
    """The plain reference's answers ``[R, len(seeds)]`` (``[R, len(seeds),
    K]`` per class) for grid seeds ``seeds``; ``dtype`` float32 gives the
    control."""
    cfg = cell.config
    if cell.traffic["policy"] != "waterfill":
        raise ValueError(f"the reference has water-filling, not {cell.traffic['policy']!r}")
    rates, M, classes = cfg["rates"], cfg["n_jobs"], cfg["classes"]
    drawn = [multiclass.draw(tapes.seed_generator(seed, int(s), device), rates, M, classes)
             for s in seeds]
    x0, arr, ids = (torch.cat(parts) for parts in zip(*drawn))
    out = multiclass.answers(x0, arr, ids, classes, cfg["n_servers"], dtype)
    R, k = len(rates), len(seeds)
    return {m: v.reshape(k, R, *v.shape[1:]).transpose(0, 1).cpu().numpy()
            for m, v in out.items()}


class ClassSweepWork(harness.Work):
    def __init__(self, cell, seed: int, device):
        from repro_torch.core.sweeps import Sweep

        cfg, tr = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        self.spec = Sweep.create(
            (tr["policy"],), cfg["rates"], scenario=cfg["scenario"], n_jobs=cfg["n_jobs"],
            n_seeds=tr["n_seeds"], seed=seed, n_servers=cfg["n_servers"],
            classes=cfg["classes"], metrics=tuple(ANSWERS))
        M = cfg["n_jobs"]
        rows = len(cfg["rates"]) * tr["n_seeds"]  # the grid's [C, M]
        self.jobs_per_unit = self.spec.total_jobs()
        self.steps_per_unit = 2 * M
        self.loop_bytes_per_unit = 2 * M * yardstick.event_step_bytes(rows, M, "float64", False)

    def unit(self, k: int) -> dict:
        from repro_torch.core.sweeps import run_sweep

        res = run_sweep(self.spec, log=False, device=self.device)
        return {m: res.stats[self.spec.policies[0]][m] for m in ANSWERS}

    def check(self, outputs: list) -> harness.Verdict:
        tr, limits = self.cell.traffic, self.cell.limits
        seeds = sample_seeds(self.seed, tr["n_seeds"], tr["check_seeds"])
        ref = reference_answers(self.cell, self.seed, seeds, self.device)
        # A (rate, seed) cell of a unit fails if any of its answers is not
        # finite or, for a checked seed, off by more than its limit.
        bad = np.zeros((len(outputs), len(self.spec.rates), tr["n_seeds"]), dtype=bool)
        checks = []
        for m, name in ANSWERS.items():
            got = np.stack([o[m] for o in outputs])
            bad |= _per_cell(~np.isfinite(got))
            gaps = np.abs(got[:, :, seeds] - ref[m]) / np.abs(ref[m])
            gaps = np.where(np.isfinite(gaps), gaps, np.inf)
            bad[:, :, seeds] |= _per_cell(gaps > limits[name])
            checks.append(harness.Check(name, float(gaps.max()), limits[name]))
        return harness.Verdict(checks, attempted=bad.size, failed=int(bad.sum()))


def _per_cell(flags: np.ndarray) -> np.ndarray:
    """``[U, R, S]`` flags of the cells; a per-class answer's ``[U, R, S, K]``
    flags any class."""
    return flags.any(-1) if flags.ndim == 4 else flags


def prepare(cell, seed: int, device) -> ClassSweepWork:
    return ClassSweepWork(cell, seed, device)


def control_unit(work: ClassSweepWork, k: int) -> dict:
    """The reference in float32 in the program's place: the whole grid."""
    return reference_answers(work.cell, work.seed, range(work.cell.traffic["n_seeds"]),
                             work.device, dtype=torch.float32)
