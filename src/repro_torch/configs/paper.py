"""Scheduler-experiment configs for the paper's own evaluation (Fig 3/4).

A copy of ``repro.configs.paper``: the paper's experiment knobs, beside the
architecture configs, so each figure is reproducible from a config.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SchedulerExperiment:
    name: str
    n_servers: float
    n_jobs: int
    pareto_shape: float
    p_values: tuple[float, ...]
    n_seeds: int
    policies: tuple[str, ...]


# Figure 4: N = 1e6 servers, M = 500 jobs, Pareto(1.5) sizes, 10 seeds,
# median of mean flow times, p in {.05, .3, .5, .9, .99}.
FIG4 = SchedulerExperiment(
    name="fig4",
    n_servers=1e6,
    n_jobs=500,
    pareto_shape=1.5,
    p_values=(0.05, 0.3, 0.5, 0.9, 0.99),
    n_seeds=10,
    policies=("hesrpt", "srpt", "equi", "hell", "knee"),
)

# Figure 3: 3-job trace, s(k) = k^0.5, N = 500.
FIG3 = SchedulerExperiment(
    name="fig3",
    n_servers=500.0,
    n_jobs=3,
    pareto_shape=0.0,  # fixed sizes, see repro_torch/figures.py::fig3_trace
    p_values=(0.5,),
    n_seeds=1,
    policies=("hesrpt",),
)
