"""Diagnostics of allocation trajectories and per-cell sweep summaries.

Port of ``repro.core.analysis``'s single-class part: ``system_efficiency``,
``scale_free_constants`` (Thm 4's omega per epoch), ``summarize``,
``time_weighted_stats`` (the host-side reduction the telemetry probes'
stream aggregates are held to) and ``seed_axis_stats``.  The per-class
aggregates wait for the multi-class runs (ROADMAP.md Queue A, item 6b).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.simulator import SimResult


def system_efficiency(theta: torch.Tensor, p) -> torch.Tensor:
    """Total service rate relative to the embarrassingly parallel capacity:
    ``sum_i s(theta_i N) / s(N) = sum_i theta_i^p`` over the last dim."""
    return torch.where(theta > 0, theta.pow(p), 0.0).sum(-1)


def scale_free_constants(result: SimResult) -> torch.Tensor:
    """Empirical omega of each job at each epoch, ``[..., E, M]``: the
    theta of the jobs before it in job order over its own theta (nan where
    the job is inactive).  Thm 4 says it stays constant across epochs for
    heSRPT when ``x0`` is sorted descending (callers pass such instances,
    so ranks are static and the larger jobs are a prefix)."""
    theta = result.theta_trace
    active = result.sizes_trace > 0
    csum = theta.cumsum(-1) - theta
    return torch.where(active & (theta > 0), csum / theta, torch.nan)


def time_weighted_stats(values, dts) -> dict[str, float]:
    """Time-weighted ``{"mean", "max", "time"}`` of one per-event series:
    the mean weighted by epoch length, the max over epochs of positive
    length.  NumPy on purpose: host-side artifacts."""
    v = np.asarray(values, dtype=np.float64)
    dt = np.asarray(dts, dtype=np.float64)
    t = float(dt.sum())
    live = dt > 0
    return {
        "mean": float((v * dt).sum() / t) if t > 0 else 0.0,
        "max": float(v[live].max()) if live.any() else 0.0,
        "time": t,
    }


def seed_axis_stats(values) -> dict[str, list]:
    """Per-cell ``{"mean": [...], "std": [...]}`` of a ``[n_rates, n_seeds]``
    sweep stat, seed axis reduced.  NumPy on purpose: host-side artifacts."""
    a = np.asarray(values)
    return {"mean": np.mean(a, axis=1).tolist(), "std": np.std(a, axis=1).tolist()}


def summarize(result: SimResult, p) -> dict[str, torch.Tensor]:
    """Total and mean flow time, makespan and the first epoch's
    :func:`system_efficiency` of a batch run."""
    return {
        "total_flowtime": result.total_flowtime,
        "mean_flowtime": result.total_flowtime / result.completion_times.shape[-1],
        "makespan": result.makespan,
        "initial_efficiency": system_efficiency(result.theta_trace[..., 0, :], p),
    }
