"""Diagnostics of allocation trajectories and per-cell sweep summaries.

Port of ``repro.core.analysis``: ``system_efficiency``,
``scale_free_constants`` (Thm 4's omega per epoch), ``summarize``,
``time_weighted_stats`` (the host-side reduction the telemetry probes'
stream aggregates are held to), ``seed_axis_stats`` and the per-class
aggregates of the multi-class runs (``per_class_mean``, ``per_class_count``,
``per_class_summary``).

The per-class sums are masked sums over a one-hot ``[..., M, K]`` class
mask, not ``scatter_add_`` / ``index_add_``: on CUDA those add with atomics
where many jobs share a class, so the order of the adds, and the last bits
of a float64 mean, would change from run to run.
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


def _class_mask(class_ids, n_classes: int) -> torch.Tensor:
    """One-hot ``[..., M, K]`` mask of each job's class."""
    ids = torch.as_tensor(class_ids)
    return ids.unsqueeze(-1) == torch.arange(n_classes, device=ids.device)


def per_class_count(class_ids, n_classes: int) -> torch.Tensor:
    """Number of jobs a class, ``[..., M] -> [..., K]`` (int64)."""
    return _class_mask(class_ids, n_classes).sum(-2)


def per_class_mean(values: torch.Tensor, class_ids, n_classes: int) -> torch.Tensor:
    """Mean of ``values`` by class, ``[..., M] -> [..., K]``; a class with no
    jobs gives ``nan``.  A fixed-order masked sum: bit for bit from run to
    run on the card."""
    mask = _class_mask(torch.as_tensor(class_ids, device=values.device), n_classes)
    sums = torch.where(mask, values.unsqueeze(-1), 0.0).sum(-2)
    counts = mask.sum(-2).to(values.dtype)
    return torch.where(counts > 0, sums / counts.clamp(min=1), torch.nan)


def per_class_summary(flow_times, slowdowns, completion_times, class_ids,
                      n_classes: int) -> dict[str, torch.Tensor]:
    """Per-class mean flow time, mean slowdown, job count and mean
    completion order (each job's 0-based rank among the departures, from a
    stable argsort of the completion times, averaged by class), each
    ``[..., K]``."""
    times = torch.as_tensor(completion_times)
    order = torch.argsort(times, dim=-1, stable=True)
    pos = torch.arange(times.shape[-1], dtype=times.dtype, device=times.device)
    rank = torch.zeros_like(times).scatter_(-1, order, pos.expand_as(times))
    return {
        "mean_flowtime": per_class_mean(flow_times, class_ids, n_classes),
        "mean_slowdown": per_class_mean(slowdowns, class_ids, n_classes),
        "count": per_class_count(torch.as_tensor(class_ids, device=times.device), n_classes),
        "mean_completion_order": per_class_mean(rank, class_ids, n_classes),
    }


def summarize(result: SimResult, p) -> dict[str, torch.Tensor]:
    """Total and mean flow time, makespan and the first epoch's
    :func:`system_efficiency` of a batch run."""
    return {
        "total_flowtime": result.total_flowtime,
        "mean_flowtime": result.total_flowtime / result.completion_times.shape[-1],
        "makespan": result.makespan,
        "initial_efficiency": system_efficiency(result.theta_trace[..., 0, :], p),
    }
