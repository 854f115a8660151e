"""Diagnostics of allocations and per-cell sweep summaries.

Port of ``repro.core.analysis``'s ``system_efficiency`` and
``seed_axis_stats``.
"""

from __future__ import annotations

import numpy as np
import torch


def system_efficiency(theta: torch.Tensor, p) -> torch.Tensor:
    """Total service rate relative to the embarrassingly parallel capacity:
    ``sum_i s(theta_i N) / s(N) = sum_i theta_i^p`` over the last dim."""
    return torch.where(theta > 0, theta.pow(p), 0.0).sum(-1)


def seed_axis_stats(values) -> dict[str, list]:
    """Per-cell ``{"mean": [...], "std": [...]}`` of a ``[n_rates, n_seeds]``
    sweep stat, seed axis reduced.  NumPy on purpose: host-side artifacts."""
    a = np.asarray(values)
    return {"mean": np.mean(a, axis=1).tolist(), "std": np.std(a, axis=1).tolist()}
