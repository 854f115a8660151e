"""Batch fluid simulator — a thin wrapper over ``core/engine.py``.

Port of ``repro.core.simulator``: every job present at t=0, ``M`` event
steps, the trajectory repackaged as :class:`SimResult`, or only its total
flow time (:func:`total_flowtime`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import engine
from repro_torch.core.policies import Policy
from repro_torch.device import as_tensor, resolve_device


class SimResult(NamedTuple):
    completion_times: torch.Tensor  # [..., M] absolute departure time of each job
    total_flowtime: torch.Tensor  # [...], sum of completion times
    makespan: torch.Tensor  # [...], max completion time
    theta_trace: torch.Tensor  # [..., E, M] allocation chosen at each epoch
    epoch_times: torch.Tensor  # [..., E] start time of each epoch
    sizes_trace: torch.Tensor  # [..., E, M] remaining sizes at each epoch start


def _run_batch(x0, p, n_servers, policy, *, rel_tol, record, fused, device):
    x0 = as_tensor(x0, resolve_device(device))
    return engine.run(
        x0, torch.zeros_like(x0), p,
        engine.continuous_rule(policy, n_servers, dtype=x0.dtype),
        pre_arrived=True, horizon=x0.shape[-1], rel_tol=rel_tol, record=record, fused=fused,
    )


def simulate(
    x0, p, n_servers, policy: Policy, *, rel_tol: float = 1e-9, device="cuda"
) -> SimResult:
    """Run ``policy`` to completion on job sizes ``x0[..., M]`` (any order)."""
    res = _run_batch(
        x0, p, n_servers, policy, rel_tol=rel_tol, record=True, fused=False, device=device
    )
    times = res.completion_times
    return SimResult(
        completion_times=times,
        total_flowtime=times.sum(-1),
        makespan=times.amax(-1),
        theta_trace=res.trace.alloc,
        epoch_times=res.trace.times,
        sizes_trace=res.trace.sizes,
    )


def total_flowtime(
    x0, p, n_servers, policy: Policy, *, fused: bool = False, device="cuda"
) -> torch.Tensor:
    """Total flow time ``[...]`` of every batch row of ``x0[..., M]``: the
    trajectory of :func:`simulate` without its per-event record.
    ``fused=True`` takes the heSRPT rule's fused allocate (the alloc kernel
    on the card)."""
    res = _run_batch(
        x0, p, n_servers, policy, rel_tol=1e-9, record=False, fused=fused, device=device
    )
    return res.completion_times.sum(-1)
