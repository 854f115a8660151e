"""Online (arrival-stream) simulation — thin wrappers over ``core/engine.py``.

Port of the noise-free part of ``repro.core.arrivals`` (the generic, the
carried-rank, the superstep and the whole-chips paths): each wrapper takes
``[..., M]`` tapes (array-likes or tensors, moved to ``device``), runs the
engine over every cell at once and reduces completion times to per-job
flow times and slowdowns (:class:`OnlineSimResult`, per-cell scalars over
the leading dims).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import engine
from repro_torch.core.flowtime import speedup
from repro_torch.core.policies import Policy
from repro_torch.core.scenarios import Scenario
from repro_torch.core.superstep import run_superstep
from repro_torch.device import as_tensor, resolve_device


class OnlineSimResult(NamedTuple):
    completion_times: torch.Tensor  # [..., M] absolute departure time of each job
    flow_times: torch.Tensor  # [..., M] completion - arrival, per job
    slowdowns: torch.Tensor  # [..., M] flow / (x0 / s(N))
    total_flowtime: torch.Tensor  # [...]
    mean_flowtime: torch.Tensor  # [...]
    mean_slowdown: torch.Tensor  # [...]
    makespan: torch.Tensor  # [...], last departure time


def _finalize(x0, arrival_times, times, p, n_servers) -> OnlineSimResult:
    """Per-job flow times / slowdowns from completion times (input order)."""
    flows = times - arrival_times
    alone = x0 / speedup(torch.as_tensor(n_servers, dtype=x0.dtype, device=x0.device), p)
    slow = flows / alone
    return OnlineSimResult(
        completion_times=times,
        flow_times=flows,
        slowdowns=slow,
        total_flowtime=flows.sum(-1),
        mean_flowtime=flows.mean(-1),
        mean_slowdown=slow.mean(-1),
        makespan=times.amax(-1),
    )


def _tapes(x0, arrival_times, device):
    dev = resolve_device(device)
    x0 = as_tensor(x0, dev)
    return x0, as_tensor(arrival_times, dev).expand_as(x0)


def simulate_online(
    x0, arrival_times, p, n_servers, policy: Policy, *, rel_tol: float = 1e-9,
    horizon: int | None = None, fused: bool = False, device="cuda",
) -> OnlineSimResult:
    """Run ``policy`` online over arrival streams to completion (the
    continuous regime, re-evaluated at every arrival and departure)."""
    x0, arr = _tapes(x0, arrival_times, device)
    res = engine.run(
        x0, arr, p, engine.continuous_rule(policy, n_servers, dtype=x0.dtype),
        horizon=horizon, rel_tol=rel_tol, fused=fused,
    )
    return _finalize(x0, arr, res.completion_times, p, n_servers)


def simulate_online_ranked(
    x0, arrival_times, p, n_servers, rank_policy, *, horizon: int | None = None,
    device="cuda",
) -> OnlineSimResult:
    """Carried-rank fast path of :func:`simulate_online` for rank policies
    (see ``engine.run_ranked``)."""
    x0, arr = _tapes(x0, arrival_times, device)
    times = engine.run_ranked(x0, arr, p, n_servers, rank_policy, horizon=horizon)
    return _finalize(x0, arr, times, p, n_servers)


def simulate_online_superstep(
    x0, arrival_times, p, n_servers, policy: str = "hesrpt", *, weights=None,
    pre_arrived: bool = False, horizon: int | None = None, p_drift=None, device="cuda",
) -> OnlineSimResult:
    """Closed-form superstep path of :func:`simulate_online`: one step per
    arrival and none for ``pre_arrived`` batches (``core/superstep.py``).
    ``policy`` names one of ``superstep.SUPERSTEP_POLICIES``;
    ``weighted_hesrpt`` reads per-job ``weights`` (input order)."""
    x0, arr = _tapes(x0, arrival_times, device)
    res = run_superstep(
        x0, arr, p, n_servers, policy, weights=weights, pre_arrived=pre_arrived,
        horizon=horizon, p_drift=p_drift,
    )
    return _finalize(x0, arr, res.completion_times, p, n_servers)


def simulate_online_quantized(
    x0, arrival_times, p, n_chips: int, policy: Policy, *, min_chips: int = 1,
    rel_tol: float = 1e-9, horizon: int | None = None, record: bool = False,
    fused: bool = False, device="cuda",
):
    """Online simulation with whole-chip allocations.

    ``fused=True`` takes the ``kernels/alloc.py`` fused allocate (heSRPT
    only).  With ``record=True`` returns ``(OnlineSimResult, EngineResult)``.
    """
    x0, arr = _tapes(x0, arrival_times, device)
    res = engine.run(
        x0, arr, p,
        engine.quantized_rule(policy, n_chips, min_chips=min_chips, dtype=x0.dtype),
        horizon=horizon, rel_tol=rel_tol, record=record, fused=fused,
    )
    out = _finalize(x0, arr, res.completion_times, p, n_chips)
    return (out, res) if record else out


def simulate_scenario(
    scn: Scenario, p, n_servers, policy: Policy, *, n_chips: int | None = None,
    min_chips: int = 1, rel_tol: float = 1e-9, horizon: int | None = None,
    fused: bool = False, device="cuda",
) -> OnlineSimResult:
    """Run drawn scenarios through the engine: whole chips when ``n_chips``
    is set, else the continuous system with ``n_servers``."""
    if n_chips is not None:
        return simulate_online_quantized(
            scn.x0, scn.arrival_times, p, n_chips, policy, min_chips=min_chips,
            rel_tol=rel_tol, horizon=horizon, fused=fused, device=device,
        )
    return simulate_online(
        scn.x0, scn.arrival_times, p, n_servers, policy, rel_tol=rel_tol,
        horizon=horizon, fused=fused, device=device,
    )


__all__ = [
    "OnlineSimResult",
    "simulate_online",
    "simulate_online_quantized",
    "simulate_online_ranked",
    "simulate_online_superstep",
    "simulate_scenario",
]
