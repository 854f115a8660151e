"""Online (arrival-stream) simulation — thin wrappers over ``core/engine.py``.

Port of ``repro.core.arrivals`` (the generic, the carried-rank, the
superstep and the whole-chips paths, each under a drifting ``p`` where the
engine takes one; :func:`simulate_scenario` with estimation noise, a
telemetry probe and the class-blind run of a multi-class scenario): each wrapper takes ``[..., M]``
tapes (array-likes or tensors, moved to ``device``), runs the engine over
every cell at once and reduces completion times to per-job flow times and
slowdowns (:class:`OnlineSimResult`, per-cell scalars over the leading
dims).  :func:`simulate_stream` runs a scenario through the bounded-slot
loop instead (``engine.run_stream``).  :func:`load_sweep` /
:func:`load_sweep_raw` are thin specs over ``core/sweeps.py``.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.flowtime import speedup
from repro_torch.core.policies import Policy
from repro_torch.core.scenarios import Scenario, stream_tape
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
    horizon: int | None = None, fused: bool = False, p_drift=None, device="cuda",
) -> OnlineSimResult:
    """Run ``policy`` online over arrival streams to completion (the
    continuous regime, re-evaluated at every arrival and departure, and at
    every boundary of ``p_drift``)."""
    x0, arr = _tapes(x0, arrival_times, device)
    res = engine.run(
        x0, arr, p, engine.continuous_rule(policy, n_servers, dtype=x0.dtype),
        horizon=horizon, rel_tol=rel_tol, fused=fused, p_drift=p_drift,
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
    arrival (and drift boundary) and none for ``pre_arrived`` batches
    without drift (``core/superstep.py``).
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
    fused: bool = False, p_drift=None, device="cuda",
):
    """Online simulation with whole-chip allocations.

    ``fused=True`` takes the ``kernels/alloc.py`` fused allocate (heSRPT
    only).  With ``record=True`` returns ``(OnlineSimResult, EngineResult)``.
    """
    x0, arr = _tapes(x0, arrival_times, device)
    res = engine.run(
        x0, arr, p,
        engine.quantized_rule(policy, n_chips, min_chips=min_chips, dtype=x0.dtype),
        horizon=horizon, rel_tol=rel_tol, record=record, fused=fused, p_drift=p_drift,
    )
    out = _finalize(x0, arr, res.completion_times, p, n_chips)
    return (out, res) if record else out


def _noise_rows(scn: Scenario, x0, order):
    """The scenario's estimation noise in the loop's form: size factors and a
    per-job ``p_hat`` ``[C, M]`` in each row's arrival order ``order`` (the
    ``engine.loop_order`` of the tapes), any other ``p_hat`` a float or a
    ``[C, 1]`` column."""
    lead = x0.shape[:-1]

    def rows(v):
        return engine.to_loop_order(as_tensor(v, x0.device), order, lead)

    factors = None if scn.size_factors is None else rows(scn.size_factors)
    p_hat = scn.p_hat
    if engine.is_per_job(p_hat, x0.shape[-1]):
        p_hat = rows(p_hat)
    elif isinstance(p_hat, torch.Tensor):
        p_hat = (float(p_hat) if p_hat.ndim == 0
                 else as_tensor(p_hat, x0.device).expand(*lead, 1).reshape(-1, 1))
    return factors, p_hat


def simulate_scenario(
    scn: Scenario, p, n_servers, policy: Policy, *, n_chips: int | None = None,
    min_chips: int = 1, rel_tol: float = 1e-9, horizon: int | None = None,
    fused: bool = False, telemetry=None, device="cuda",
):
    """Run drawn scenarios through the engine: whole chips when ``n_chips``
    is set, else the continuous system with ``n_servers``.

    Estimation noise (``scn.size_factors`` / ``scn.p_hat``) reaches only
    the allocation rule; the physics use the true sizes and exponent.  A
    drift scenario's ``p_drift`` supersedes ``p`` in the physics and, unless
    ``scn.p_hat`` pins a belief (the stale arm), in what the policy sees
    (the oracle arm); ``p`` still normalizes the slowdowns.  ``telemetry``
    takes a probe (``core/telemetry.py``); the return is then
    ``(OnlineSimResult, TelemetryResult)``.

    A multi-class scenario (``scn.p_job`` set) runs the physics, and
    normalizes the slowdowns, on each job's own exponent while the policy
    sees the scalar ``p``, or the row mean of a per-job ``scn.p_hat``: the
    class-blind baseline (the class-aware policies are
    ``core/multiclass.py``'s).
    """
    x0, arr = _tapes(scn.x0, scn.arrival_times, device)
    p_phys, p_hat = p, scn.p_hat
    if scn.p_job is not None:
        p_phys = as_tensor(scn.p_job, x0.device).expand_as(x0)
        if p_hat is None:
            p_hat = p  # the class-blind policy still assumes the scalar p
    if engine.is_per_job(p_hat, x0.shape[-1]):
        # One belief a row, the mean of the per-job estimates: the
        # single-class brackets telescope to 1 only for one exponent.
        p_hat = as_tensor(p_hat, x0.device).expand_as(x0).mean(-1, keepdim=True)
    order = engine.loop_order(arr.expand_as(x0).reshape(-1, x0.shape[-1]))
    factors, p_hat = _noise_rows(scn._replace(p_hat=p_hat), x0, order)
    if n_chips is not None:
        rule = engine.quantized_rule(policy, n_chips, min_chips=min_chips, dtype=x0.dtype,
                                     size_factors=factors, p_hat=p_hat)
        n_alone = n_chips
    else:
        rule = engine.continuous_rule(policy, n_servers, dtype=x0.dtype,
                                      size_factors=factors, p_hat=p_hat)
        n_alone = n_servers
    res = engine.run(x0, arr, p_phys, rule, horizon=horizon, rel_tol=rel_tol, fused=fused,
                     p_drift=scn.p_drift, telemetry=telemetry)
    out = _finalize(x0, arr, res.completion_times, p_phys, n_alone)
    return (out, res.telemetry) if telemetry is not None else out


def simulate_stream(
    scn: Scenario, p, n_servers, policy: Policy, *, n_slots: int, window=None,
    n_chips: int | None = None, min_chips: int = 1, rel_tol: float = 1e-9,
    horizon: int | None = None, record_times: bool = False, fused: bool = False,
    telemetry=None, device="cuda",
) -> engine.StreamResult:
    """Run drawn scenarios through the bounded-slot loop: whole chips when
    ``n_chips`` is set, else the continuous system on ``n_servers``, over
    ``n_slots`` recycled slots a cell; the read-out is the stationary-window
    :class:`~repro_torch.core.engine.StreamResult`, which carries a probe's
    read-out on ``telemetry`` (the JAX package's form).  A drift or noisy
    scenario raises (:func:`~repro_torch.core.scenarios.stream_tape`)."""
    x0, arr = _tapes(*stream_tape(scn), device)
    if n_chips is not None:
        rule = engine.quantized_rule(policy, n_chips, min_chips=min_chips, dtype=x0.dtype)
        n_alone = n_chips
    else:
        rule = engine.continuous_rule(policy, n_servers, dtype=x0.dtype)
        n_alone = n_servers
    return engine.run_stream(
        x0, arr, p, rule, n_slots=n_slots, window=window, n_alone=n_alone, horizon=horizon,
        rel_tol=rel_tol, record_times=record_times, fused=fused, telemetry=telemetry,
    )


# --------------------------------------------------------------- load sweeps
def load_sweep(
    policies: Sequence[str], rates: Sequence[float], *, n_jobs: int = 1000,
    n_seeds: int = 100, p: float = 0.5, n_servers: float = 256.0, size_alpha: float = 1.5,
    seed: int = 0, metric: str = "mean_flowtime", scenario: str = "poisson",
    scenario_kw: dict | None = None, n_chips: int | None = None, min_chips: int = 1,
    chunk_seeds: int | None = None, max_jobs_in_flight: int | None = None,
    shard: bool = False, device="cuda",
) -> dict:
    """Sweep arrival rates x seeds x policies, one batch run a policy (per
    seed chunk).  Seeds are shared across rates and policies (paired
    comparison).  Returns ``{rate: {policy: mean-over-seeds of metric}}``.
    ``shard=True`` splits the seeds over the default process group's ranks
    (``sweeps.run_sweep``); every rank gets the whole result."""
    per_seed = load_sweep_raw(
        policies, rates, n_jobs=n_jobs, n_seeds=n_seeds, p=p, n_servers=n_servers,
        size_alpha=size_alpha, seed=seed, metric=metric, scenario=scenario,
        scenario_kw=scenario_kw, n_chips=n_chips, min_chips=min_chips,
        chunk_seeds=chunk_seeds, max_jobs_in_flight=max_jobs_in_flight, shard=shard,
        device=device,
    )
    return {
        float(rate): {name: float(np.mean(per_seed[name][ri])) for name in policies}
        for ri, rate in enumerate(rates)
    }


def load_sweep_raw(
    policies: Sequence[str], rates: Sequence[float], *, n_jobs: int = 1000,
    n_seeds: int = 100, p: float = 0.5, n_servers: float = 256.0, size_alpha: float = 1.5,
    seed: int = 0, metric: str = "mean_flowtime", scenario: str = "poisson",
    scenario_kw: dict | None = None, n_chips: int | None = None, min_chips: int = 1,
    chunk_seeds: int | None = None, max_jobs_in_flight: int | None = None,
    shard: bool = False, device="cuda",
) -> dict:
    """Like :func:`load_sweep` but the full ``[n_rates, n_seeds]`` array of
    per-seed metrics for each policy: a ``Sweep`` spec through
    ``sweeps.run_sweep``, where the seed-chunking and sharding knobs live."""
    from repro_torch.core.sweeps import Sweep, run_sweep

    spec = Sweep.create(
        policies, rates, scenario=scenario, scenario_kw=scenario_kw, n_jobs=n_jobs,
        n_seeds=n_seeds, seed=seed, p=p, n_servers=n_servers, size_alpha=size_alpha,
        n_chips=n_chips, min_chips=min_chips, metrics=(metric,),
    )
    res = run_sweep(spec, chunk_seeds=chunk_seeds, max_jobs_in_flight=max_jobs_in_flight,
                    shard=shard, device=device)
    return {name: res.stats[name][metric] for name in spec.policies}


__all__ = [
    "OnlineSimResult",
    "load_sweep",
    "load_sweep_raw",
    "simulate_online",
    "simulate_online_quantized",
    "simulate_online_ranked",
    "simulate_online_superstep",
    "simulate_scenario",
    "simulate_stream",
]
