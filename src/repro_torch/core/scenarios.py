"""Workload tapes: where the engine's jobs and arrival epochs come from.

Port of the single-class, noise-free part of ``repro.core.scenarios``.  A
sampler is ``(gen, n_jobs, rates) -> Scenario`` with an explicit
``torch.Generator``: it draws each job's size and unit gap once and scales
the gaps per rate, so one draw serves a whole rate axis (the JAX sweep's
pairing, one key per seed shared across rates).  ``rates`` may be a float
(tapes ``[M]``) or a sequence (tapes ``[R, M]``).  The draws differ from
JAX's threefry streams and agree with them in distribution only; parity
tests hand the JAX sampler's tapes to the port through
:func:`tape_from_numpy`.

- ``batch``, ``poisson``, ``deterministic``;
- ``bursty`` — a 2-state Markov-modulated on-off stream whose long-run
  intensity is the nominal rate;
- ``drift_poisson`` / ``drift_bursty`` — the true exponent drifts ``p0 ->
  p1`` at ``drift_frac`` of the stream's nominal span ``n_jobs / rate``,
  carried as an ``engine.PDrift`` (drift times ``[R, 1]`` over a rate
  axis).

:func:`stream_tape` reduces a scenario to the plain tape the bounded-slot
loop (``engine.run_stream``) takes.

Not ported yet (ROADMAP.md Queue A): the multi-class samplers, estimation
noise (``sigma_size``/``sigma_p``).
"""

from __future__ import annotations

import inspect
from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.engine import PDrift
from repro_torch.device import DTYPE, resolve_device


class Scenario(NamedTuple):
    """One drawn workload, in input (unsorted) job order.  ``p_drift``
    makes the true exponent piecewise-constant in time; it then supersedes
    the scalar ``p`` the simulation wrappers are called with."""

    x0: torch.Tensor  # [..., M] true job sizes
    arrival_times: torch.Tensor  # [..., M] arrival epochs (zeros for batch)
    p_drift: PDrift | None = None  # times [..., D], values [D + 1]


ScenarioSampler = Callable[[torch.Generator, int, object], Scenario]


def tape_from_numpy(x0, arrival_times, *, device="cuda") -> Scenario:
    """Numpy tapes (e.g. drawn by the JAX sampler) as float64 tensors on
    ``device``; leading ``[R, S]`` dims are kept."""
    dev = resolve_device(device)
    return Scenario(
        x0=torch.as_tensor(np.asarray(x0), dtype=DTYPE, device=dev),
        arrival_times=torch.as_tensor(np.asarray(arrival_times), dtype=DTYPE, device=dev),
    )


def _rates(rates, device) -> torch.Tensor:
    """``[R, 1]`` rate column, or a scalar for a single float rate."""
    r = torch.as_tensor(rates, dtype=DTYPE, device=device)
    return r.reshape(-1, 1) if r.ndim else r


# ------------------------------------------------------- arrival primitives
def unit_gaps(gen: torch.Generator, n_jobs: int) -> torch.Tensor:
    """Exp(1) interarrival gaps, ``[n_jobs]`` on the generator's device."""
    return torch.empty(n_jobs, dtype=DTYPE, device=gen.device).exponential_(generator=gen)


def poisson_arrivals(gen: torch.Generator, n_jobs: int, rate) -> torch.Tensor:
    """Arrival epochs of a Poisson(rate) stream: cumsum of Exp(rate) gaps."""
    return torch.cumsum(unit_gaps(gen, n_jobs) / _rates(rate, gen.device), -1)


def deterministic_arrivals(n_jobs: int, rate, *, device="cuda") -> torch.Tensor:
    """Evenly spaced arrivals at interval 1/rate (first arrival at 1/rate)."""
    dev = resolve_device(device)
    k = torch.arange(1, n_jobs + 1, dtype=DTYPE, device=dev)
    return k / _rates(rate, dev)


def bursty_arrivals(
    gen: torch.Generator, n_jobs: int, rate_on, rate_off, *, p_stay: float = 0.95
) -> torch.Tensor:
    """2-state MAP on-off stream: each gap is Exp(rate of the current state).

    The hidden state persists with probability ``p_stay`` an arrival and
    flips otherwise (bursts of geometric length ``1/(1-p_stay)``); the state
    path is the parity of a cumulative flip count.  ``rate_on``/``rate_off``
    may be ``[R, 1]`` columns: one state path and one draw of unit gaps
    serve the whole rate axis.
    """
    dev = gen.device
    flips = torch.rand(n_jobs, dtype=DTYPE, device=dev, generator=gen) > p_stay
    s0 = torch.rand(1, dtype=DTYPE, device=dev, generator=gen) < 0.5
    state = (s0.to(torch.int64) + torch.cumsum(flips.to(torch.int64), 0)) % 2
    rate = torch.where(state == 1, rate_on, rate_off)
    return torch.cumsum(unit_gaps(gen, n_jobs) / rate, -1)


def pareto_sizes(gen: torch.Generator, n_jobs: int, alpha: float = 1.5) -> torch.Tensor:
    """Pareto(alpha) job sizes with minimum 1 (``exp(Exp(1) / alpha)``)."""
    return torch.exp(unit_gaps(gen, n_jobs) / alpha)


def _over_rates(x0: torch.Tensor, arr: torch.Tensor) -> Scenario:
    """Broadcast the per-seed sizes over the rate axis of ``arr``."""
    return Scenario(x0=x0.expand_as(arr).contiguous(), arrival_times=arr)


# -------------------------------------------------------------- the registry
def _batch(gen, n_jobs, rates, *, size_alpha):
    x0 = pareto_sizes(gen, n_jobs, size_alpha)
    shape = torch.broadcast_shapes(_rates(rates, gen.device).shape, x0.shape)
    return _over_rates(x0, torch.zeros(shape, dtype=DTYPE, device=gen.device))


def _poisson(gen, n_jobs, rates, *, size_alpha):
    arr = poisson_arrivals(gen, n_jobs, rates)
    x0 = pareto_sizes(gen, n_jobs, size_alpha)
    return _over_rates(x0, arr)


def _deterministic(gen, n_jobs, rates, *, size_alpha):
    arr = deterministic_arrivals(n_jobs, rates, device=gen.device)
    x0 = pareto_sizes(gen, n_jobs, size_alpha)
    return _over_rates(x0, arr)


def _bursty(gen, n_jobs, rates, *, size_alpha, burst=4.0, p_stay=0.95):
    # rate_on/off bracket the nominal rate by ``burst``; the two states are
    # visited 50/50 in steady state, so both are scaled by
    # 0.5 (burst + 1/burst) to make the long-run intensity the nominal rate.
    r = _rates(rates, gen.device)
    norm = 0.5 * (burst + 1.0 / burst)
    arr = bursty_arrivals(gen, n_jobs, r * burst * norm, r / burst * norm, p_stay=p_stay)
    x0 = pareto_sizes(gen, n_jobs, size_alpha)
    return _over_rates(x0, arr)


def _with_drift(scn: Scenario, n_jobs, rates, *, p0, p1, drift_frac) -> Scenario:
    """One regime change ``p0 -> p1`` at ``drift_frac`` of the stream's
    nominal span ``n_jobs / rate`` (mid-stream at every load of a sweep):
    drift times ``[R, 1]`` (``[1]`` for one rate), regimes ``[2]``."""
    dev = scn.x0.device
    t_d = drift_frac * n_jobs / _rates(rates, dev)
    drift = PDrift(
        times=t_d.reshape(-1, 1) if t_d.ndim else t_d.reshape(1),
        values=torch.tensor([p0, p1], dtype=DTYPE, device=dev),
    )
    return scn._replace(p_drift=drift)


def _drift_poisson(gen, n_jobs, rates, *, size_alpha, p0=0.8, p1=0.3, drift_frac=0.5):
    scn = _poisson(gen, n_jobs, rates, size_alpha=size_alpha)
    return _with_drift(scn, n_jobs, rates, p0=p0, p1=p1, drift_frac=drift_frac)


def _drift_bursty(
    gen, n_jobs, rates, *, size_alpha, p0=0.8, p1=0.3, drift_frac=0.5, burst=4.0,
    p_stay=0.95,
):
    scn = _bursty(gen, n_jobs, rates, size_alpha=size_alpha, burst=burst, p_stay=p_stay)
    return _with_drift(scn, n_jobs, rates, p0=p0, p1=p1, drift_frac=drift_frac)


SCENARIOS: dict[str, Callable[..., Scenario]] = {
    "batch": _batch,
    "poisson": _poisson,
    "deterministic": _deterministic,
    "bursty": _bursty,
    "drift_poisson": _drift_poisson,
    "drift_bursty": _drift_bursty,
}


def make_scenario(
    name: str,
    *,
    size_alpha: float = 1.5,
    sigma_size: float = 0.0,
    sigma_p: float = 0.0,
    p: float = 0.5,
    **cfg,
) -> ScenarioSampler:
    """A sampler ``(gen, n_jobs, rates) -> Scenario`` from the registry.

    The tapes land on the generator's device.  Extra ``cfg`` goes to the
    scenario (``burst``/``p_stay`` for the bursty ones, ``p0``/``p1``/
    ``drift_frac`` for the drift ones; others raise ``TypeError``).
    Estimation noise and the multi-class scenarios raise.
    """
    del p  # only the estimation-noise center reads it
    if sigma_size or sigma_p:
        raise NotImplementedError(
            "estimation noise (sigma_size/sigma_p) is not ported yet "
            "(ROADMAP.md Queue A, item 6)"
        )
    fn = SCENARIOS.get(name.lower())
    if fn is None:
        raise NotImplementedError(
            f"scenario {name!r} is not ported yet (ROADMAP.md Queue A, item 6); "
            f"ported: {sorted(SCENARIOS)}"
        )
    inspect.signature(fn).bind(None, 0, 1.0, size_alpha=size_alpha, **cfg)  # TypeError

    def sample(gen, n_jobs, rates):
        return fn(gen, n_jobs, rates, size_alpha=size_alpha, **cfg)

    return sample


def stream_tape(scn: Scenario) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain ``(sizes, arrivals)`` tape of a :class:`Scenario` for the
    bounded-slot loop.  Its slots carry no per-job state beyond the size, so
    a drift schedule raises rather than being dropped (it stays on the
    finite-tape ``engine.run`` path); the JAX package's wording."""
    if scn.p_drift is not None:
        raise ValueError(
            "scenario with p_drift cannot stream: the drift clock belongs to the "
            "finite-tape engine (use the finite-tape engine.run path)"
        )
    return scn.x0, scn.arrival_times


def seed_generator(seed: int, index: int, *, device="cuda") -> torch.Generator:
    """The ``index``-th independent generator of a sweep seeded by ``seed``
    (numpy's ``SeedSequence`` spawn tree), on ``device``."""
    dev = resolve_device(device)
    child = np.random.SeedSequence(seed).spawn(index + 1)[index]
    return torch.Generator(device=dev).manual_seed(int(child.generate_state(1)[0]))


def trace_scenario(arrival_times, sizes, *, device="cuda") -> ScenarioSampler:
    """Replay externally supplied arrivals/sizes (generator and rate ignored)."""
    scn = tape_from_numpy(sizes, arrival_times, device=device)

    def sample(gen, n_jobs, rates):
        del gen, rates
        if n_jobs != scn.x0.shape[-1]:
            raise ValueError(f"trace has {scn.x0.shape[-1]} jobs, asked for {n_jobs}")
        return scn

    return sample


__all__ = [
    "SCENARIOS",
    "Scenario",
    "ScenarioSampler",
    "bursty_arrivals",
    "deterministic_arrivals",
    "make_scenario",
    "pareto_sizes",
    "poisson_arrivals",
    "seed_generator",
    "stream_tape",
    "tape_from_numpy",
    "trace_scenario",
]
