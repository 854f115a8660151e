"""Workload tapes: where the engine's jobs and arrival epochs come from.

Port of ``repro.core.scenarios``.  A sampler is ``(gen, n_jobs, rates) ->
Scenario`` with an explicit ``torch.Generator``: it draws each job's size
and unit gap once and scales the gaps per rate, so one draw serves a whole
rate axis (the JAX sweep's pairing, one key per seed shared across rates).
``rates`` may be a float (tapes ``[M]``) or a sequence (tapes ``[R, M]``).
The draws differ from JAX's threefry streams and agree with them in
distribution only; parity tests hand the JAX sampler's tapes to the port
through :func:`tape_from_numpy`.

- ``batch``, ``poisson``, ``deterministic``;
- ``bursty`` — a 2-state Markov-modulated on-off stream whose long-run
  intensity is the nominal rate;
- ``drift_poisson`` / ``drift_bursty`` — the true exponent drifts ``p0 ->
  p1`` at ``drift_frac`` of the stream's nominal span ``n_jobs / rate``,
  carried as an ``engine.PDrift`` (drift times ``[R, 1]`` over a rate
  axis);
- ``multiclass_poisson`` / ``multiclass_bursty`` / ``drift_multiclass`` —
  K-class mixtures (``core/multiclass.py``, registered here on first use):
  each job carries ``class_ids`` and its class's true exponent ``p_job``.

Every sampler takes ``sigma_size`` / ``sigma_p`` estimation noise, scalars
or per-class sequences (one entry a class id, multi-class scenarios only):
lognormal ``size_factors`` (median 1) and a clipped ``p_hat`` that perturb
what the policy sees while the physics keep ``x0`` and ``p``.  ``p_hat`` is
one value a row, or per job (``[..., M]``, centred on each job's own
``p_job``) when the scenario has classes or ``sigma_p`` is a sequence.
They are drawn from the same generator after the base draw, one draw a
seed shared by the rate axis, and agree with JAX's in distribution only.

:func:`stream_tape` reduces a scenario to the plain tape the bounded-slot
loop (``engine.run_stream``) takes.
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
    the scalar ``p`` the simulation wrappers are called with.
    ``size_factors`` / ``p_hat`` (None without estimation noise) are what
    the policy sees in place of the sizes' scale and of ``p``.
    ``class_ids`` / ``p_job`` (None for one class) give each job its class
    and its class's true speedup exponent."""

    x0: torch.Tensor  # [..., M] true job sizes
    arrival_times: torch.Tensor  # [..., M] arrival epochs (zeros for batch)
    p_drift: PDrift | None = None  # times [..., D], values [D + 1] or [..., D + 1, M]
    size_factors: torch.Tensor | None = None  # [..., M] policy sees x * factors
    p_hat: object = None  # float, [..., 1] or per job [..., M]; policy sees p_hat
    class_ids: torch.Tensor | None = None  # [..., M] int64 job class ids
    p_job: torch.Tensor | None = None  # [..., M] float64 per-job true exponent


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


def _any_pos(sigma) -> bool:
    """True where a scalar or per-class sequence sigma carries any noise."""
    if isinstance(sigma, (tuple, list)):
        return any(sg > 0 for sg in sigma)
    return sigma > 0


def _with_noise(scn: Scenario, gen: torch.Generator, p, sigma_size, sigma_p) -> Scenario:
    """Estimation noise drawn from ``gen`` after the base draw: one ``[M]``
    draw of lognormal size factors, and one ``p_hat`` a seed (a scalar, or
    ``[M]`` per job where the scenario has classes or ``sigma_p`` is a
    per-class sequence), shared by the rate axis (the JAX package draws them
    from ``fold_in`` streams of the seed's key; equal in distribution only).
    A per-class sigma is read through ``scn.class_ids``; a per-job
    ``p_hat`` is centred on each job's own ``p_job``, clipped to
    [0.05, 0.95]."""
    size_factors, p_hat = scn.size_factors, scn.p_hat
    M = scn.x0.shape[-1]

    def per_job(sigma):
        if isinstance(sigma, (tuple, list)):
            if scn.class_ids is None:
                raise ValueError("per-class sigma needs a multi-class scenario")
            return torch.tensor(sigma, dtype=DTYPE, device=scn.x0.device)[scn.class_ids]
        return sigma

    if _any_pos(sigma_size):
        z = torch.randn(M, dtype=DTYPE, device=gen.device, generator=gen)
        size_factors = torch.exp(per_job(sigma_size) * z).expand_as(scn.x0).contiguous()
    if _any_pos(sigma_p):
        per_job_hat = scn.p_job is not None or isinstance(sigma_p, (tuple, list))
        z = torch.randn(M if per_job_hat else (), dtype=DTYPE, device=gen.device,
                        generator=gen)
        center = scn.p_job if scn.p_job is not None else p
        p_hat = (center + per_job(sigma_p) * z).clamp(0.05, 0.95)
        shape = scn.x0.shape if per_job_hat else (*scn.x0.shape[:-1], 1)
        p_hat = p_hat.expand(shape).contiguous()
    return scn._replace(size_factors=size_factors, p_hat=p_hat)


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
    sigma_size=0.0,
    sigma_p=0.0,
    p: float = 0.5,
    **cfg,
) -> ScenarioSampler:
    """A sampler ``(gen, n_jobs, rates) -> Scenario`` from the registry.

    The tapes land on the generator's device.  Extra ``cfg`` goes to the
    scenario (``burst``/``p_stay`` for the bursty ones, ``p0``/``p1``/
    ``drift_frac`` for the drift ones, ``classes`` and ``p1`` for the
    multi-class ones; what a single-class sampler does not take raises
    ``TypeError``).  ``sigma_size`` is the lognormal sd of the
    multiplicative size error, ``sigma_p`` the sd of the additive error on
    the exponent the policy assumes (centered on ``p``, or on each job's
    ``p_job`` in a multi-class scenario; clipped to [0.05, 0.95]); each a
    scalar or a per-class sequence.
    """
    noisy = _any_pos(sigma_size) or _any_pos(sigma_p)
    fn = SCENARIOS.get(name.lower())
    if fn is None:
        # The multi-class samplers register themselves on import.
        from repro_torch.core import multiclass  # noqa: F401

        fn = SCENARIOS.get(name.lower())
    if fn is None:
        raise ValueError(f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}")
    inspect.signature(fn).bind(None, 0, 1.0, size_alpha=size_alpha, **cfg)  # TypeError

    def sample(gen, n_jobs, rates):
        scn = fn(gen, n_jobs, rates, size_alpha=size_alpha, **cfg)
        if noisy:
            scn = _with_noise(scn, gen, p, sigma_size, sigma_p)
        return scn

    return sample


def stream_tape(scn: Scenario) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain ``(sizes, arrivals)`` tape of a :class:`Scenario` for the
    bounded-slot loop.  Its slots carry no per-job state beyond the size, so
    estimation noise, per-job class exponents and a drift schedule raise
    rather than being dropped (they stay on the finite-tape ``engine.run``
    path); the JAX package's wording."""
    for field, why in (
        ("size_factors", "estimation noise is per-job tape state"),
        ("p_hat", "estimation noise is per-job tape state"),
        ("p_job", "per-job class exponents do not ride in slots yet"),
        ("p_drift", "the drift clock belongs to the finite-tape engine"),
    ):
        if getattr(scn, field) is not None:
            raise ValueError(
                f"scenario with {field} cannot stream: {why} "
                "(use the finite-tape engine.run path)"
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
