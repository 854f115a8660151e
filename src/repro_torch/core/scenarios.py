"""Workload tapes: where the engine's jobs and arrival epochs come from.

Port of the noise-free part of ``repro.core.scenarios``.  A sampler is
``(gen, n_jobs, rates) -> Scenario`` with an explicit ``torch.Generator``:
it draws each job's size and unit gap once and scales the gaps per rate, so
one draw serves a whole rate axis (the JAX sweep's pairing, one key per
seed shared across rates).  ``rates`` may be a float (tapes ``[M]``) or a
sequence (tapes ``[R, M]``).  The draws differ from JAX's threefry streams
and agree with them in distribution only; parity tests hand the JAX
sampler's tapes to the port through :func:`tape_from_numpy`.

Not ported yet (ROADMAP.md): ``bursty``, the drift and multi-class
samplers, estimation noise (``sigma_size``/``sigma_p``), ``stream_tape``.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import DTYPE, resolve_device


class Scenario(NamedTuple):
    """One drawn workload, in input (unsorted) job order."""

    x0: torch.Tensor  # [..., M] true job sizes
    arrival_times: torch.Tensor  # [..., M] arrival epochs (zeros for batch)


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


SCENARIOS: dict[str, Callable[..., Scenario]] = {
    "batch": _batch,
    "poisson": _poisson,
    "deterministic": _deterministic,
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

    The tapes land on the generator's device.  Estimation noise and the
    extra ``cfg`` of unported scenarios raise.
    """
    del p  # only the estimation-noise center reads it
    if sigma_size or sigma_p or cfg:
        raise NotImplementedError(
            "estimation noise (sigma_size/sigma_p) and scenario options "
            f"{sorted(cfg)} are not ported yet (ROADMAP.md Queue A, item 6)"
        )
    fn = SCENARIOS.get(name.lower())
    if fn is None:
        raise NotImplementedError(
            f"scenario {name!r} is not ported yet (ROADMAP.md Queue A, item 6); "
            f"ported: {sorted(SCENARIOS)}"
        )

    def sample(gen, n_jobs, rates):
        return fn(gen, n_jobs, rates, size_alpha=size_alpha)

    return sample


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
    "deterministic_arrivals",
    "make_scenario",
    "pareto_sizes",
    "poisson_arrivals",
    "seed_generator",
    "tape_from_numpy",
    "trace_scenario",
]
