"""Sweeps: policies x rates x seeds through the batched event loop.

Port of the single-class part of ``repro.core.sweeps``.  :class:`Sweep` is
the same declarative spec (pure data; :meth:`Sweep.from_spec_dict` reads the
``spec`` of a JAX ``SweepResult.record()``), and :func:`run_sweep` draws one
tape per seed — sizes and unit gaps once, the gaps scaled per rate, the
JAX sweep's pairing — then runs every ``(rate, seed)`` cell of a policy as
one ``[R * S, M]`` batch through the engine (:func:`simulate_cells`).

Dispatch follows the JAX cell function: ``superstep=True`` takes the
closed-form superstep path (``arrivals.simulate_online_superstep``); else a
continuous sweep over a rank policy takes the carried-rank loop
``engine.run_ranked``; the rest take ``engine.run`` with
``continuous_rule`` or ``quantized_rule``, and ``fused=True`` swaps in the
``kernels/alloc.py`` allocate (one CUDA launch per event on the card).
HELL, KNEE and water-filling close over ``n_chips`` (or ``n_servers``).

Not ported yet (ROADMAP.md Queue A): multi-class ``classes``, estimation
``arm``, ``telemetry``, ``stream``, ``snap_slices``, seed chunking and
sharding, the ``BENCH_sweeps.json`` run log.
"""

from __future__ import annotations

import os
import subprocess
import time
from datetime import datetime, timezone
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.analysis import seed_axis_stats
from repro_torch.core.arrivals import OnlineSimResult, _finalize, simulate_online_superstep
from repro_torch.core.policies import make_policy, make_rank_policy
from repro_torch.core.scenarios import make_scenario, seed_generator
from repro_torch.core.superstep import SUPERSTEP_RULE_POLICIES
from repro_torch.device import as_tensor, resolve_device

#: Layout version of :meth:`SweepResult.record` (the JAX package's v2 plus
#: torch/CUDA provenance).
SCHEMA_VERSION = 2

#: Per-cell scalar metrics a sweep can report.
SCALAR_METRICS = ("total_flowtime", "mean_flowtime", "mean_slowdown", "makespan")

#: Regimes of the JAX ``Sweep`` not ported yet, with their "off" values.
UNPORTED = {
    "classes": None, "arm": None, "arm_kw": (), "telemetry": (), "stream": (),
    "snap_slices": False,
}


def _git_sha() -> str | None:
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None  # not a checkout
    return out.stdout.strip() or None


def provenance(device: torch.device) -> dict:
    """Which code, stack and card produced a record, and when."""
    on_cuda = device.type == "cuda"
    return {
        "schema_version": SCHEMA_VERSION,
        "git_sha": _git_sha(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "device_name": torch.cuda.get_device_name(device) if on_cuda else "cpu",
        "created_utc": datetime.now(timezone.utc).isoformat(timespec="seconds"),
    }


class Sweep(NamedTuple):
    """Declarative single-class sweep spec: pure hashable data.

    Build it with :meth:`create` (normalizes and validates) or
    :meth:`from_spec_dict` (a JAX record's ``spec``).
    """

    policies: tuple[str, ...]
    rates: tuple[float, ...]
    scenario: str = "poisson"
    scenario_kw: tuple = ()
    n_jobs: int = 1000
    n_seeds: int = 100
    seed: int = 0
    p: float = 0.5
    n_servers: float = 256.0
    size_alpha: float = 1.5
    n_chips: int | None = None
    min_chips: int = 1
    metrics: tuple[str, ...] = ("mean_flowtime",)
    fused: bool = False  # kernels/alloc.py fused allocate (quantized heSRPT)
    superstep: bool = False  # core/superstep.py closed-form path (continuous)

    @classmethod
    def create(
        cls, policies, rates, *, scenario: str = "poisson", scenario_kw=None,
        n_jobs: int = 1000, n_seeds: int = 100, seed: int = 0, p: float = 0.5,
        n_servers: float = 256.0, size_alpha: float = 1.5, n_chips: int | None = None,
        min_chips: int = 1, metrics=None, fused: bool = False, superstep: bool = False,
        **regimes,
    ) -> Sweep:
        for key, value in regimes.items():
            if key not in UNPORTED:
                raise TypeError(f"Sweep.create() got an unexpected keyword {key!r}")
            if value:
                raise NotImplementedError(
                    f"Sweep regime {key}={value!r} is not ported yet (ROADMAP.md Queue A)"
                )
        scenario_kw = dict(scenario_kw or {})
        make_scenario(scenario, size_alpha=size_alpha, p=p, **scenario_kw)  # validates
        metrics = tuple(metrics or ("mean_flowtime",))
        for m in metrics:
            if m not in SCALAR_METRICS:
                raise ValueError(f"unknown metric {m!r}; known: {SCALAR_METRICS}")
        for name in policies:
            make_policy(name)  # raises for unknown / unported policies
        if fused:
            if n_chips is None:
                raise ValueError(
                    "fused=True needs n_chips (the quantized regime; continuous "
                    "heSRPT already runs the ranked fast path)"
                )
            bad = tuple(q for q in policies if q != "hesrpt")
            if bad:
                raise ValueError(f"fused sweeps support only heSRPT, got {bad}")
        if superstep:
            # Exact only for the continuous, noise-free, scalar-p rank family
            # (estimation noise raised above; fused already needs n_chips).
            if n_chips is not None:
                raise ValueError(
                    "superstep=True is the continuous closed-form path "
                    "(quantized chips need the per-event loop)"
                )
            bad = tuple(q for q in policies if q not in SUPERSTEP_RULE_POLICIES)
            if bad:
                raise ValueError(f"superstep sweeps support heSRPT/EQUI/SRPT, got {bad}")
        return cls(
            policies=tuple(policies),
            rates=tuple(float(r) for r in rates),
            scenario=scenario,
            scenario_kw=tuple(sorted(scenario_kw.items())),
            n_jobs=int(n_jobs),
            n_seeds=int(n_seeds),
            seed=int(seed),
            p=float(p),
            n_servers=float(n_servers),
            size_alpha=float(size_alpha),
            n_chips=None if n_chips is None else int(n_chips),
            min_chips=int(min_chips),
            metrics=metrics,
            fused=bool(fused),
            superstep=bool(superstep),
        )

    @classmethod
    def from_spec_dict(cls, d: dict) -> Sweep:
        """The spec of a JAX ``SweepResult.record()`` (its ``"spec"`` dict);
        unported regimes that are switched on raise."""
        return cls.create(
            d["policies"], d["rates"], scenario=d["scenario"],
            scenario_kw={k: v for k, v in d.get("scenario_kw", [])},
            n_jobs=d["n_jobs"], n_seeds=d["n_seeds"], seed=d["seed"], p=d["p"],
            n_servers=d["n_servers"], size_alpha=d["size_alpha"],
            n_chips=d["n_chips"], min_chips=d["min_chips"], metrics=d["metrics"],
            fused=d.get("fused", False), superstep=d.get("superstep", False),
            **{k: d[k] for k in UNPORTED if k in d},
        )

    def jobs_per_seed(self) -> int:
        return len(self.rates) * self.n_jobs

    def total_jobs(self) -> int:
        """Simulated jobs in the whole grid, per policy."""
        return self.n_seeds * self.jobs_per_seed()


class SweepResult(NamedTuple):
    """A completed sweep: the spec, per-seed stats and where it ran.

    ``stats[policy][metric]`` is a numpy array ``[n_rates, n_seeds]``.
    """

    spec: Sweep
    stats: dict[str, dict[str, np.ndarray]]
    wall_s: float
    backend: str  # "cuda" or "cpu"
    device_count: int
    device: torch.device

    def cell_means(self, metric: str | None = None) -> dict:
        """``{rate: {policy: mean-over-seeds}}``."""
        metric = metric or self.spec.metrics[0]
        return {
            float(rate): {
                name: float(np.mean(self.stats[name][metric][ri]))
                for name in self.spec.policies
            }
            for ri, rate in enumerate(self.spec.rates)
        }

    def record(self) -> dict:
        """Compact JSON-able record (per-cell mean/std), the JAX layout with
        torch, CUDA and card provenance."""
        spec = self.spec._asdict()
        spec["scenario_kw"] = [list(kv) for kv in self.spec.scenario_kw]
        for key in ("policies", "rates", "metrics"):
            spec[key] = list(spec[key])
        return {
            "kind": "sweep",
            "provenance": provenance(self.device),
            "spec": spec,
            "cells": {
                name: {m: seed_axis_stats(a) for m, a in by_m.items()}
                for name, by_m in self.stats.items()
            },
            "n_seeds": self.spec.n_seeds,
            "total_jobs": self.spec.total_jobs() * len(self.spec.policies),
            "wall_s": self.wall_s,
            "backend": self.backend,
            "device_count": self.device_count,
        }


# --------------------------------------------------------------- executors
def _policy_cells(spec: Sweep, name: str, x0, arr) -> OnlineSimResult:
    """Every cell of one policy column, as one batch."""
    if spec.superstep:
        return simulate_online_superstep(
            x0, arr, spec.p, spec.n_servers, name, device=x0.device
        )
    rank_pol = make_rank_policy(name) if spec.n_chips is None else None
    if rank_pol is not None:
        times = engine.run_ranked(x0, arr, spec.p, spec.n_servers, rank_pol)
        return _finalize(x0, arr, times, spec.p, spec.n_servers)
    pol = make_policy(
        name, n_servers=spec.n_chips if spec.n_chips is not None else spec.n_servers
    )
    if spec.n_chips is None:
        rule = engine.continuous_rule(pol, spec.n_servers, dtype=x0.dtype)
        n_alone = spec.n_servers
    else:
        rule = engine.quantized_rule(
            pol, spec.n_chips, min_chips=spec.min_chips, dtype=x0.dtype
        )
        n_alone = spec.n_chips
    res = engine.run(x0, arr, spec.p, rule, fused=spec.fused)
    return _finalize(x0, arr, res.completion_times, spec.p, n_alone)


def draw_tapes(spec: Sweep, *, device="cuda"):
    """The sweep's tapes ``(x0, arrival_times)``, each ``[R, S, M]``: one
    generator per seed, its draw shared across the rate axis."""
    sampler = make_scenario(
        spec.scenario, size_alpha=spec.size_alpha, p=spec.p, **dict(spec.scenario_kw)
    )
    scns = [
        sampler(seed_generator(spec.seed, s, device=device), spec.n_jobs, spec.rates)
        for s in range(spec.n_seeds)
    ]
    x0 = torch.stack([s.x0 for s in scns], 1)
    arr = torch.stack([s.arrival_times for s in scns], 1)
    return x0, arr


def simulate_cells(spec: Sweep, x0, arr, *, device="cuda") -> dict:
    """Run every policy of ``spec`` on given tapes ``x0``/``arr`` ``[R, S, M]``.

    Returns ``{policy: {metric: ndarray [R, S]}}`` — the executor
    :func:`run_sweep` uses, open to tapes drawn elsewhere (e.g. by the JAX
    sampler, for parity).
    """
    dev = resolve_device(device)
    x0 = as_tensor(x0, dev)
    arr = as_tensor(arr, dev)
    stats = {}
    for name in spec.policies:
        res = _policy_cells(spec, name, x0, arr)
        stats[name] = {m: getattr(res, m).cpu().numpy() for m in spec.metrics}
    return stats


def run_sweep(spec: Sweep, *, device="cuda") -> SweepResult:
    """Execute a :class:`Sweep` on ``device``; the wall time covers the
    tapes' draw and every policy's batched run, synchronized."""
    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    if on_cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    x0, arr = draw_tapes(spec, device=dev)
    stats = simulate_cells(spec, x0, arr, device=dev)  # .cpu() synchronizes
    wall_s = time.perf_counter() - t0
    return SweepResult(
        spec=spec,
        stats=stats,
        wall_s=wall_s,
        backend=dev.type,
        device_count=torch.cuda.device_count() if on_cuda else 1,
        device=dev,
    )


__all__ = [
    "SCALAR_METRICS",
    "Sweep",
    "SweepResult",
    "draw_tapes",
    "provenance",
    "run_sweep",
    "simulate_cells",
]
