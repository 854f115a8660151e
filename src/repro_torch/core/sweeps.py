"""Sweeps: policies x rates x seeds through the batched event loop.

Port of the single-class part of ``repro.core.sweeps``.  :class:`Sweep` is
the same declarative spec (pure data; :meth:`Sweep.from_spec_dict` reads the
``spec`` of a JAX ``SweepResult.record()``), and :func:`run_sweep` draws one
tape per seed — sizes and unit gaps once, the gaps scaled per rate, the
JAX sweep's pairing — then runs every ``(rate, seed)`` cell of a policy as
one ``[R * S, M]`` batch through the engine (:func:`simulate_cells`).

Dispatch follows the JAX cell function: ``superstep=True`` takes the
closed-form superstep path (``arrivals.simulate_online_superstep``, drift
included); else a continuous sweep over a rank policy without drift takes
the carried-rank loop ``engine.run_ranked``; the rest take ``engine.run``
with ``continuous_rule`` or ``quantized_rule`` (and the scenario's
``p_drift``), and ``fused=True`` swaps in the ``kernels/alloc.py``
allocate (one CUDA launch per event on the card).  HELL, KNEE and
water-filling close over ``n_chips`` (or ``n_servers``).

``Sweep.create(stream={"n_slots": S, ...})`` runs every cell through the
bounded-slot loop instead, over ``S`` recycled slots, and reports
stationary-window read-outs (:data:`STREAM_METRICS`): the window is
``(warmup_frac, end_frac) x n_jobs / rate`` of each rate; continuous rank
policies take ``engine.run_stream_ranked``, the rest (and ``fused=True``)
``arrivals.simulate_stream``.

``run_sweep(chunk_seeds=)`` (or ``max_jobs_in_flight=``) runs the seeds in
sequential chunks on the same per-seed generators, with the same results
bit for bit.  Every run appends its compact record to :data:`RUN_LOG`,
which :func:`write_bench_json` flushes (never to the JAX package's
``BENCH_sweeps.json``).

Not ported yet (ROADMAP.md Queue A): multi-class ``classes`` (and with them
``snap_slices``, which the JAX package wires only for classes), estimation
``arm``, ``telemetry``, and sharding.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from datetime import datetime, timezone
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.analysis import seed_axis_stats
from repro_torch.core.arrivals import (
    OnlineSimResult,
    _finalize,
    simulate_online_superstep,
    simulate_stream,
)
from repro_torch.core.policies import make_policy, make_rank_policy
from repro_torch.core.engine import PDrift
from repro_torch.core.scenarios import Scenario, make_scenario, seed_generator
from repro_torch.core.superstep import SUPERSTEP_RULE_POLICIES
from repro_torch.device import as_tensor, resolve_device

#: Layout version of :meth:`SweepResult.record` (the JAX package's v2 plus
#: torch/CUDA provenance).
SCHEMA_VERSION = 2

#: Per-cell scalar metrics a sweep can report.
SCALAR_METRICS = ("total_flowtime", "mean_flowtime", "mean_slowdown", "makespan")

#: Streaming metrics (``Sweep.create(stream=...)``): per-cell read-outs of
#: ``engine.StreamResult``, stationary-window aggregates of the bounded-slot
#: loop (the JAX package's names).
STREAM_METRICS = {
    "stream_flow": "mean_flow",
    "stream_slowdown": "mean_slowdown",
    "stream_completed": "n_window",
    "stream_arrived": "n_arrived_window",
    "stream_blocked": "blocked_steps",
    "stream_occupancy": "occupancy_max",
}

#: ``Sweep.create(stream=...)`` keys: the slot pool, and the window as
#: fractions of each rate's nominal span ``n_jobs / rate``.
STREAM_KEYS = ("n_slots", "warmup_frac", "end_frac")

#: Regimes of the JAX ``Sweep`` not ported yet, with their "off" values.
UNPORTED = {
    "classes": None, "arm": None, "arm_kw": (), "telemetry": (), "snap_slices": False,
}

#: Default file of :func:`write_bench_json`: the port's own run log, beside
#: (never in) the JAX package's ``BENCH_sweeps.json``.
BENCH_JSON = "BENCH_sweeps_torch.json"


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
    stream: tuple = ()  # bounded-slot regime: (("n_slots", S), ...) kv pairs

    @classmethod
    def create(
        cls, policies, rates, *, scenario: str = "poisson", scenario_kw=None,
        n_jobs: int = 1000, n_seeds: int = 100, seed: int = 0, p: float = 0.5,
        n_servers: float = 256.0, size_alpha: float = 1.5, n_chips: int | None = None,
        min_chips: int = 1, metrics=None, fused: bool = False, superstep: bool = False,
        stream=None, **regimes,
    ) -> Sweep:
        stream = tuple(sorted(dict(stream or {}).items()))
        if stream:
            _check_stream(dict(stream), scenario)
        for key, value in regimes.items():
            if key not in UNPORTED:
                raise TypeError(f"Sweep.create() got an unexpected keyword {key!r}")
            if key == "snap_slices" and value:
                # The JAX package's own refusal: it wires snap_slices only
                # with classes, which are not ported.
                raise ValueError("snap_slices is only wired for multi-class sweeps")
            if value:
                raise NotImplementedError(
                    f"Sweep regime {key}={value!r} is not ported yet (ROADMAP.md Queue A)"
                )
        scenario_kw = dict(scenario_kw or {})
        make_scenario(scenario, size_alpha=size_alpha, p=p, **scenario_kw)  # validates
        metrics = tuple(metrics or (
            ("stream_flow", "stream_slowdown") if stream else ("mean_flowtime",)))
        for m in metrics:
            if stream:
                if m not in STREAM_METRICS:
                    raise ValueError(
                        f"metric {m!r} is not a streaming metric; streaming sweeps read "
                        f"{tuple(STREAM_METRICS)}"
                    )
            elif m in STREAM_METRICS:
                raise ValueError(f"metric {m!r} needs a streaming sweep (stream=)")
            elif m not in SCALAR_METRICS:
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
            if stream:
                raise ValueError(
                    "superstep sweeps take no fused/telemetry/stream options (all "
                    "three ride the per-event loop)"
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
            stream=stream,
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
            stream={k: v for k, v in d.get("stream", [])},
            **{k: d[k] for k in UNPORTED if k in d},
        )

    def jobs_per_seed(self) -> int:
        return len(self.rates) * self.n_jobs

    def total_jobs(self) -> int:
        """Simulated jobs in the whole grid, per policy."""
        return self.n_seeds * self.jobs_per_seed()


def _check_stream(skw: dict, scenario: str) -> None:
    """``Sweep.create(stream=...)``'s validation (the JAX package's)."""
    unknown = tuple(k for k in skw if k not in STREAM_KEYS)
    if unknown:
        raise ValueError(f"unknown stream key(s) {unknown}; known: {STREAM_KEYS}")
    if "n_slots" not in skw or int(skw["n_slots"]) < 1:
        raise ValueError("stream needs n_slots >= 1 (the slot pool)")
    warm, end = _stream_window(skw)
    if not 0.0 <= warm < end:
        raise ValueError(
            f"stream window needs 0 <= warmup_frac < end_frac (got {warm} / {end})"
        )
    if scenario.startswith(("drift_", "multiclass_")):
        raise ValueError(
            "streaming sweeps need a plain tape scenario (no drift, classes or "
            "estimation noise — see scenarios.stream_tape)"
        )


def _stream_window(skw: dict) -> tuple[float, float]:
    return float(skw.get("warmup_frac", 0.1)), float(skw.get("end_frac", 0.9))


class SweepResult(NamedTuple):
    """A completed sweep: the spec, per-seed stats and where it ran.

    ``stats[policy][metric]`` is a numpy array ``[n_rates, n_seeds]``;
    ``chunk_seeds`` the seed-chunk size it ran in (None: one chunk).
    """

    spec: Sweep
    stats: dict[str, dict[str, np.ndarray]]
    wall_s: float
    backend: str  # "cuda" or "cpu"
    device_count: int
    device: torch.device
    chunk_seeds: int | None = None

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
        """Compact JSON-able record (per-cell mean/std), the JAX layout (its
        spec keys, the unported regimes at their off values) with torch,
        CUDA and card provenance."""
        spec = {**{k: (list(v) if isinstance(v, tuple) else v) for k, v in UNPORTED.items()},
                **self.spec._asdict()}
        spec["scenario_kw"] = [list(kv) for kv in self.spec.scenario_kw]
        spec["stream"] = [list(kv) for kv in self.spec.stream]
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
            "compile_s": 0.0,  # nothing is traced; kernel builds happen at first use
            "backend": self.backend,
            "device_count": self.device_count,
            "chunk_seeds": self.chunk_seeds,
            "sharded": False,
        }


# --------------------------------------------------------------- executors
def _policy_cells(spec: Sweep, name: str, x0, arr, p_drift) -> OnlineSimResult:
    """Every cell of one policy column, as one batch."""
    if spec.superstep:
        return simulate_online_superstep(
            x0, arr, spec.p, spec.n_servers, name, p_drift=p_drift, device=x0.device
        )
    # The carried ranks cannot follow a regime change: drift takes engine.run.
    rank_pol = make_rank_policy(name) if spec.n_chips is None and p_drift is None else None
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
    res = engine.run(x0, arr, spec.p, rule, fused=spec.fused, p_drift=p_drift)
    return _finalize(x0, arr, res.completion_times, spec.p, n_alone)


def _stream_cells(spec: Sweep, name: str, x0, arr) -> engine.StreamResult:
    """Every cell of one policy column through the bounded-slot loop, each
    rate's window ``(warmup_frac, end_frac) x n_jobs / rate``."""
    skw = dict(spec.stream)
    n_slots = int(skw["n_slots"])
    warm, end = _stream_window(skw)
    span = spec.n_jobs / torch.tensor(spec.rates, dtype=x0.dtype, device=x0.device)[:, None]
    window = (warm * span, end * span)  # [R, 1]: over the cells' [R, S]
    rank_pol = make_rank_policy(name) if spec.n_chips is None and not spec.fused else None
    if rank_pol is not None:
        return engine.run_stream_ranked(
            x0, arr, spec.p, spec.n_servers, rank_pol, n_slots=n_slots, window=window,
            n_alone=spec.n_servers,
        )
    pol = make_policy(
        name, n_servers=spec.n_chips if spec.n_chips is not None else spec.n_servers
    )
    return simulate_stream(
        Scenario(x0, arr), spec.p, spec.n_servers, pol, n_slots=n_slots, window=window,
        n_chips=spec.n_chips, min_chips=spec.min_chips, fused=spec.fused, device=x0.device,
    )


def draw_scenario(spec: Sweep, *, seeds=None, device="cuda") -> Scenario:
    """The sweep's tapes ``[R, S, M]`` for ``seeds`` (default all; a seed
    chunk draws the same tapes): one generator per seed, its draw shared
    across the rate axis.  A drift scenario's times come out ``[R, S, D]``."""
    sampler = make_scenario(
        spec.scenario, size_alpha=spec.size_alpha, p=spec.p, **dict(spec.scenario_kw)
    )
    seeds = range(spec.n_seeds) if seeds is None else seeds
    scns = [
        sampler(seed_generator(spec.seed, s, device=device), spec.n_jobs, spec.rates)
        for s in seeds
    ]
    drift = None
    if scns[0].p_drift is not None:  # the regimes are the spec's, alike in every seed
        drift = PDrift(torch.stack([s.p_drift.times for s in scns], 1), scns[0].p_drift.values)
    return Scenario(
        x0=torch.stack([s.x0 for s in scns], 1),
        arrival_times=torch.stack([s.arrival_times for s in scns], 1),
        p_drift=drift,
    )


def simulate_cells(spec: Sweep, x0, arr, *, p_drift=None, device="cuda") -> dict:
    """Run every policy of ``spec`` on given tapes ``x0``/``arr`` ``[R, S, M]``
    (and the drift scenario's ``engine.PDrift``, times ``[R, S, D]``).

    Returns ``{policy: {metric: ndarray [R, S]}}`` (float64, counts of a
    stream sweep included, as in the JAX sweep) — the executor
    :func:`run_sweep` uses, open to tapes drawn elsewhere (e.g. by the JAX
    sampler, for parity).
    """
    dev = resolve_device(device)
    x0 = as_tensor(x0, dev)
    arr = as_tensor(arr, dev)
    if p_drift is not None:
        p_drift = PDrift(as_tensor(p_drift.times, dev), as_tensor(p_drift.values, dev))
    stats = {}
    for name in spec.policies:
        if spec.stream:
            res = _stream_cells(spec, name, x0, arr)
            fields = {m: STREAM_METRICS[m] for m in spec.metrics}
        else:
            res = _policy_cells(spec, name, x0, arr, p_drift)
            fields = {m: m for m in spec.metrics}
        stats[name] = {m: getattr(res, f).to(torch.float64).cpu().numpy()
                       for m, f in fields.items()}
    return stats


def resolve_chunk(spec: Sweep, chunk_seeds: int | None,
                  max_jobs_in_flight: int | None) -> int | None:
    """Seed-chunk size from an explicit count or a jobs-in-flight budget.

    A chunk holds ``chunk * n_rates * n_jobs`` jobs at once;
    ``max_jobs_in_flight`` caps that product (floor: one seed a chunk).
    """
    if chunk_seeds is not None and max_jobs_in_flight is not None:
        raise ValueError("pass chunk_seeds or max_jobs_in_flight, not both")
    if max_jobs_in_flight is not None:
        return max(1, int(max_jobs_in_flight) // spec.jobs_per_seed())
    return None if chunk_seeds is None else max(1, int(chunk_seeds))


#: Every :func:`run_sweep` appends its compact record here (bounded to the
#: last :data:`RUN_LOG_MAX`); :func:`write_bench_json` flushes it.
RUN_LOG: list[dict] = []
RUN_LOG_MAX = 512


def bench_records() -> list[dict]:
    return list(RUN_LOG)


def write_bench_json(path=BENCH_JSON) -> str:
    """Flush the run log to ``path``, the JAX file's layout."""
    with open(path, "w") as f:
        json.dump({"schema_version": SCHEMA_VERSION, "records": RUN_LOG}, f, indent=1)
    return str(path)


def run_sweep(
    spec: Sweep, *, chunk_seeds: int | None = None, max_jobs_in_flight: int | None = None,
    device="cuda",
) -> SweepResult:
    """Execute a :class:`Sweep` on ``device``; the wall time covers the
    tapes' draw and every policy's batched run, synchronized.

    ``chunk_seeds`` / ``max_jobs_in_flight`` run the seeds in sequential
    chunks (a chunk of one size or more than the seeds is one chunk, as in
    the JAX sweep), each drawing its seeds' own tapes: the results are the
    unchunked ones bit for bit.  The run's record goes to :data:`RUN_LOG`.
    """
    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    chunk = resolve_chunk(spec, chunk_seeds, max_jobs_in_flight)
    if chunk is not None and chunk >= spec.n_seeds:
        chunk = None
    step = chunk or spec.n_seeds
    if on_cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    parts = []
    for s0 in range(0, spec.n_seeds, step):
        scn = draw_scenario(spec, seeds=range(s0, min(s0 + step, spec.n_seeds)), device=dev)
        parts.append(simulate_cells(  # .cpu() synchronizes
            spec, scn.x0, scn.arrival_times, p_drift=scn.p_drift, device=dev
        ))
    stats = {
        name: {m: np.concatenate([part[name][m] for part in parts], 1) for m in spec.metrics}
        for name in spec.policies
    }
    wall_s = time.perf_counter() - t0
    result = SweepResult(
        spec=spec,
        stats=stats,
        wall_s=wall_s,
        backend=dev.type,
        device_count=torch.cuda.device_count() if on_cuda else 1,
        device=dev,
        chunk_seeds=chunk,
    )
    RUN_LOG.append(result.record())
    del RUN_LOG[:-RUN_LOG_MAX]
    return result


__all__ = [
    "BENCH_JSON",
    "RUN_LOG",
    "RUN_LOG_MAX",
    "SCALAR_METRICS",
    "STREAM_KEYS",
    "STREAM_METRICS",
    "Sweep",
    "SweepResult",
    "bench_records",
    "draw_scenario",
    "provenance",
    "resolve_chunk",
    "run_sweep",
    "simulate_cells",
    "write_bench_json",
]
