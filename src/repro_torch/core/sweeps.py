"""Sweeps: policies x rates x seeds through the batched event loop.

Port of ``repro.core.sweeps``.  :class:`Sweep` is the same declarative
spec (pure data; :meth:`Sweep.from_spec_dict` reads the ``spec`` of a JAX
``SweepResult.record()``), and :func:`run_sweep` draws one
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

``Sweep.create(telemetry=...)`` attaches a stream-mode probe
(``core/telemetry.py``) to every cell and adds its ``tel_<metric>_mean`` /
``tel_<metric>_max`` columns (a stream sweep's probe weights each rate's
window); a telemetry sweep leaves the carried-rank loops, as the JAX one
does.  ``Sweep.create(arm=...)`` runs the estimation arms of
``benchmarks/estimation.py`` on a drift scenario, each with ``p0`` as its
``p``: ``oracle`` (the policy sees the current true regime), ``stale``
(``p_hat`` pinned to ``p0``) and ``estimator`` (the online blended p-hat,
``core/estimation.py``).

``Sweep.create(classes=...)`` runs a multi-class scenario
(``multiclass_poisson``, ``multiclass_bursty``, ``drift_multiclass``)
through ``multiclass.simulate_multiclass`` with the class-aware policies
(``snap_slices`` snaps its whole chips to power-of-two slices) and adds the
per-class columns :data:`CLASS_METRICS`, ``[R, S, K]``.  A multi-class
scenario without ``classes`` is the class-blind baseline: the generic loop
with each job's true exponent.

``run_sweep(chunk_seeds=)`` (or ``max_jobs_in_flight=``) runs the seeds in
sequential chunks on the same per-seed generators, with the same results
bit for bit.  Every run appends its compact record to :data:`RUN_LOG`,
which :func:`write_bench_json` flushes (never to the JAX package's
``BENCH_sweeps.json``).

Not ported yet (ROADMAP.md Queue A, item 10): sharding.
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
from repro_torch.core.analysis import per_class_mean, seed_axis_stats
from repro_torch.core.arrivals import (
    OnlineSimResult,
    _finalize,
    simulate_online_superstep,
    simulate_scenario,
    simulate_stream,
)
from repro_torch.core.policies import make_policy, make_rank_policy
from repro_torch.core.engine import PDrift
from repro_torch.core.estimation import simulate_scenario_estimated
from repro_torch.core.multiclass import MULTICLASS_POLICY_NAMES, as_specs, simulate_multiclass
from repro_torch.core.scenarios import Scenario, _any_pos, make_scenario, seed_generator
from repro_torch.core.superstep import SUPERSTEP_RULE_POLICIES
from repro_torch.core.telemetry import (
    DEFAULT_METRICS,
    METRICS,
    make_probe,
    p_hat_error_metric,
    scalar_columns,
    scalar_values,
)
from repro_torch.device import as_tensor, resolve_device

#: Layout version of :meth:`SweepResult.record` (the JAX package's v2 plus
#: torch/CUDA provenance).
SCHEMA_VERSION = 2

#: Per-cell scalar metrics a sweep can report.
SCALAR_METRICS = ("total_flowtime", "mean_flowtime", "mean_slowdown", "makespan")

#: Per-class metrics of a multi-class sweep (``[R, S, K]``): the class mean
#: of a per-job field of ``OnlineSimResult``.
CLASS_METRICS = {
    "class_flowtime": "flow_times",
    "class_slowdown": "slowdowns",
}

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

#: Estimation arms (``benchmarks/estimation.py``): how the policy learns
#: the speedup exponent on a drift scenario.
ARMS = ("oracle", "stale", "estimator")

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


def _hashable(v):
    """JSON-ish values (lists, dicts, ClassSpec rows) as hashables, as the
    JAX spec stores them."""
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    return v


class Sweep(NamedTuple):
    """Declarative sweep spec: pure hashable data.

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
    snap_slices: bool = False  # power-of-two slices (multi-class sweeps)
    classes: tuple | None = None  # tuple[ClassSpec, ...] for multi-class
    metrics: tuple[str, ...] = ("mean_flowtime",)
    arm: str | None = None  # estimation regime: oracle | stale | estimator
    arm_kw: tuple = ()  # e.g. (("discount", 0.9), ("prior_weight", 1.0))
    fused: bool = False  # kernels/alloc.py fused allocate (quantized heSRPT)
    telemetry: tuple[str, ...] = ()  # in-loop probe metrics -> tel_* columns
    superstep: bool = False  # core/superstep.py closed-form path (continuous)
    stream: tuple = ()  # bounded-slot regime: (("n_slots", S), ...) kv pairs

    @classmethod
    def create(
        cls, policies, rates, *, scenario: str = "poisson", scenario_kw=None,
        n_jobs: int = 1000, n_seeds: int = 100, seed: int = 0, p: float = 0.5,
        n_servers: float = 256.0, size_alpha: float = 1.5, n_chips: int | None = None,
        min_chips: int = 1, snap_slices: bool = False, classes=None, metrics=None,
        arm: str | None = None, arm_kw=None, fused: bool = False, telemetry=(),
        superstep: bool = False, stream=None,
    ) -> Sweep:
        if classes is not None:
            classes = as_specs(classes)
        stream = tuple(sorted(dict(stream or {}).items()))
        skw_items = _hashable(dict(scenario_kw or {}))
        scenario_kw = dict(skw_items)
        noisy = (_any_pos(scenario_kw.get("sigma_size", 0.0))
                 or _any_pos(scenario_kw.get("sigma_p", 0.0)))
        if stream:
            _check_stream(dict(stream), scenario, arm, noisy, classes)
        class_kw = {} if classes is None else {"classes": classes}
        make_scenario(scenario, size_alpha=size_alpha, p=p, **class_kw, **scenario_kw)
        if metrics is None:
            metrics = (("stream_flow", "stream_slowdown") if stream
                       else ("mean_flowtime",) if classes is None
                       else ("mean_flowtime", "mean_slowdown", *CLASS_METRICS))
        metrics = tuple(metrics)
        for m in metrics:
            if stream:
                if m not in STREAM_METRICS:
                    raise ValueError(
                        f"metric {m!r} is not a streaming metric; streaming sweeps read "
                        f"{tuple(STREAM_METRICS)}"
                    )
            elif m in STREAM_METRICS:
                raise ValueError(f"metric {m!r} needs a streaming sweep (stream=)")
            elif m in CLASS_METRICS:
                if classes is None:
                    raise ValueError(f"metric {m!r} needs a multi-class sweep")
            elif m not in SCALAR_METRICS:
                raise ValueError(f"unknown metric {m!r}; known: {SCALAR_METRICS}")
        for name in policies:
            if classes is None:
                make_policy(name)  # raises for unknown policies
            elif name.lower() not in (*MULTICLASS_POLICY_NAMES, "hesrpt"):
                raise ValueError(f"unknown multi-class policy {name!r}; known: "
                                 f"{MULTICLASS_POLICY_NAMES}")
        if arm is not None:
            if arm not in ARMS:
                raise ValueError(f"unknown arm {arm!r}; known: {ARMS}")
            if classes is not None:
                raise ValueError("estimation arms are single-class sweeps")
            if n_chips is not None:
                # The arm cells run the continuous simulators.
                raise ValueError("estimation arms are continuous-only (no n_chips)")
            if "p0" not in scenario_kw:
                raise ValueError(
                    "estimation arms need scenario_kw['p0'] (the pre-drift exponent the "
                    "stale/estimator arms anchor their belief to)"
                )
        if snap_slices and classes is None:
            raise ValueError("snap_slices is only wired for multi-class sweeps")
        if fused:
            if classes is not None or arm is not None:
                raise ValueError("fused sweeps are single-class, arm-free")
            if n_chips is None:
                raise ValueError(
                    "fused=True needs n_chips (the quantized regime; continuous "
                    "heSRPT already runs the ranked fast path)"
                )
            bad = tuple(q for q in policies if q != "hesrpt")
            if bad:
                raise ValueError(f"fused sweeps support only heSRPT, got {bad}")
        if superstep:
            # Exact only for the continuous, noise-free, scalar-p rank family.
            if classes is not None or arm is not None:
                raise ValueError("superstep sweeps are single-class, arm-free")
            if n_chips is not None:
                raise ValueError(
                    "superstep=True is the continuous closed-form path "
                    "(quantized chips need the per-event loop)"
                )
            if fused or telemetry or stream:
                raise ValueError(
                    "superstep sweeps take no fused/telemetry/stream options (all "
                    "three ride the per-event loop)"
                )
            bad = tuple(q for q in policies if q not in SUPERSTEP_RULE_POLICIES)
            if bad:
                raise ValueError(f"superstep sweeps support heSRPT/EQUI/SRPT, got {bad}")
            if noisy:
                raise ValueError(
                    "superstep sweeps need noise-free scenarios (estimation noise takes "
                    "the generic loop)"
                )
            if scenario.startswith("multiclass_"):
                raise ValueError(
                    "superstep sweeps are single-class (per-job exponents take the "
                    "generic scan)"
                )
        if telemetry is True:
            telemetry = DEFAULT_METRICS
        telemetry = tuple(telemetry or ())
        unknown = tuple(m for m in telemetry if m not in METRICS)
        if unknown:
            raise ValueError(f"unknown telemetry metric(s) {unknown}; known: {METRICS}")
        if telemetry and classes is not None:
            # The reference threads no probe through simulate_multiclass.
            raise ValueError("telemetry columns are single-class only for now")
        if "p_hat_err" in telemetry and arm != "estimator":
            raise ValueError(
                "telemetry metric 'p_hat_err' needs arm='estimator' (only an "
                "estimating rule carries a p-hat to be wrong)"
            )
        return cls(
            policies=tuple(policies),
            rates=tuple(float(r) for r in rates),
            scenario=scenario,
            scenario_kw=skw_items,
            n_jobs=int(n_jobs),
            n_seeds=int(n_seeds),
            seed=int(seed),
            p=float(p),
            n_servers=float(n_servers),
            size_alpha=float(size_alpha),
            n_chips=None if n_chips is None else int(n_chips),
            min_chips=int(min_chips),
            snap_slices=bool(snap_slices),
            classes=classes,
            metrics=metrics,
            arm=arm,
            arm_kw=tuple(sorted(dict(arm_kw or {}).items())),
            fused=bool(fused),
            telemetry=telemetry,
            superstep=bool(superstep),
            stream=stream,
        )

    @classmethod
    def from_spec_dict(cls, d: dict) -> Sweep:
        """The spec of a JAX ``SweepResult.record()`` (its ``"spec"`` dict),
        ``classes`` as rows of ``ClassSpec`` fields included."""
        return cls.create(
            d["policies"], d["rates"], scenario=d["scenario"],
            scenario_kw={k: v for k, v in d.get("scenario_kw", [])},
            n_jobs=d["n_jobs"], n_seeds=d["n_seeds"], seed=d["seed"], p=d["p"],
            n_servers=d["n_servers"], size_alpha=d["size_alpha"],
            n_chips=d["n_chips"], min_chips=d["min_chips"], metrics=d["metrics"],
            arm=d.get("arm"), arm_kw={k: v for k, v in d.get("arm_kw", [])},
            fused=d.get("fused", False), telemetry=tuple(d.get("telemetry", ())),
            superstep=d.get("superstep", False),
            stream={k: v for k, v in d.get("stream", [])},
            snap_slices=d.get("snap_slices", False), classes=d.get("classes"),
        )

    def out_names(self) -> tuple[str, ...]:
        """Every stat column a cell gives: the metrics, then the telemetry
        probe's ``tel_*`` columns."""
        return self.metrics + scalar_columns(self.telemetry)

    def jobs_per_seed(self) -> int:
        return len(self.rates) * self.n_jobs

    def total_jobs(self) -> int:
        """Simulated jobs in the whole grid, per policy."""
        return self.n_seeds * self.jobs_per_seed()


def _check_stream(skw: dict, scenario: str, arm, noisy: bool, classes) -> None:
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
    if classes is not None or arm is not None:
        raise ValueError(
            "streaming sweeps are single-class and arm-free — per-job class/estimator "
            "state does not ride in slots"
        )
    if scenario.startswith(("drift_", "multiclass_")) or noisy:
        raise ValueError(
            "streaming sweeps need a plain tape scenario (no drift, classes or "
            "estimation noise — see scenarios.stream_tape)"
        )


def _stream_window(skw: dict) -> tuple[float, float]:
    return float(skw.get("warmup_frac", 0.1)), float(skw.get("end_frac", 0.9))


class SweepResult(NamedTuple):
    """A completed sweep: the spec, per-seed stats and where it ran.

    ``stats[policy][metric]`` is a numpy array ``[n_rates, n_seeds]`` (``[n_rates,
    n_seeds, K]`` for a per-class metric); ``chunk_seeds`` the seed-chunk
    size it ran in (None: one chunk).
    """

    spec: Sweep
    stats: dict[str, dict[str, np.ndarray]]
    wall_s: float
    backend: str  # "cuda" or "cpu"
    device_count: int
    device: torch.device
    chunk_seeds: int | None = None

    def cell_means(self, metric: str | None = None) -> dict:
        """``{rate: {policy: mean-over-seeds}}``; a per-class metric keeps
        its class axis, one mean over seeds a class (a list of ``K``)."""
        metric = metric or self.spec.metrics[0]

        def mean(a):
            return np.mean(a, axis=0).tolist() if a.ndim == 2 else float(np.mean(a))

        return {
            float(rate): {
                name: mean(self.stats[name][metric][ri]) for name in self.spec.policies
            }
            for ri, rate in enumerate(self.spec.rates)
        }

    def record(self) -> dict:
        """Compact JSON-able record (per-cell mean/std, ``[R, K]`` lists for
        a per-class metric), the JAX layout (its spec keys, ``classes`` as
        rows of ``ClassSpec`` fields) with torch, CUDA and card provenance.
        A benchmark's own spec dict (``lanes.sched_scale``) keeps its keys
        and its ``kind``, with no job counts, as in JAX."""
        cells = {name: {m: seed_axis_stats(a) for m, a in by_m.items()}
                 for name, by_m in self.stats.items()}
        if not isinstance(self.spec, Sweep):
            return {"kind": self.spec.get("kind", "bench"), "provenance": provenance(self.device),
                    "spec": dict(self.spec), "cells": cells, "n_seeds": None,
                    "total_jobs": None, "wall_s": self.wall_s, "compile_s": 0.0,
                    "backend": self.backend, "device_count": self.device_count,
                    "chunk_seeds": self.chunk_seeds, "sharded": False}
        spec = self.spec._asdict()
        for key in ("scenario_kw", "arm_kw", "stream"):
            spec[key] = [list(kv) for kv in spec[key]]
        if spec["classes"] is not None:
            spec["classes"] = [list(c) for c in spec["classes"]]
        for key in ("policies", "rates", "metrics", "telemetry"):
            spec[key] = list(spec[key])
        return {
            "kind": "sweep",
            "provenance": provenance(self.device),
            "spec": spec,
            "cells": cells,
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
def _probe(spec: Sweep, n_jobs: int, window=None):
    """The stream-mode probe of a telemetry sweep's cells (None without
    one): ``p_hat_err`` reads the estimator arm's state against ``p0``."""
    if not spec.telemetry:
        return None
    reader = None
    if spec.arm == "estimator":
        reader = p_hat_error_metric(dict(spec.scenario_kw)["p0"],
                                    prior_weight=dict(spec.arm_kw).get("prior_weight", 1.0))
    return make_probe(spec.telemetry, mode="stream",
                      alloc_unit=float(spec.n_chips) if spec.n_chips else 1.0, n_jobs=n_jobs,
                      p_hat_reader=reader, window=window)


def _arm_cells(spec: Sweep, name: str, scn: Scenario, probe, device):
    """Every cell of one estimation arm, each with ``p0`` as its ``p``."""
    akw = dict(spec.arm_kw)
    p0 = dict(spec.scenario_kw)["p0"]
    pol = make_policy(name, n_servers=spec.n_servers)
    if spec.arm == "oracle":  # the policy sees the current true regime
        return simulate_scenario(scn, p0, spec.n_servers, pol, telemetry=probe, device=device)
    if spec.arm == "stale":  # a pinned p_hat: the policy never sees the drift
        return simulate_scenario(scn._replace(p_hat=p0), p0, spec.n_servers, pol,
                                 telemetry=probe, device=device)
    return simulate_scenario_estimated(
        scn, p0, spec.n_servers, pol, prior_p=p0,
        prior_weight=akw.get("prior_weight", 1.0), discount=akw.get("discount", 1.0),
        telemetry=probe, device=device,
    )


def _policy_cells(spec: Sweep, name: str, scn: Scenario):
    """Every cell of one policy column, as one batch: ``(OnlineSimResult,
    TelemetryResult or None)``."""
    x0, arr, p_drift = scn.x0, scn.arrival_times, scn.p_drift
    if spec.classes is not None:
        return simulate_multiclass(
            scn, classes=spec.classes, policy=name, n_servers=spec.n_servers,
            n_chips=spec.n_chips, min_chips=spec.min_chips, snap_slices=spec.snap_slices,
            device=x0.device,
        ), None
    if spec.superstep:
        return simulate_online_superstep(
            x0, arr, spec.p, spec.n_servers, name, p_drift=p_drift, device=x0.device
        ), None
    probe = _probe(spec, spec.n_jobs)
    if spec.arm is not None:
        res = _arm_cells(spec, name, scn, probe, x0.device)
        return res if probe is not None else (res, None)
    kw = dict(spec.scenario_kw)
    noisy = _any_pos(kw.get("sigma_size", 0.0)) or _any_pos(kw.get("sigma_p", 0.0))
    # The carried ranks cannot follow a regime change, per-job exponents,
    # estimation noise or a probe (it reads the generic loop's events):
    # those take engine.run.
    rank_pol = (make_rank_policy(name)
                if spec.n_chips is None and p_drift is None and scn.p_job is None
                and not noisy and probe is None
                else None)
    if rank_pol is not None:
        times = engine.run_ranked(x0, arr, spec.p, spec.n_servers, rank_pol)
        return _finalize(x0, arr, times, spec.p, spec.n_servers), None
    pol = make_policy(
        name, n_servers=spec.n_chips if spec.n_chips is not None else spec.n_servers
    )
    res = simulate_scenario(scn, spec.p, spec.n_servers, pol, n_chips=spec.n_chips,
                            min_chips=spec.min_chips, fused=spec.fused, telemetry=probe,
                            device=x0.device)
    return res if probe is not None else (res, None)


def _stream_cells(spec: Sweep, name: str, x0, arr) -> engine.StreamResult:
    """Every cell of one policy column through the bounded-slot loop, each
    rate's window ``(warmup_frac, end_frac) x n_jobs / rate`` (the probe's
    too)."""
    skw = dict(spec.stream)
    n_slots = int(skw["n_slots"])
    warm, end = _stream_window(skw)
    span = spec.n_jobs / torch.tensor(spec.rates, dtype=x0.dtype, device=x0.device)[:, None]
    window = (warm * span, end * span)  # [R, 1]: over the cells' [R, S]
    probe = _probe(spec, n_slots, window)
    rank_pol = (make_rank_policy(name)
                if spec.n_chips is None and not spec.fused and probe is None else None)
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
        n_chips=spec.n_chips, min_chips=spec.min_chips, fused=spec.fused, telemetry=probe,
        device=x0.device,
    )


def draw_scenario(spec: Sweep, *, seeds=None, device="cuda") -> Scenario:
    """The sweep's tapes ``[R, S, M]`` for ``seeds`` (default all; a seed
    chunk draws the same tapes): one generator per seed, its draw shared
    across the rate axis.  A drift scenario's times come out ``[R, S, D]``
    (per-job regime rows ``[R, S, D + 1, M]``, each seed's own); estimation
    noise ``size_factors`` ``[R, S, M]`` and ``p_hat`` ``[R, S, 1]`` (per
    job ``[R, S, M]``); a multi-class scenario's ``class_ids`` and
    ``p_job`` ``[R, S, M]``."""
    class_kw = {} if spec.classes is None else {"classes": spec.classes}
    sampler = make_scenario(
        spec.scenario, size_alpha=spec.size_alpha, p=spec.p, **class_kw,
        **dict(spec.scenario_kw),
    )
    seeds = range(spec.n_seeds) if seeds is None else seeds
    scns = [
        sampler(seed_generator(spec.seed, s, device=device), spec.n_jobs, spec.rates)
        for s in seeds
    ]
    drift = None
    if scns[0].p_drift is not None:
        # Scalar regimes are the spec's, alike in every seed; per-job rows
        # follow each seed's class draw.
        values = (torch.stack([s.p_drift.values for s in scns], 1)
                  if engine._per_job_rows(scns[0].p_drift) else scns[0].p_drift.values)
        drift = PDrift(torch.stack([s.p_drift.times for s in scns], 1), values)

    def stacked(field):
        first = getattr(scns[0], field)
        return None if first is None else torch.stack([getattr(s, field) for s in scns], 1)

    return Scenario(
        x0=stacked("x0"), arrival_times=stacked("arrival_times"), p_drift=drift,
        size_factors=stacked("size_factors"), p_hat=stacked("p_hat"),
        class_ids=stacked("class_ids"), p_job=stacked("p_job"),
    )


def simulate_cells(spec: Sweep, x0, arr, *, p_drift=None, size_factors=None, p_hat=None,
                   class_ids=None, p_job=None, device="cuda") -> dict:
    """Run every policy of ``spec`` on given tapes ``x0``/``arr`` ``[R, S, M]``
    (and the drift scenario's ``engine.PDrift``, times ``[R, S, D]``, values
    shared or per-job rows ``[R, S, D + 1, M]``; the estimation noise,
    ``size_factors`` ``[R, S, M]`` and ``p_hat`` ``[R, S, 1]`` or
    ``[R, S, M]``; a multi-class scenario's ``class_ids`` and ``p_job``
    ``[R, S, M]``).

    Returns ``{policy: {column: ndarray [R, S]}}`` over
    :meth:`Sweep.out_names` (``[R, S, K]`` for a per-class column; float64,
    counts of a stream sweep included, as in the JAX sweep) — the executor
    :func:`run_sweep` uses, open to tapes drawn elsewhere (e.g. by the JAX
    sampler, for parity).
    """
    dev = resolve_device(device)
    x0 = as_tensor(x0, dev)
    arr = as_tensor(arr, dev)
    if p_drift is not None:
        p_drift = PDrift(as_tensor(p_drift.times, dev), as_tensor(p_drift.values, dev))
    scn = Scenario(
        x0, arr, p_drift=p_drift,
        size_factors=None if size_factors is None else as_tensor(size_factors, dev),
        p_hat=None if p_hat is None else as_tensor(p_hat, dev),
        class_ids=None if class_ids is None else as_tensor(class_ids, dev, torch.int64),
        p_job=None if p_job is None else as_tensor(p_job, dev),
    )
    stats = {}
    for name in spec.policies:
        if spec.stream:
            res = _stream_cells(spec, name, x0, arr)
            tel = res.telemetry
            fields = {m: STREAM_METRICS[m] for m in spec.metrics}
        else:
            res, tel = _policy_cells(spec, name, scn)
            fields = {m: m for m in spec.metrics}
        cols = {m: per_class_mean(getattr(res, CLASS_METRICS[m]), scn.class_ids,
                                  len(spec.classes))
                if m in CLASS_METRICS else getattr(res, f) for m, f in fields.items()}
        if tel is not None:
            cols.update(zip(scalar_columns(spec.telemetry), scalar_values(tel, spec.telemetry)))
        stats[name] = {m: v.to(torch.float64).cpu().numpy() for m, v in cols.items()}
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


def log_record(record: dict) -> None:
    """Append ``record`` to :data:`RUN_LOG`, keeping the last :data:`RUN_LOG_MAX`."""
    RUN_LOG.append(record)
    del RUN_LOG[:-RUN_LOG_MAX]


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
            spec, scn.x0, scn.arrival_times, p_drift=scn.p_drift,
            size_factors=scn.size_factors, p_hat=scn.p_hat, class_ids=scn.class_ids,
            p_job=scn.p_job, device=dev,
        ))
    stats = {
        name: {m: np.concatenate([part[name][m] for part in parts], 1)
               for m in spec.out_names()}
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
    log_record(result.record())
    return result


__all__ = [
    "ARMS",
    "BENCH_JSON",
    "CLASS_METRICS",
    "RUN_LOG",
    "RUN_LOG_MAX",
    "SCALAR_METRICS",
    "STREAM_KEYS",
    "STREAM_METRICS",
    "Sweep",
    "SweepResult",
    "bench_records",
    "draw_scenario",
    "log_record",
    "provenance",
    "resolve_chunk",
    "run_sweep",
    "simulate_cells",
    "write_bench_json",
]
