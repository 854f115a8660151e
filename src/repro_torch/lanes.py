"""The three canonical sweep lanes of the heSRPT sweep path.

Port of ``benchmarks/backend_lane.py`` (same lanes, same sizes):

- ``quantized`` — whole-chips heSRPT on the unfused engine (plain PyTorch:
  policy, then two stable argsorts to round);
- ``quantized-fused`` — the identical spec through the fused allocate (the
  CUDA kernel on the card, one launch per event for every cell), equal to
  the unfused lane bit for bit;
- ``continuous`` — the paper's divisible regime on the carried-rank loop.

Full size: 24 rates x 8 seeds x 1000 jobs on a 256-chip pool, p = 0.5.

The drift lanes (:func:`drift_lane_specs`) run the same grid under the
drift settings of ``benchmarks/estimation.py`` (p 0.8 -> 0.3 at half the
stream's nominal span): quantized, quantized-fused (the kernel takes each
cell's current p from device memory, ``2M + 1`` launches) and continuous
heSRPT, which under drift takes the generic loop.

The stream lanes (:func:`stream_lane_specs`) run the same three lanes
through the bounded-slot loop (``Sweep(stream=)``) over a pool of 64 slots
a cell, reading every stream metric: the fused lane launches the kernel
once an event step at ``[192, 64]``; the continuous lane takes the
carried-rank stream.

The multi-class grid (:func:`multiclass_specs`) is ``benchmarks/
multiclass.py``'s as port data: K = 2, 3 and 4 classes from
:func:`class_grid`, the four class-aware policies, rates 0.5, 2 and 8 on
256 servers, at its full (1000 jobs x 10 seeds), quick (300 x 8) or smoke
(80 x 4, rates 0.5 and 4) size, and the K = 2 snap pair (``hesrpt_pc`` on
256 chips, at most 300 jobs x 8 seeds, slices off and on).

The cross-checks against the per-event ``ClusterScheduler`` (``sched/``)
and the decision-epoch benchmark, named by their source files:
``benchmarks/arrivals.py``'s :func:`stream_trace`,
:func:`run_stream_reference` (the per-event loop over an arrival tape) and
:func:`arrivals_cross_check`; ``benchmarks/quantized.py``'s
:func:`engine_events` and :func:`quantized_cross_check`;
``benchmarks/estimation.py``'s :func:`estimation_cross_check`;
``benchmarks/multiclass.py``'s :func:`run_stream_reference_mc` and
:func:`multiclass_cross_check`; ``benchmarks/streaming.py``'s
:func:`stream_oracle_check`; and ``benchmarks/sched_scale.py``'s
:func:`sched_scale`.  Each returns the keys its JAX twin returns.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core import engine, estimation, policies, scenarios, sweeps
from repro_torch.core.arrivals import simulate_online, simulate_online_quantized
from repro_torch.core.multiclass import (
    ClassSpec,
    as_specs,
    class_rule,
    policy_weights,
    simulate_multiclass,
)
from repro_torch.core.sweeps import STREAM_METRICS, Sweep, SweepResult, run_sweep
from repro_torch.device import DTYPE, resolve_device
from repro_torch.sched import ClusterScheduler, Job
from repro_torch.sched.quantize import quantize_allocation

RATES_FULL = tuple(float(r) for r in np.geomspace(0.25, 16.0, 24).round(4))
RATES_SMOKE = (0.5, 1.0, 2.0, 4.0, 8.0)
N_CHIPS = 256
LABELS = ("quantized", "quantized-fused", "continuous")
#: ``benchmarks/estimation.py``'s drift: p0 -> p1 at drift_frac x n_jobs / rate.
DRIFT_KW = {"p0": 0.8, "p1": 0.3, "drift_frac": 0.5}
DRIFT_LABELS = tuple(f"drift-{label}" for label in LABELS)
#: The stream lanes' slot pool (``benchmarks/streaming.py``'s load ladder),
#: and the smoke size's (that file's ``--smoke``: 120 jobs, 16 slots).
STREAM_SLOTS, STREAM_SLOTS_SMOKE, STREAM_JOBS_SMOKE = 64, 16, 120
STREAM_LABELS = tuple(f"stream-{label}" for label in LABELS)


def lane_specs(smoke: bool = False) -> list[tuple[str, Sweep]]:
    """The canonical lanes as ``(label, Sweep)`` pairs."""
    if smoke:
        rates, n_jobs, n_seeds = RATES_SMOKE, 60, 2
    else:
        rates, n_jobs, n_seeds = RATES_FULL, 1000, 8
    common = dict(
        n_jobs=n_jobs, n_seeds=n_seeds, p=0.5, n_servers=float(N_CHIPS), seed=0
    )
    return [
        ("quantized", Sweep.create(("hesrpt",), rates, n_chips=N_CHIPS, **common)),
        ("quantized-fused",
         Sweep.create(("hesrpt",), rates, n_chips=N_CHIPS, fused=True, **common)),
        ("continuous", Sweep.create(("hesrpt",), rates, **common)),
    ]


def drift_lane_specs(
    smoke: bool = False, scenario: str = "drift_poisson"
) -> list[tuple[str, Sweep]]:
    """The canonical lanes' grid under ``scenario`` (``drift_poisson`` or
    ``drift_bursty``) with :data:`DRIFT_KW`, as ``(label, Sweep)`` pairs;
    ``p`` is the pre-drift ``p0`` (it normalizes the slowdowns)."""
    return [
        (f"drift-{label}", spec._replace(
            scenario=scenario, scenario_kw=tuple(sorted(DRIFT_KW.items())), p=DRIFT_KW["p0"]
        ))
        for label, spec in lane_specs(smoke=smoke)
    ]


def stream_lane_specs(smoke: bool = False) -> list[tuple[str, Sweep]]:
    """The canonical lanes through the bounded-slot loop, every stream
    metric, as ``(label, Sweep)`` pairs: :data:`STREAM_SLOTS` slots at full
    size; at smoke size 120 jobs through 16 slots."""
    n_slots = STREAM_SLOTS_SMOKE if smoke else STREAM_SLOTS
    out = []
    for label, spec in lane_specs(smoke=smoke):
        if smoke:
            spec = spec._replace(n_jobs=STREAM_JOBS_SMOKE)
        out.append((f"stream-{label}", spec._replace(
            stream=(("n_slots", n_slots),), metrics=tuple(STREAM_METRICS))))
    return out


#: ``benchmarks/multiclass.py``'s policies and rates.
MC_POLICIES = ("hesrpt_pc", "waterfill", "hesrpt_sd", "hesrpt_blind")
MC_RATES = (0.5, 2.0, 8.0)
#: Its sizes: the class counts K, jobs, seeds and rates of each tier.
MC_SIZES = {
    "full": ((2, 3, 4), 1000, 10, MC_RATES),
    "quick": ((2, 3), 300, 8, MC_RATES),
    "smoke": ((2,), 80, 4, (0.5, 4.0)),
}
#: The snap pair's pool and its cap on the grid (that file's ``min(n, 300)``
#: jobs and ``min(s, 8)`` seeds).
MC_SNAP_CHIPS, MC_SNAP_JOBS, MC_SNAP_SEEDS = 256, 300, 8


def class_grid(K: int) -> tuple[ClassSpec, ...]:
    """``benchmarks/multiclass.py``'s K classes: exponents over [0.3, 0.85],
    Pareto tails over [1.5, 2.5], geometric scales 1 .. 2^(K-1), equal
    mix."""
    ps = np.linspace(0.3, 0.85, K)
    alphas = np.linspace(1.5, 2.5, K)
    scales = np.geomspace(1.0, 2.0 ** (K - 1), K)
    return tuple(
        ClassSpec(p=float(p), mix=1.0 / K, size_alpha=float(a), size_scale=float(sc))
        for p, a, sc in zip(ps, alphas, scales, strict=True)
    )


def multiclass_specs(size: str = "full") -> list[tuple[str, Sweep]]:
    """The multi-class grid at ``size`` (``"full"``, ``"quick"``, ``"smoke"``)
    as ``(label, Sweep)`` pairs: ``"K=k"`` for each of the tier's class
    counts, then ``"snap-off"`` / ``"snap-on"``."""
    ks, n_jobs, n_seeds, rates = MC_SIZES[size]
    out = [
        (f"K={K}", Sweep.create(
            MC_POLICIES, rates, scenario="multiclass_poisson", n_jobs=n_jobs,
            n_seeds=n_seeds, seed=0, n_servers=256.0, classes=class_grid(K),
        ))
        for K in ks
    ]
    for label, snap in (("snap-off", False), ("snap-on", True)):
        out.append((label, Sweep.create(
            ("hesrpt_pc",), rates, scenario="multiclass_poisson",
            n_jobs=min(n_jobs, MC_SNAP_JOBS), n_seeds=min(n_seeds, MC_SNAP_SEEDS), seed=0,
            n_servers=256.0, n_chips=MC_SNAP_CHIPS, snap_slices=snap, classes=class_grid(2),
        )))
    return out


def gap_ratios(res: SweepResult) -> dict[str, list[float]]:
    """Class-aware against class-blind heSRPT (``benchmarks/multiclass.py``'s
    ``gap_rows``): at each rate, the best class-aware policy's mean over
    seeds over ``hesrpt_blind``'s, for mean flow time and mean slowdown."""
    out = {}
    for metric, label in (("mean_flowtime", "flow"), ("mean_slowdown", "slowdown")):
        blind = res.stats["hesrpt_blind"][metric].mean(axis=1)
        aware = [res.stats[name][metric].mean(axis=1)
                 for name in res.spec.policies if name != "hesrpt_blind"]
        out[label] = [float(min(a[ri] for a in aware) / blind[ri])
                      for ri in range(len(res.spec.rates))]
    return out


def run_lanes(smoke: bool = False, *, device="cuda"):
    """Run every lane on ``device``; returns ``[(label, SweepResult)]``."""
    return [
        (label, run_sweep(spec, device=device))
        for label, spec in lane_specs(smoke=smoke)
    ]


def lane_records(lanes: list[tuple[str, SweepResult]]) -> list[dict]:
    """One sweep record per lane (``lane`` added) plus a ``backend_lane``
    summary with throughput and the fused/unfused wall ratio."""
    records = []
    for label, res in lanes:
        rec = res.record()
        rec["lane"] = label
        records.append(rec)
    by_label = dict(lanes)
    q, qf = by_label.get("quantized"), by_label.get("quantized-fused")
    first = lanes[0][1]
    records.append({
        "kind": "backend_lane",
        "backend": first.backend,
        "device_count": first.device_count,
        "lanes": {
            label: {
                "wall_s": res.wall_s,
                "jobs_per_s": res.spec.total_jobs() * len(res.spec.policies)
                / max(res.wall_s, 1e-9),
            }
            for label, res in lanes
        },
        "fused_speedup_wall": q.wall_s / max(qf.wall_s, 1e-9) if q and qf else None,
    })
    return records


def fused_equals_unfused(lanes, prefix: str = "") -> bool:
    """The fused and unfused quantized lanes (labels after ``prefix``, e.g.
    ``"drift-"`` or ``"stream-"``) agree bit for bit in every metric."""
    by_label = dict(lanes)
    q, qf = by_label[f"{prefix}quantized"], by_label[f"{prefix}quantized-fused"]
    return all(
        np.array_equal(q.stats["hesrpt"][m], qf.stats["hesrpt"][m]) for m in q.spec.metrics
    )


# ------------------------------------- benchmarks/ against ClusterScheduler
#: ``benchmarks/arrivals.py``'s policies.
ARRIVAL_POLICIES = ("hesrpt", "equi", "srpt")


def stream_trace(n_jobs: int, rate: float, seed: int, size_alpha: float = 1.5):
    """``benchmarks/arrivals.py``'s tape: Poisson arrivals, Pareto sizes,
    from numpy's ``default_rng(seed)`` (the same arrays as that file's)."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_jobs))
    sizes = rng.pareto(size_alpha, n_jobs) + 1.0
    return arrivals, sizes


def _policy(name: str, n_chips):
    return policies.make_policy(name, n_servers=float(n_chips))


def _stream_loop(sched: ClusterScheduler, arrivals, make_job, *, return_events: bool):
    """The per-event loop over an arrival tape (admission epsilon 1e-12,
    departure nudge 1e-15, idle advance to the next arrival), each job
    progressing at ``sched.job_rates``; per-job flows in input order, and
    the allocation events ``[(t, {job_id: chips}), ...]`` when asked."""
    n_jobs = len(arrivals)
    i = guard = 0  # i: the next arrival
    while i < n_jobs or sched.active_jobs():
        while i < n_jobs and arrivals[i] <= sched.time + 1e-12:
            sched.add_job(make_job(i))
            sched.jobs[f"j{i}"].arrival_time = float(arrivals[i])
            i += 1
        act = sched.active_jobs()
        if not act:
            sched.time = float(arrivals[i])
            continue
        sched.allocations()
        rates = sched.job_rates(act)
        dt = min(j.remaining / r for j, r in zip(act, rates, strict=True) if r > 0)
        if i < n_jobs:
            dt = min(dt, float(arrivals[i]) - sched.time)
        sched.advance_fluid(until_departure=False, dt=dt + 1e-15)
        guard += 1
        if guard > 50 * n_jobs:
            raise RuntimeError("arrival-stream sim did not converge")
    flows = np.array([sched.jobs[f"j{k}"].completion_time - sched.jobs[f"j{k}"].arrival_time
                      for k in range(n_jobs)])
    if return_events:
        return flows, [(e["t"], e["chips"]) for e in sched.events if e["event"] == "allocate"]
    return flows


def run_stream_reference(policy: str, arrivals, sizes, *, p=0.5, n_chips=256, quantize=True,
                         min_chips=1, return_events=False, use_estimator=False, prior_p=None,
                         est_discount=1.0, est_prior_weight=1.0, device="cuda"):
    """``benchmarks/arrivals.py``'s per-event loop over ``ClusterScheduler``:
    per-job flow times (and the allocation events with
    ``return_events=True``).  ``quantize=False`` is the fluid model
    ``simulate_online`` must reproduce; ``use_estimator=True`` the
    online-estimation regime (priors ``prior_p``, physics the true ``p``)."""
    arrivals = np.asarray(arrivals, dtype=np.float64)
    sizes = np.asarray(sizes, dtype=np.float64)
    sched = ClusterScheduler(n_chips, policy=policy, quantize=quantize, min_chips=min_chips,
                             use_estimator=use_estimator, est_discount=est_discount,
                             est_prior_weight=est_prior_weight, device=device)
    return _stream_loop(
        sched, arrivals,
        lambda i: Job(f"j{i}", size=float(sizes[i]), p=p, prior_p=prior_p),
        return_events=return_events)


def arrivals_cross_check(*, n_jobs=10, rate=1.0, p=0.5, n_chips=64, seed=0,
                         policies=ARRIVAL_POLICIES, device="cuda") -> float:
    """Max relative per-job flow-time error: the continuous online
    simulator against the per-event fluid loop (``benchmarks/arrivals.py``'s
    ``cross_check``, whose bar is 1e-6)."""
    dev = resolve_device(device)
    arrivals, sizes = stream_trace(n_jobs, rate, seed)
    worst = 0.0
    for name in policies:
        ref = run_stream_reference(name, arrivals, sizes, p=p, n_chips=n_chips, quantize=False,
                                   device=dev)
        res = simulate_online(sizes, arrivals, p, float(n_chips),
                              _policy(name, n_chips), device=dev)
        got = res.flow_times.cpu().numpy()
        worst = max(worst, float(np.max(np.abs(got - ref) / ref)))
    return worst


def engine_events(eng_result, arrivals):
    """``(t, {job_id: chips})`` of every event of a recorded ``engine.run``
    on one 1-D tape (idle steps skipped), named as the per-event loop
    names its jobs (``benchmarks/quantized.py``'s)."""
    order = eng_result.order.cpu().numpy()
    tr = eng_result.trace
    t_ev, sizes_tr, alloc = (v.cpu().numpy() for v in (tr.times, tr.sizes, tr.alloc))
    arr_sorted = np.asarray(arrivals)[order]
    out = []
    for e in range(len(t_ev)):
        live = (arr_sorted <= t_ev[e] + 1e-12) & (sizes_tr[e] > 0)
        if not live.any():
            continue
        out.append((float(t_ev[e]),
                    {f"j{order[k]}": int(alloc[e, k]) for k in np.nonzero(live)[0]}))
    return out


def _compare_events(allocs_eng, allocs_ref):
    """(chips equal at every event, worst relative epoch-time gap)."""
    ok = len(allocs_eng) == len(allocs_ref)
    worst_t = 0.0
    for (t_e, c_e), (t_r, c_r) in zip(allocs_eng, allocs_ref, strict=False):
        ok &= c_e == c_r
        worst_t = max(worst_t, abs(t_e - t_r) / max(t_r, 1e-12))
    return ok, worst_t


def quantized_cross_check(policies=("hesrpt", "equi", "srpt"), *, n_jobs=12, rate=1.0,
                          p=0.5, n_chips=64, seed=0, device="cuda") -> dict:
    """The engine's whole-chips trajectory against the per-event
    ``ClusterScheduler(quantize=True)`` loop (``benchmarks/quantized.py``'s
    ``cross_check``): chips exactly equal at every event, epoch and flow
    times to float tolerance (the loop advances with a 1e-15 nudge)."""
    dev = resolve_device(device)
    arrivals, sizes = stream_trace(n_jobs, rate, seed)
    worst_t, worst_flow, chips_ok, n_events = 0.0, 0.0, True, 0
    for name in policies:
        flows_ref, allocs_ref = run_stream_reference(name, arrivals, sizes, p=p,
                                                     n_chips=n_chips, return_events=True,
                                                     device=dev)
        res, eng = simulate_online_quantized(sizes, arrivals, p, n_chips, _policy(name, n_chips),
                                             record=True, device=dev)
        ok, gap = _compare_events(engine_events(eng, arrivals), allocs_ref)
        chips_ok &= ok
        worst_t = max(worst_t, gap)
        n_events += len(allocs_ref)
        flows = res.flow_times.cpu().numpy()
        worst_flow = max(worst_flow, float(np.max(np.abs(flows - flows_ref) / flows_ref)))
    return {"chips_exact": bool(chips_ok), "n_events": n_events,
            "worst_epoch_time_rel": worst_t, "worst_flow_rel": worst_flow}


def estimation_cross_check(*, n_jobs=10, n_chips=48, seed=0, device="cuda") -> dict:
    """``use_estimator=True`` delegated to the engine against the per-event
    loop on identical observation schedules (``benchmarks/estimation.py``'s
    ``cross_check``, bar 1e-8): the batch with heterogeneous true p
    (continuous and whole chips), the class-aware pooled p-hat, and the
    arrival stream against ``simulate_scenario_estimated``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    worst, n_cases = 0.0, 0

    def pair(mk):
        a, b = mk(), mk()
        if not a._engine_eligible():
            raise RuntimeError("an estimator instance must delegate")
        ra = a.run_fluid_to_completion(use_engine=True)
        rb = b.run_fluid_to_completion(use_engine=False)
        ta = np.array(sorted(ra["completion_times"].values()))
        tb = np.array(sorted(rb["completion_times"].values()))
        return float(np.max(np.abs(ta - tb) / tb))

    # The batch, heterogeneous true p, a wrong prior: continuous and chips.
    sizes = rng.pareto(1.5, n_jobs) + 1.0
    ps = rng.uniform(0.3, 0.8, n_jobs)
    for quantize in (False, True):

        def mk(quantize=quantize):
            s = ClusterScheduler(n_chips, policy="hesrpt", use_estimator=True,
                                 quantize=quantize, est_discount=0.9, device=dev)
            for i, sz in enumerate(sizes):
                s.add_job(Job(f"j{i}", size=float(sz), p=float(ps[i]), prior_p=0.5))
            return s

        worst = max(worst, pair(mk))
        n_cases += 1

    # Class-aware: the per-class pooled p-hat.
    cls = rng.integers(0, 3, n_jobs)
    pk = {0: 0.3, 1: 0.55, 2: 0.8}

    def mk_class():
        s = ClusterScheduler(n_chips, policy="hesrpt_pc", use_estimator=True, quantize=True,
                             class_aware=True, device=dev)
        for i, sz in enumerate(sizes):
            s.add_job(Job(f"j{i}", size=float(sz), p=pk[int(cls[i])], class_id=int(cls[i]),
                          prior_p=0.5))
        return s

    worst = max(worst, pair(mk_class))
    n_cases += 1

    # The arrival stream: the per-event loop against the engine's rule.
    arrivals, sz = stream_trace(n_jobs, 1.5, seed)
    flows_ref = run_stream_reference("hesrpt", arrivals, sz, p=0.6, n_chips=n_chips,
                                     quantize=False, use_estimator=True, prior_p=0.4,
                                     est_discount=0.9, device=dev)
    scn = scenarios.trace_scenario(arrivals, sz, device=dev)(None, n_jobs, 0.0)
    res = estimation.simulate_scenario_estimated(
        scn, 0.6, float(n_chips), _policy("hesrpt", n_chips), prior_p=0.4, discount=0.9,
        device=dev)
    flows = res.flow_times.cpu().numpy()
    worst = max(worst, float(np.max(np.abs(flows - flows_ref) / flows_ref)))
    n_cases += 1
    return {"worst_flow_rel": worst, "n_cases": n_cases,
            "finite": bool(torch.isfinite(res.completion_times).all())}


def run_stream_reference_mc(policy: str, arrivals, sizes, p_jobs, class_ids, *, n_chips=64,
                            quantize=True, min_chips=1, snap_slices=False, class_weights=None,
                            return_events=False, device="cuda"):
    """``benchmarks/multiclass.py``'s per-event loop over
    ``ClusterScheduler(class_aware=True)``: :func:`run_stream_reference`'s
    loop with each job at its own class exponent."""
    arrivals = np.asarray(arrivals, dtype=np.float64)
    sizes = np.asarray(sizes, dtype=np.float64)
    p_jobs = np.asarray(p_jobs, dtype=np.float64)
    class_ids = np.asarray(class_ids)
    sched = ClusterScheduler(n_chips, policy=policy, quantize=quantize, min_chips=min_chips,
                             snap_slices=snap_slices, class_aware=True,
                             class_weights=class_weights, device=device)
    return _stream_loop(
        sched, arrivals,
        lambda i: Job(f"j{i}", size=float(sizes[i]), p=float(p_jobs[i]),
                      class_id=int(class_ids[i])),
        return_events=return_events)


def multiclass_cross_check(policies=("hesrpt_pc", "waterfill", "hesrpt_sd"), *, n_jobs=12,
                           rate=1.0, n_chips=64, seed=0, snap_slices=False, classes=None,
                           tape=None, device="cuda") -> dict:
    """The engine's multi-class trajectory against the class-aware
    ``ClusterScheduler`` (``benchmarks/multiclass.py``'s ``cross_check``):
    whole chips exactly equal at every event, continuous flows within
    1e-10 and whole-chips flows within 1e-9 there.  The tape is
    ``multiclass_poisson``'s over ``classes`` (default :func:`class_grid`
    (2)) from a ``torch.Generator`` seeded with ``seed``, or ``tape =
    (arrivals, sizes, p_jobs, class_ids)``."""
    dev = resolve_device(device)
    specs = as_specs(classes if classes is not None else class_grid(2))
    if tape is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        scn = scenarios.make_scenario("multiclass_poisson", classes=specs)(gen, n_jobs, rate)
    else:
        arr, x0, p_job, ids = (np.asarray(v) for v in tape)
        scn = scenarios.tape_from_numpy(x0, arr, device=dev)._replace(
            p_job=torch.as_tensor(p_job, dtype=DTYPE, device=dev),
            class_ids=torch.as_tensor(ids, dtype=torch.int64, device=dev))
    arrivals, sizes, p_jobs, cls = (v.cpu().numpy() for v in (
        scn.arrival_times, scn.x0, scn.p_job, scn.class_ids))
    order = engine.loop_order(scn.arrival_times.reshape(1, -1))

    worst_cont, worst_q, chips_ok, n_events = 0.0, 0.0, True, 0
    for name in policies:
        # The continuous rule against the fractional-chips loop.
        flows_ref = run_stream_reference_mc(name, arrivals, sizes, p_jobs, cls,
                                            n_chips=n_chips, quantize=False, device=dev)
        res = simulate_multiclass(scn, classes=specs, policy=name, n_servers=float(n_chips),
                                  device=dev)
        flows = res.flow_times.cpu().numpy()
        worst_cont = max(worst_cont, float(np.max(np.abs(flows - flows_ref) / flows_ref)))
        # Whole chips against the whole-chips loop, event for event.
        flows_qref, allocs_ref = run_stream_reference_mc(
            name, arrivals, sizes, p_jobs, cls, n_chips=n_chips, quantize=True,
            snap_slices=snap_slices, return_events=True, device=dev)
        w = policy_weights(name, x0=scn.x0)
        rule = class_rule(name, n_chips=n_chips, snap_slices=snap_slices, dtype=DTYPE,
                          w=None if w is None else engine.to_loop_order(w, order, ()))
        eng = engine.run(scn.x0, scn.arrival_times, scn.p_job, rule, record=True)
        ok, _ = _compare_events(engine_events(eng, arrivals), allocs_ref)
        chips_ok &= ok
        n_events += len(allocs_ref)
        flows_q = eng.completion_times.cpu().numpy() - arrivals
        worst_q = max(worst_q, float(np.max(np.abs(flows_q - flows_qref) / flows_qref)))
    return {"chips_exact": bool(chips_ok), "n_events": n_events,
            "worst_continuous_flow_rel": worst_cont, "worst_quantized_flow_rel": worst_q}


def stream_oracle_check(*, n_jobs=120, n_slots=24, rate=2.0, p=0.5, n_chips=64, seed=0,
                        device="cuda") -> float:
    """Max relative windowed-mean-flow error of ``engine.run_stream`` (``n_slots``
    recycled slots over an ``n_jobs``-deep tape) against the per-event loop
    on the same tape (``benchmarks/streaming.py``'s ``oracle_check``, bar
    1e-6), both windowed to the middle 80% of the span by arrival time,
    continuous and whole chips; the windowed counts must agree."""
    dev = resolve_device(device)
    arr_np, x_np = stream_trace(n_jobs, rate, seed)
    span = float(arr_np[-1])
    window = (0.1 * span, 0.9 * span)
    in_w = (arr_np >= window[0]) & (arr_np < window[1])
    pol = _policy("hesrpt", n_chips)
    tape = scenarios.tape_from_numpy(x_np, arr_np, device=dev)
    worst = 0.0
    for quantize in (False, True):
        rule = (engine.quantized_rule(pol, n_chips, dtype=DTYPE) if quantize
                else engine.continuous_rule(pol, n_chips, dtype=DTYPE))
        res = engine.run_stream(tape.x0, tape.arrival_times, p, rule, n_slots=n_slots,
                                window=window, n_alone=n_chips)
        flows = run_stream_reference("hesrpt", arr_np, x_np, p=p, n_chips=n_chips,
                                     quantize=quantize, device=dev)
        ref = float(np.mean(flows[in_w]))
        worst = max(worst, abs(float(res.mean_flow) - ref) / ref)
        if int(res.n_window) != int(in_w.sum()):
            raise RuntimeError("windowed completion count disagrees with the oracle tape")
    return worst


def sched_scale(ms=(100, 1_000, 10_000, 100_000), p: float = 0.5, n_chips: int = 4096,
                repeats: int = 5, log: bool = True, device="cuda") -> SweepResult:
    """``benchmarks/sched_scale.py``: one decision epoch at M jobs, heSRPT's
    theta (``policies.hesrpt``, synchronized) and whole chips
    (``sched.quantize.quantize_allocation``) on ``device``, for each M.

    ``stats["hesrpt"]["theta_us"]`` is ``[len(ms), repeats]``, ``quantize_us``
    (one timed call) and ``chips_sum`` are ``[len(ms), 1]``; each is timed
    after a warm-up call at its M.
    The record goes to the in-memory ``sweeps.RUN_LOG`` unless ``log=False``.
    """
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    theta_us = np.zeros((len(ms), repeats))
    quantize_us = np.zeros((len(ms), 1))
    chips_sum = np.zeros((len(ms), 1))
    t_start = time.perf_counter()
    for mi, m in enumerate(ms):
        rng = np.random.default_rng(0)
        x = torch.as_tensor(np.sort(rng.pareto(1.5, m) + 1.0)[::-1].copy(), device=dev)
        theta = policies.hesrpt(x, p)  # warm-up
        sync()
        for r in range(repeats):
            t0 = time.perf_counter()
            theta = policies.hesrpt(x, p)
            sync()
            theta_us[mi, r] = (time.perf_counter() - t0) * 1e6
        quantize_allocation(theta, n_chips)  # warm-up
        sync()
        t0 = time.perf_counter()
        chips = quantize_allocation(theta, n_chips)
        sync()
        quantize_us[mi, 0] = (time.perf_counter() - t0) * 1e6
        chips_sum[mi, 0] = int(chips.sum())
    result = SweepResult(
        spec={"kind": "sched_scale", "ms": list(ms), "p": p, "n_chips": n_chips,
              "repeats": repeats, "policy": "hesrpt"},
        stats={"hesrpt": {"theta_us": theta_us, "quantize_us": quantize_us,
                          "chips_sum": chips_sum}},
        wall_s=time.perf_counter() - t_start, backend=dev.type,
        device_count=torch.cuda.device_count() if dev.type == "cuda" else 1, device=dev,
    )
    if log:
        sweeps.log_record(result.record())
    return result
