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
256 chips, at most 300 jobs x 8 seeds, slices off and on).  That file's
``cross_check`` against ``ClusterScheduler`` needs ``sched/``, which is not
ported.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.multiclass import ClassSpec
from repro_torch.core.sweeps import STREAM_METRICS, Sweep, SweepResult, run_sweep

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
