"""The three canonical sweep lanes of the heSRPT sweep path.

Port of ``benchmarks/backend_lane.py`` (same lanes, same sizes):

- ``quantized`` — whole-chips heSRPT on the unfused engine (plain PyTorch:
  policy, then two stable argsorts to round);
- ``quantized-fused`` — the identical spec through the fused allocate (the
  CUDA kernel on the card, one launch per event for every cell), equal to
  the unfused lane bit for bit;
- ``continuous`` — the paper's divisible regime on the carried-rank loop.

Full size: 24 rates x 8 seeds x 1000 jobs on a 256-chip pool, p = 0.5.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.sweeps import Sweep, SweepResult, run_sweep

RATES_FULL = tuple(float(r) for r in np.geomspace(0.25, 16.0, 24).round(4))
RATES_SMOKE = (0.5, 1.0, 2.0, 4.0, 8.0)
N_CHIPS = 256
LABELS = ("quantized", "quantized-fused", "continuous")


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


def fused_equals_unfused(lanes) -> bool:
    """The fused and unfused quantized lanes agree bit for bit."""
    by_label = dict(lanes)
    q, qf = by_label["quantized"], by_label["quantized-fused"]
    return all(
        np.array_equal(q.stats["hesrpt"][m], qf.stats["hesrpt"][m]) for m in q.spec.metrics
    )
