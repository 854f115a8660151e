"""Host ops an event step costs in the port's loops, with and without a probe.

``PYTHONPATH=src python tools/torch_step_ops.py`` from the repo root runs,
on the CPU at the smoke size (the fused allocate takes its plain version
there), the fused lane through ``engine.run``, the fused stream lane through
``engine.run_stream`` (16 slots, a window), and continuous heSRPT with and
without the estimating rule, each under ``torch.profiler``, and prints the
top-level aten ops a step (views included): what a probe or the estimator
adds to the host's launch stream, the scheduler lanes' bound.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def _ops(fn) -> int:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    evs = [e for e in prof.events() if e.name.startswith("aten::")]
    return sum(1 for e in evs if e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))


def main() -> None:
    from repro_torch import lanes
    from repro_torch.core import engine, estimation, policies, sweeps, telemetry

    spec = dict(lanes.lane_specs(smoke=True))["quantized-fused"]
    M = spec.n_jobs
    scn = sweeps.draw_scenario(spec, device="cpu")
    x, a = scn.x0.reshape(-1, M), scn.arrival_times.reshape(-1, M)
    rule = engine.quantized_rule(policies.hesrpt, spec.n_chips)
    probe = telemetry.make_probe(telemetry.DEFAULT_METRICS, alloc_unit=spec.n_chips, n_jobs=M)
    rows = {
        "fused lane": _ops(lambda: engine.run(x, a, spec.p, rule, fused=True)) / (2 * M),
        "fused lane + probe": _ops(lambda: engine.run(x, a, spec.p, rule, fused=True,
                                                      telemetry=probe)) / (2 * M),
    }
    sspec = dict(lanes.stream_lane_specs(smoke=True))["stream-quantized-fused"]
    T, S = sspec.n_jobs, dict(sspec.stream)["n_slots"]
    sscn = sweeps.draw_scenario(sspec, device="cpu")
    sx, sa = sscn.x0.reshape(-1, T), sscn.arrival_times.reshape(-1, T)
    window = (10.0, 90.0)
    sprobe = telemetry.make_probe(telemetry.DEFAULT_METRICS, alloc_unit=spec.n_chips,
                                  n_jobs=S, window=window)
    kw = dict(n_slots=S, fused=True, window=window)
    rows["fused stream lane"] = _ops(lambda: engine.run_stream(sx, sa, 0.5, rule, **kw)) / (2 * T)
    rows["fused stream lane + probe"] = _ops(lambda: engine.run_stream(
        sx, sa, 0.5, rule, telemetry=sprobe, **kw)) / (2 * T)
    crule = engine.continuous_rule(policies.hesrpt, 256.0)
    erule = estimation.estimating_rule(policies.hesrpt, 256.0, prior_p=0.8, n_jobs=M,
                                       device="cpu")
    rows["continuous heSRPT (generic loop)"] = _ops(lambda: engine.run(x, a, 0.5, crule)) / (2 * M)
    rows["estimating rule"] = _ops(lambda: engine.run(x, a, 0.5, erule)) / (2 * M)
    for label, n in rows.items():
        print(f"{label:>34s}: {n:6.1f} aten ops a step")


if __name__ == "__main__":
    main()
