"""Chrome trace-event (Perfetto) export of engine schedules.

    PYTHONPATH=src python -m repro_torch.launch.trace_export --out trace.json  # on the card
    PYTHONPATH=src python -m repro_torch.launch.trace_export --device cpu

Port of ``repro.launch.trace_export``: the NumPy event builders, the schema
validator and the writer are copies; :func:`export_sample` runs the torch
engine on a tape drawn from a seeded ``torch.Generator``.  A recorded
trajectory (``engine.run(record=True)``) becomes the Chrome trace-event JSON
that https://ui.perfetto.dev and ``chrome://tracing`` load: one track a job
carrying its allocation Gantt (consecutive epochs with the same allocation
merge into one ``ph="X"`` slice), an instant marker at each completion, and
counter tracks (``ph="C"``) for system efficiency, utilization and queue
length, taken from a ``core/telemetry.py`` series read-out where one is
given, else derived from the trace.

Engine time is abstract (units of work); ``time_scale`` maps it onto the
microsecond ``ts`` axis the format requires (default 1e6: one unit of
simulated time displays as one second).
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

PID = 0  # one process == one simulated cluster
COUNTER_METRICS = ("efficiency", "utilization", "queue", "entropy", "p_hat_err")


# ------------------------------------------------------------- event builders
def _np(v, dtype=None) -> np.ndarray:
    """A tensor (on any device) or array-like as a NumPy array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v) if dtype is None else np.asarray(v, dtype)


def _meta(name: str, args: dict, tid: int | None = None) -> dict:
    ev = {"ph": "M", "pid": PID, "ts": 0, "name": name, "args": args}
    if tid is not None:
        ev["tid"] = tid
    return ev


def schedule_to_events(
    result,
    *,
    alloc_unit: float = 1.0,
    p: float | None = None,
    telemetry_series: dict | None = None,
    time_scale: float = 1e6,
    job_labels: list[str] | None = None,
    process_name: str = "heSRPT schedule",
) -> list[dict]:
    """Convert a one-cell ``EngineResult`` with a recorded trace (``[E, M]``)
    to trace events.

    ``alloc_unit`` is what "the whole cluster" means in the trace's
    allocation numbers — ``n_chips`` for quantized runs, 1.0 for
    continuous theta fractions; slice names and the utilization counter
    are normalized by it.  ``p`` enables the derived efficiency counter
    (sum of (alloc/unit)^p); a ``telemetry_series`` dict (the
    ``mode="series"`` probe read-out, keys ``t``/``dt``/metric names)
    takes precedence for any metric it carries.  ``job_labels`` names the
    per-job tracks (input order); default ``job 3 (x0=5.2)``.
    """
    if result.trace is None:
        raise ValueError("schedule_to_events needs engine.run(record=True)")
    trace = result.trace
    alloc = _np(trace.alloc, np.float64)  # [E, M] arrival-sorted
    times = _np(trace.times, np.float64)  # [E] epoch starts
    sizes = _np(trace.sizes, np.float64)  # [E, M] at epoch start
    order = _np(result.order)
    done_in = _np(result.completion_times, np.float64)  # input order
    done = done_in[order]  # arrival-sorted, matching trace columns
    E, M = alloc.shape

    finite = done[np.isfinite(done)]
    t_end = float(max(times.max(initial=0.0), finite.max(initial=0.0)))
    starts = times
    ends = np.append(times[1:], t_end)

    if job_labels is None:
        job_labels = [
            f"job {int(order[j])} (x0={sizes[0, j]:g})" for j in range(M)
        ]
    else:
        job_labels = [job_labels[int(order[j])] for j in range(M)]

    events: list[dict] = [
        _meta("process_name", {"name": process_name}),
        _meta("process_sort_index", {"sort_index": 0}),
    ]
    for j in range(M):
        events.append(_meta("thread_name", {"name": job_labels[j]}, tid=j))
        events.append(_meta("thread_sort_index", {"sort_index": j}, tid=j))

    # ------------------------------------------------ per-job Gantt slices
    for j in range(M):
        e = 0
        while e < E:
            a = alloc[e, j]
            if a <= 0 or ends[e] <= starts[e]:
                e += 1
                continue
            # merge the run of consecutive epochs holding this allocation
            k = e
            while (
                k + 1 < E
                and alloc[k + 1, j] == a
                and ends[k] > starts[k]  # no-op epochs end a run
            ):
                k += 1
            t0, t1 = starts[e], ends[k]
            if t1 > t0:
                share = a / alloc_unit
                name = (
                    f"{int(round(a))} chips" if alloc_unit != 1.0
                    else f"theta={share:.3f}"
                )
                events.append({
                    "ph": "X", "pid": PID, "tid": j, "name": name,
                    "cat": "alloc",
                    "ts": t0 * time_scale, "dur": (t1 - t0) * time_scale,
                    "args": {
                        "alloc": float(a),
                        "share": float(share),
                        "remaining": float(sizes[e, j]),
                    },
                })
            e = k + 1
        if np.isfinite(done[j]):
            events.append({
                "ph": "i", "pid": PID, "tid": j, "name": "complete",
                "cat": "completion", "s": "t",
                "ts": float(done[j]) * time_scale,
                "args": {"t": float(done[j])},
            })

    # -------------------------------------------------------- counter tracks
    # Derived-from-trace values; a telemetry series overrides per metric.
    live = ends > starts
    derived = {
        "utilization": alloc.sum(axis=1) / alloc_unit,
        "queue": (alloc > 0).sum(axis=1).astype(np.float64),
    }
    if p is not None:
        share = alloc / alloc_unit
        derived["efficiency"] = np.where(share > 0, share**p, 0.0).sum(axis=1)
    series_t = starts
    counters: dict[str, np.ndarray] = dict(derived)
    if telemetry_series is not None:
        tel_live = _np(telemetry_series["dt"], np.float64) > 0
        for m in COUNTER_METRICS:
            if m in telemetry_series:
                counters[m] = _np(telemetry_series[m], np.float64)
        # the probe ran inside the same loop: epoch axes line up
        if len(next(iter(counters.values()))) == len(tel_live):
            live = tel_live
            series_t = _np(telemetry_series["t"], np.float64)
    for m in COUNTER_METRICS:
        if m not in counters:
            continue
        vals = counters[m]
        for e in range(E):
            if not live[e]:
                continue
            events.append({
                "ph": "C", "pid": PID, "name": m, "cat": "telemetry",
                "ts": float(series_t[e]) * time_scale,
                "args": {m: float(vals[e])},
            })
        # flat-line the counter out to the end of the schedule
        events.append({
            "ph": "C", "pid": PID, "name": m, "cat": "telemetry",
            "ts": t_end * time_scale, "args": {m: 0.0},
        })
    return events


# ---------------------------------------------------------------- validation
_REQUIRED: dict[str, tuple[str, ...]] = {
    "X": ("name", "tid", "dur"),
    "i": ("name", "tid", "s"),
    "C": ("name", "args"),
    "M": ("name", "args"),
}


def validate_trace_events(events) -> None:
    """Schema-check a trace-event list; raises ``ValueError`` on the first
    malformed event.  Covers what Perfetto/catapult require to load: the
    per-phase mandatory keys, finite numeric timestamps, non-negative
    durations, and numeric counter values."""
    if not isinstance(events, list) or not events:
        raise ValueError("trace must be a non-empty list of event dicts")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not a dict")
        ph = ev.get("ph")
        if ph not in _REQUIRED:
            raise ValueError(f"event {i}: unsupported ph {ph!r}")
        missing = [k for k in ("pid", "ts", *_REQUIRED[ph]) if k not in ev]
        if missing:
            raise ValueError(f"event {i} (ph={ph}): missing keys {missing}")
        ts = ev["ts"]
        if not isinstance(ts, int | float) or not math.isfinite(ts) or ts < 0:
            raise ValueError(f"event {i}: bad ts {ts!r}")
        if ph == "X":
            dur = ev["dur"]
            if not isinstance(dur, int | float) or not (dur >= 0):
                raise ValueError(f"event {i}: bad dur {dur!r}")
        if ph == "C":
            args = ev["args"]
            if not args or not all(
                isinstance(v, int | float) and math.isfinite(v)
                for v in args.values()
            ):
                raise ValueError(f"event {i}: counter args must be numbers")
    json.dumps(events)  # must be serializable as-is


def write_trace(events: list[dict], path: str) -> None:
    """Validate and write the Perfetto-loadable JSON object form."""
    validate_trace_events(events)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f, indent=1)
        f.write("\n")


# ----------------------------------------------------------------------- CLI
def export_sample(
    *,
    policy: str = "hesrpt",
    scenario: str = "poisson",
    n_jobs: int = 12,
    rate: float = 2.0,
    p: float = 0.5,
    n_chips: int | None = None,
    seed: int = 0,
    device="cuda",
) -> list[dict]:
    """Draw one scenario on ``device``, run it recorded and probed (a series
    probe of the default metrics), return its trace events.  A rule that
    has a fused allocate (heSRPT) runs it: the alloc kernel on the card,
    chip for chip the unfused rule's."""
    from repro_torch.core import engine
    from repro_torch.core.policies import make_policy
    from repro_torch.core.scenarios import make_scenario, seed_generator
    from repro_torch.core.telemetry import DEFAULT_METRICS, make_probe

    scn = make_scenario(scenario, p=p)(seed_generator(seed, 0, device=device), n_jobs, rate)
    pol = make_policy(policy)
    if n_chips is not None:
        rule = engine.quantized_rule(pol, n_chips)
    else:
        rule = engine.continuous_rule(pol, 1.0)
    unit = float(n_chips) if n_chips is not None else 1.0
    probe = make_probe(DEFAULT_METRICS, mode="series", alloc_unit=unit)
    res = engine.run(scn.x0, scn.arrival_times, p, rule, record=True,
                     fused=hasattr(rule, "fused_variant"), telemetry=probe)
    return schedule_to_events(
        res,
        alloc_unit=unit,
        p=p,
        telemetry_series=res.telemetry.series,
        process_name=f"{policy} / {scenario} (M={n_jobs}, p={p})",
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="export an engine schedule as Perfetto trace JSON"
    )
    ap.add_argument("--out", default="schedule_trace.json")
    ap.add_argument("--policy", default="hesrpt")
    ap.add_argument("--scenario", default="poisson")
    ap.add_argument("--jobs", type=int, default=12)
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--p", type=float, default=0.5)
    ap.add_argument("--n-chips", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    events = export_sample(
        policy=args.policy, scenario=args.scenario, n_jobs=args.jobs,
        rate=args.rate, p=args.p, n_chips=args.n_chips, seed=args.seed,
        device=args.device,
    )
    write_trace(events, args.out)
    n_slices = sum(1 for e in events if e["ph"] == "X")
    print(
        f"wrote {args.out}: {len(events)} events ({n_slices} slices) — "
        f"load at https://ui.perfetto.dev"
    )


if __name__ == "__main__":
    main()
