"""In-loop telemetry probes: per-event derived metrics of every cell.

Port of ``repro.core.telemetry``.  A probe rides the engine's event loop
(``engine.run(telemetry=)``, ``run_stream``, ``run_stream_source``) and
derives, at every epoch and for every cell row at once:

- ``efficiency`` — the paper's system efficiency ``sum theta_i^p``;
- ``utilization`` — the allocated fraction of the system, ``sum theta_i``;
- ``queue`` — the active-job count;
- ``entropy`` — ``-sum s_i ln s_i`` of the allocation shares;
- ``p_hat_err`` — ``|p_hat - p|`` of an estimating rule
  (``core/estimation.py``), read from the rule's loop-carried state.

Two modes share one contract (:class:`Probe`) and the same metric functions:
``mode="series"`` keeps every event's value (``[..., E]`` a metric, the
Perfetto exporter's input); ``mode="stream"`` carries O(1) aggregates a
cell: time-weighted means, maxima over positive-length epochs and
time-weighted histograms (one bin a cell an event, a ``scatter_add_`` with
no two adds on one element, so it is deterministic), optionally restricted
to a stationary window.  A probe never touches the trajectory: the loop
runs the same ops with or without it.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from typing import Any, NamedTuple

import torch

from repro_torch.core.analysis import system_efficiency

#: Metrics every probe derives from a ``ProbeEvent``; ``p_hat_err`` also
#: needs the estimating-rule reader (:func:`p_hat_error_metric`).
METRICS = ("efficiency", "utilization", "queue", "entropy", "p_hat_err")

#: The default metric set (``p_hat_err`` is opt-in).
DEFAULT_METRICS = ("efficiency", "utilization", "queue", "entropy")


class Probe(NamedTuple):
    """The engine-facing probe contract ``(init, step, finalize)``.

    ``init(lead, device)`` builds the carried accumulators for the cells of
    lead shape ``lead`` (``C = prod(lead)`` rows); ``step(state, ev)`` folds
    one ``engine.ProbeEvent`` and returns ``(state, per_event_out)``
    (``()`` in stream mode); ``finalize(state, outs, lead)`` shapes the
    read-out back to the cells' lead dims.  Build with :func:`make_probe`.
    """

    init: Callable[[tuple, torch.device], Any]
    step: Callable[[Any, Any], tuple[Any, Any]]
    finalize: Callable[[Any, Any, tuple], Any]


class TelemetryResult(NamedTuple):
    """What a probe hands back on ``EngineResult.telemetry``.

    Exactly one of ``series`` / ``aggregates`` is set (by mode).  ``series``
    maps ``"t"`` / ``"dt"`` and each metric to ``[..., E]`` tensors (no-op
    tail epochs carry ``dt == 0``); ``aggregates`` maps ``"time"`` and, per
    metric ``m``, ``"{m}_mean"`` (time-weighted), ``"{m}_max"`` (``[...]``)
    and ``"{m}_hist"`` (``[..., bins]``); ``hist_edges`` the ``[bins + 1]``
    bin edges of each metric in stream mode.
    """

    series: dict[str, torch.Tensor] | None
    aggregates: dict[str, torch.Tensor] | None
    hist_edges: dict[str, torch.Tensor] | None


def _true_p_scalar(ev) -> Any:
    """The truth an estimator is judged against, one value a cell row.

    A float, a 0-dim tensor or a ``[C, 1]`` column (a drifting ``p``, one
    regime a row) is the row's exponent as it stands, also on an epoch with
    no active job; a per-job exponent (``ev.p_per_job``, set by the loop
    where ``p`` came per job) gives the active-job mean, 0 on an epoch with
    no active job, as the reference gives.  The source decides, not the
    shape: at ``M == 1`` a per-job ``p`` and a column look alike.
    """
    p = ev.p
    if not ev.p_per_job:
        return p
    n = ev.active.sum(-1, keepdim=True).clamp(min=1)
    return torch.where(ev.active, p, 0.0).sum(-1, keepdim=True) / n


def p_hat_error_metric(prior_p, *, prior_weight=1.0) -> Callable:
    """Reader for the ``p_hat_err`` metric under ``estimating_rule``: the
    blended p-hat the rule allocates with, recomputed from the rule state on
    the probe event, against the *current* true exponent (under drift, the
    regime in effect)."""
    from repro_torch.core.estimation import blended_p_hat

    def err(ev):
        x_act = torch.where(ev.active, ev.x, 0.0)
        p_hat = blended_p_hat(ev.rule_state, x_act, prior_p, prior_weight=prior_weight)
        return (p_hat - _true_p_scalar(ev)).abs()

    return err


def _metric_fns(metrics, alloc_unit: float, p_hat_reader: Callable | None) -> dict:
    """Bind the metric functions, each ``(ProbeEvent, memo) -> [C, 1]``;
    ``alloc_unit`` turns the event's allocation into theta shares (1.0 for
    continuous rules, ``n_chips`` for quantized ones).  ``memo`` is one
    event's cache: theta and its row sum are computed once an event for
    every metric that reads them (the same values each would compute)."""

    def theta_of(ev, memo):
        if "theta" not in memo:
            memo["theta"] = ev.alloc.to(ev.x.dtype) / alloc_unit
        return memo["theta"]

    def total_of(ev, memo):
        if "total" not in memo:
            memo["total"] = theta_of(ev, memo).sum(-1, keepdim=True)
        return memo["total"]

    def efficiency(ev, memo):
        return system_efficiency(theta_of(ev, memo), ev.p).unsqueeze(-1)

    def queue(ev, memo):
        return ev.active.sum(-1, keepdim=True).to(ev.x.dtype)

    def entropy(ev, memo):
        th = theta_of(ev, memo)
        s = th / total_of(ev, memo).clamp(min=torch.finfo(th.dtype).tiny)
        pos = s > 0
        return -torch.where(pos, s * torch.where(pos, s, 1.0).log(), 0.0).sum(-1, keepdim=True)

    fns = {"efficiency": efficiency, "utilization": total_of, "queue": queue,
           "entropy": entropy}
    out = {}
    for name in metrics:
        if name == "p_hat_err":
            if p_hat_reader is None:
                raise ValueError(
                    "metric 'p_hat_err' needs p_hat_reader= (built with "
                    "p_hat_error_metric; only meaningful under an estimating rule)"
                )
            out[name] = lambda ev, memo: p_hat_reader(ev)
        elif name in fns:
            out[name] = fns[name]
        else:
            raise ValueError(f"unknown telemetry metric {name!r}; known: {METRICS}")
    return out


def default_hist_ranges(n_jobs: int) -> dict[str, tuple[float, float]]:
    """Histogram supports per metric, sized to the job count (efficiency's
    bound ``m^(1-p)`` taken at ``p = 0.5``; values outside a range clip into
    the edge bins, they are never dropped)."""
    m = max(int(n_jobs), 1)
    return {
        "efficiency": (0.0, float(m) ** 0.5),
        "utilization": (0.0, 1.0),
        "queue": (0.0, float(m)),
        "entropy": (0.0, math.log(max(m, 2))),
        "p_hat_err": (0.0, 1.0),
    }


def _lead_rows(v, lead, dtype, device) -> torch.Tensor:
    """A window bound as a 0-dim tensor, or as a ``[C, 1]`` column where it
    broadcasts over the cells' lead dims (a sweep's window differs by rate)."""
    v = torch.as_tensor(v, dtype=dtype, device=device)
    return v if v.ndim == 0 else v.expand(lead).reshape(-1, 1)


def make_probe(
    metrics=DEFAULT_METRICS,
    *,
    mode: str = "stream",
    alloc_unit: float = 1.0,
    n_jobs: int | None = None,
    hist_bins: int = 32,
    hist_ranges: dict[str, tuple[float, float]] | None = None,
    p_hat_reader: Callable | None = None,
    window=None,
    dtype=torch.float64,
) -> Probe:
    """Build a :class:`Probe` for ``engine.run(telemetry=)`` and the stream
    loops.

    ``metrics`` is an ordered subset of :data:`METRICS`; ``alloc_unit`` is
    1.0 for continuous rules and ``n_chips`` for quantized ones.
    ``mode="series"`` keeps ``[..., E]`` values a metric; ``mode="stream"``
    carries O(1) aggregates a cell (``n_jobs`` sizes the default histogram
    supports, ``hist_ranges`` overrides any).  ``dtype`` is the accumulators'
    (the engine's float64).

    ``window=(lo, hi)`` (stream mode; floats, or tensors broadcasting over
    the cells' lead dims) weights each epoch by ``|[t, t + dt) & [lo, hi)|``
    instead of ``dt``, so means, maxima and histogram mass describe the
    window only.
    """
    metrics = tuple(metrics)
    if mode not in ("series", "stream"):
        raise ValueError(f"mode must be 'series' or 'stream', not {mode!r}")
    if window is not None and mode != "stream":
        raise ValueError("window= is stream-mode only (a series is windowed host-side)")
    fns = _metric_fns(metrics, float(alloc_unit), p_hat_reader)

    if mode == "series":

        def init_series(lead, device):
            return ()

        def step_series(state, ev):
            memo: dict = {}
            vals = tuple(fns[m](ev, memo).to(dtype) for m in metrics)
            return state, (ev.t.to(dtype), ev.dt.to(dtype), *vals)

        def finalize_series(state, outs, lead):
            cols = [torch.cat(list(col), -1).reshape(*lead, -1) for col in zip(*outs)]
            series = dict(zip(("t", "dt", *metrics), cols))
            return TelemetryResult(series=series, aggregates=None, hist_edges=None)

        return Probe(init=init_series, step=step_series, finalize=finalize_series)

    if n_jobs is None:
        raise ValueError("mode='stream' needs n_jobs (default hist supports)")
    ranges = dict(default_hist_ranges(n_jobs))
    ranges.update(hist_ranges or {})
    B = int(hist_bins)

    def init_stream(lead, device):
        C = math.prod(lead)
        state: dict[str, Any] = {"t_sum": torch.zeros((C, 1), dtype=dtype, device=device)}
        if window is not None:
            state["window"] = tuple(_lead_rows(w, lead, dtype, device) for w in window)
        for m in metrics:
            state[m] = {
                "wsum": torch.zeros((C, 1), dtype=dtype, device=device),
                "max": torch.full((C, 1), -torch.inf, dtype=dtype, device=device),
                "hist": torch.zeros((C, B), dtype=dtype, device=device),
            }
        return state

    def step_stream(state, ev):
        dt = ev.dt.to(dtype)
        if window is not None:  # the overlap of [t, t + dt) with the window
            w_lo, w_hi = state["window"]
            t_ev = ev.t.to(dtype)
            dt = (torch.minimum(t_ev + dt, w_hi) - torch.maximum(t_ev, w_lo)).clamp(min=0.0)
        live = dt > 0  # no-op tail epochs and zero-length arrival batches
        state["t_sum"] = state["t_sum"] + dt
        memo: dict = {}
        for m in metrics:
            v = fns[m](ev, memo).to(dtype)
            lo, hi = ranges[m]
            span = max(hi - lo, 1e-12)
            vb = torch.where(live, v, lo)  # keeps the index finite on no-ops
            b = ((vb - lo) / span * B).to(torch.int64).clamp(0, B - 1)
            s = state[m]
            s["wsum"] = s["wsum"] + v * dt
            s["max"] = torch.maximum(s["max"], torch.where(live, v, -torch.inf))
            s["hist"].scatter_add_(-1, b, dt)  # one bin a row: no two adds meet
        return state, ()

    def finalize_stream(state, outs, lead):
        t = state["t_sum"]
        agg: dict[str, torch.Tensor] = {"time": t.reshape(lead)}
        edges: dict[str, torch.Tensor] = {}
        for m in metrics:
            s = state[m]
            agg[f"{m}_mean"] = (s["wsum"] / t.clamp(min=torch.finfo(dtype).tiny)).reshape(lead)
            mx = s["max"]
            agg[f"{m}_max"] = torch.where(torch.isfinite(mx), mx, 0.0).reshape(lead)
            agg[f"{m}_hist"] = s["hist"].reshape(*lead, B)
            lo, hi = ranges[m]
            edges[m] = torch.linspace(lo, hi, B + 1, dtype=dtype, device=t.device)
        return TelemetryResult(series=None, aggregates=agg, hist_edges=edges)

    return Probe(init=init_stream, step=step_stream, finalize=finalize_stream)


def scalar_columns(metrics) -> tuple[str, ...]:
    """The per-cell sweep columns a stream probe contributes: the
    time-weighted mean and the max of each metric (histograms stay out)."""
    names: list[str] = []
    for m in tuple(metrics):
        names.append(f"tel_{m}_mean")
        names.append(f"tel_{m}_max")
    return tuple(names)


def scalar_values(tel: TelemetryResult, metrics) -> tuple[torch.Tensor, ...]:
    """The values matching :func:`scalar_columns`, from a stream result."""
    if tel.aggregates is None:
        raise ValueError("scalar_values needs a stream-mode TelemetryResult")
    out: list[torch.Tensor] = []
    for m in tuple(metrics):
        out.append(tel.aggregates[f"{m}_mean"])
        out.append(tel.aggregates[f"{m}_max"])
    return tuple(out)


__all__ = [
    "DEFAULT_METRICS",
    "METRICS",
    "Probe",
    "TelemetryResult",
    "default_hist_ranges",
    "make_probe",
    "p_hat_error_metric",
    "scalar_columns",
    "scalar_values",
]
