"""The program's own span and counter aggregates over a traced window, for
the per-layer readers whose ``source`` is ``program_span``.

The port records them (``repro_torch/spans.py``) only while a profiler
runs, so after a ``--trace 1`` window they hold that window's units alone:
the warm-up runs before the profiler starts and the check after it stops.
"""


def window(ctx) -> dict | None:
    """``repro_torch.spans.snapshot()`` after a traced window; None without a
    trace, or where the program keeps no spans."""
    if ctx.get("trace") is None:
        return None
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans.snapshot()


def _ratio(row, field, n):
    return None if row is None or not n else row[field] / n


def per_grid(ctx, span: str) -> float | None:
    """Seconds of ``span`` a grid: its total over the count of ``sweep``
    spans.  None where the window recorded either nothing."""
    snap = window(ctx)
    if snap is None:
        return None
    return _ratio(snap["spans"].get(span), "total_s",
                  snap["spans"].get("sweep", {}).get("count"))


def per_step(ctx, span: str, field: str) -> float | None:
    """Seconds of ``span``'s ``field`` (``total_s`` or ``self_s``) an event
    step: over the counter ``engine.steps``.  None where the window recorded
    either nothing."""
    snap = window(ctx)
    if snap is None:
        return None
    return _ratio(snap["spans"].get(span), field, snap["counters"].get("engine.steps"))
