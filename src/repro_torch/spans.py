"""The port's program spans and counters, recorded only while a
``torch.profiler`` runs.

``span(name)`` marks one layer's part of the work, ``add(name, n)`` counts
work at the same boundary.  While no profiler runs, ``span`` returns one
shared no-op context after a single flag read and ``add`` returns at once:
nothing is recorded and no ``record_function`` is entered, so a span costs
a call where the program runs untraced.  While a profiler runs, a span
enters ``torch.profiler.record_function(name)``, which puts it on the
profiler's clock beside the device's kernels (an exported Chrome trace shows
each idle gap under the span that was open), and adds its host time
(``time.perf_counter_ns``) to an aggregate by name: how many times it
closed, its total, and its self time, the total less that of the program
spans directly inside it.

The per-span log is the profiler's trace; this module keeps aggregates only:
:func:`snapshot` reads them, :func:`reset` clears them.  There is no other
switch: a profiler's window records exactly its own work.

Names are ``<module>.<part>``.  The sweep path's:

- ``sweep``: one :func:`core.sweeps.run_sweep` (its count is the grids run);
- ``sweep.draw``: the draw of a chunk's tapes (``draw_scenario``);
- ``sweep.to_host``: a policy column's results copied to the host, which
  waits for the device's queue to drain;
- ``engine.loop``: one event loop (``engine.run`` / ``engine.run_ranked``),
  from its set-up to the un-sort;
- ``engine.allocate``: one step's allocation, the rule or the rank policy;
- counter ``engine.steps``: the event steps those loops ran;
- counter ``engine.step_kernel``: the steps of ``engine.run`` that launched
  the event-step kernel (``kernels/event_step.py``), ``E`` a run on the
  card; over ``engine.steps``, the share of steps it covers.

The class-aware allocate's (inside ``engine.allocate``):

- ``multiclass.theta``: one step's class-aware shares, the ``class_theta``
  call of ``core.multiclass.class_rule`` or of
  ``core.estimation.estimating_class_rule``;
- counter ``policy.waterfill_iters``: the bisection steps of the water
  level, ``n_iter`` once a ``core.policies.waterfill`` call, whatever its
  rows.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["add", "reset", "snapshot", "span"]

_NOOP = contextlib.nullcontext()

#: name -> [count, total_ns, self_ns]
_SPANS: dict[str, list] = {}
_COUNTERS: dict[str, int] = {}
#: The open spans, innermost last: each its [start_ns, child_ns].
_OPEN: list[list] = []


class _Span:
    __slots__ = ("name", "range")

    def __init__(self, name: str):
        self.name = name
        self.range = torch.profiler.record_function(name)

    def __enter__(self):
        self.range.__enter__()
        _OPEN.append([time.perf_counter_ns(), 0])

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        start, child = _OPEN.pop()
        total = end - start
        if _OPEN:
            _OPEN[-1][1] += total
        row = _SPANS.setdefault(self.name, [0, 0, 0])
        row[0] += 1
        row[1] += total
        row[2] += total - child
        return self.range.__exit__(*exc)


def span(name: str):
    """A context over one part of the work named ``name``; a shared no-op
    while no profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name)


def add(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


def snapshot() -> dict:
    """``{"spans": {name: {"count", "total_s", "self_s"}}, "counters":
    {name: int}}`` of everything recorded since the last :func:`reset`."""
    return {
        "spans": {name: {"count": c, "total_s": t * 1e-9, "self_s": s * 1e-9}
                  for name, (c, t, s) in _SPANS.items()},
        "counters": dict(_COUNTERS),
    }


def reset() -> None:
    """Clear the aggregates (a span still open keeps its place)."""
    _SPANS.clear()
    _COUNTERS.clear()
