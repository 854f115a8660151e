"""The port's program spans (``repro_torch/spans.py``) on the CPU.

- With no profiler running, ``span`` and ``add`` record nothing and never
  enter ``record_function``.
- Under ``torch.profiler``, the sweep path records its spans and its step
  counter, whole and chunked, on the fused loop and on the carried-rank
  loop; self times and totals add up; the spans are rows of the profiler's
  own trace, on the clock of the aten ops inside them.
- The class-aware allocate records ``multiclass.theta`` once a step (the
  sweep's rule and the estimating rule) and ``policy.waterfill_iters`` 64
  a water-fill call.
- The profiler moves no result.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.core.sweeps import Sweep, run_sweep  # noqa: E402

M = 8
RATES = (0.5, 4.0)
NAMES = ("sweep", "sweep.draw", "engine.loop", "engine.allocate", "sweep.to_host")


def _spec(path: str) -> Sweep:
    kw = dict(n_chips=16, min_chips=1, fused=True) if path == "fused" else {}
    return Sweep.create(("hesrpt",), RATES, scenario="poisson", n_jobs=M, n_seeds=3,
                        seed=2**33 + 5, p=0.5, n_servers=16.0, **kw)


def _traced(fn):
    """``fn()`` under the CPU profiler: its result, the span snapshot and the
    profiler's events."""
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    snap = spans.snapshot()
    spans.reset()
    return out, snap, prof.profiler.kineto_results.events()


def _refuse(*a, **k):
    raise AssertionError("record_function entered with no profiler running")


def test_without_a_profiler_nothing_is_recorded(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    spans.reset()
    with spans.span("a"):
        with spans.span("b"):
            spans.add("c", 3)
    run_sweep(_spec("fused"), log=False, device="cpu")
    assert spans.snapshot() == {"spans": {}, "counters": {}}


def test_the_gate_hands_out_one_shared_no_op():
    assert spans.span("a") is spans.span("b")


@pytest.mark.parametrize("path", ["fused", "continuous"])
def test_a_sweep_records_its_spans_and_steps(path):
    _, snap, _ = _traced(lambda: run_sweep(_spec(path), log=False, device="cpu"))
    counts = {name: row["count"] for name, row in snap["spans"].items()}
    assert counts == {"sweep": 1, "sweep.draw": 1, "engine.loop": 1,
                      "engine.allocate": 2 * M, "sweep.to_host": 1}
    assert snap["counters"] == {"engine.steps": 2 * M}


@pytest.mark.parametrize("path", ["fused", "continuous"])
def test_a_chunked_sweep_draws_a_chunk_at_a_time(path):
    _, snap, _ = _traced(lambda: run_sweep(_spec(path), chunk_seeds=1, log=False,
                                           device="cpu"))
    counts = {name: row["count"] for name, row in snap["spans"].items()}
    assert counts == {"sweep": 1, "sweep.draw": 3, "engine.loop": 3,
                      "engine.allocate": 3 * 2 * M, "sweep.to_host": 3}
    assert snap["counters"] == {"engine.steps": 3 * 2 * M}


@pytest.mark.parametrize("path", ["fused", "continuous"])
def test_self_times_and_totals_add_up(path):
    _, snap, _ = _traced(lambda: run_sweep(_spec(path), chunk_seeds=2, log=False,
                                           device="cpu"))
    rows = snap["spans"]
    for row in rows.values():
        assert 0.0 <= row["self_s"] <= row["total_s"]
    children = sum(rows[n]["total_s"] for n in ("sweep.draw", "engine.loop", "sweep.to_host"))
    assert rows["sweep"]["total_s"] >= children
    assert rows["sweep"]["self_s"] == pytest.approx(rows["sweep"]["total_s"] - children,
                                                    abs=1e-9)
    loop, alloc = rows["engine.loop"], rows["engine.allocate"]
    assert loop["total_s"] >= alloc["total_s"]
    assert loop["self_s"] == pytest.approx(loop["total_s"] - alloc["total_s"], abs=1e-9)
    assert alloc["self_s"] == pytest.approx(alloc["total_s"], abs=1e-9)


def test_nesting_and_an_exception_inside_a_span():
    def body():
        with spans.span("outer"):
            with spans.span("inner"):
                pass
            with pytest.raises(ValueError):
                with spans.span("inner"):
                    raise ValueError
            spans.add("n")
            spans.add("n", 4)

    _, snap, _ = _traced(body)
    outer, inner = snap["spans"]["outer"], snap["spans"]["inner"]
    assert outer["count"] == 1 and inner["count"] == 2
    assert outer["self_s"] == pytest.approx(outer["total_s"] - inner["total_s"], abs=1e-9)
    assert snap["counters"] == {"n": 5}
    assert not spans._OPEN


def test_spans_are_rows_of_the_profilers_trace_on_its_clock():
    _, _, events = _traced(lambda: run_sweep(_spec("fused"), log=False, device="cpu"))
    rows = {}
    for e in events:
        rows.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in NAMES:
        assert name in rows, name
    assert len(rows["engine.allocate"]) == 2 * M
    (sweep,), (draw,), (loop,) = rows["sweep"], rows["sweep.draw"], rows["engine.loop"]
    (to_host,) = rows["sweep.to_host"]
    assert sweep[0] <= draw[0] < draw[1] <= loop[0] < loop[1] <= to_host[0] <= sweep[1]
    # The draw's stacking of the seeds' tapes runs inside the draw's row.
    stacks = [r for r in rows["aten::stack"] if draw[0] <= r[0] and r[1] <= draw[1]]
    assert stacks
    for s, e in rows["engine.allocate"]:
        assert loop[0] <= s < e <= loop[1]


@pytest.mark.parametrize("path", ["fused", "continuous"])
def test_the_profiler_moves_no_result(path):
    plain = run_sweep(_spec(path), log=False, device="cpu")
    traced, _, _ = _traced(lambda: run_sweep(_spec(path), log=False, device="cpu"))
    for metric, v in plain.stats["hesrpt"].items():
        assert np.array_equal(v, traced.stats["hesrpt"][metric]), metric


# ------------------------------------------------- the class-aware allocate
def _class_spec() -> Sweep:
    from repro_torch.lanes import class_grid

    return Sweep.create(("waterfill",), RATES, scenario="multiclass_poisson", n_jobs=M,
                        n_seeds=3, seed=2**33 + 7, n_servers=16.0, classes=class_grid(4),
                        metrics=("mean_flowtime", "mean_slowdown", "makespan",
                                 "class_flowtime"))


def test_a_water_filling_sweep_records_one_theta_a_step():
    _, snap, events = _traced(lambda: run_sweep(_class_spec(), log=False, device="cpu"))
    steps = snap["counters"]["engine.steps"]
    assert steps == 2 * M
    theta, alloc = snap["spans"]["multiclass.theta"], snap["spans"]["engine.allocate"]
    assert theta["count"] == alloc["count"] == steps
    assert theta["total_s"] <= alloc["total_s"]
    assert alloc["self_s"] == pytest.approx(alloc["total_s"] - theta["total_s"], abs=1e-9)
    assert snap["counters"]["policy.waterfill_iters"] == 64 * theta["count"]
    assert sum(e.name() == "multiclass.theta" for e in events) == steps


def test_waterfill_iters_count_the_bisection_steps_of_a_call():
    from repro_torch.core.policies import waterfill

    x = torch.rand(5, 7, dtype=torch.float64) + 0.1
    p = torch.full_like(x, 0.6)

    def calls():
        waterfill(x, p, 16.0)
        waterfill(x[:1], p[:1], 16.0)
        waterfill(x, p, 16.0, n_iter=10)

    _, snap, _ = _traced(calls)
    assert snap["counters"] == {"policy.waterfill_iters": 64 + 64 + 10}


def test_the_estimating_class_rule_records_one_theta_a_step():
    from repro_torch.core.multiclass import simulate_multiclass
    from repro_torch.core.sweeps import draw_scenario
    from repro_torch.lanes import class_grid

    scn = draw_scenario(_class_spec(), device="cpu")
    _, snap, _ = _traced(lambda: simulate_multiclass(
        scn, classes=class_grid(4), policy="waterfill", n_servers=16.0, estimator_kw={},
        device="cpu"))
    steps = snap["counters"]["engine.steps"]
    assert snap["spans"]["multiclass.theta"]["count"] == steps == 2 * M
    assert snap["counters"]["policy.waterfill_iters"] == 64 * steps


def test_without_a_profiler_the_class_path_records_nothing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    spans.reset()
    run_sweep(_class_spec(), log=False, device="cpu")
    assert spans.snapshot() == {"spans": {}, "counters": {}}


def test_the_profiler_moves_no_class_answer():
    plain = run_sweep(_class_spec(), log=False, device="cpu")
    traced, _, _ = _traced(lambda: run_sweep(_class_spec(), log=False, device="cpu"))
    for metric, v in plain.stats["waterfill"].items():
        assert np.array_equal(v, traced.stats["waterfill"][metric], equal_nan=True), metric
