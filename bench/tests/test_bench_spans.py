"""The four readers of the program's spans (``bench/metrics/draw_ms.py``,
``to_host_ms.py``, ``loop_host_us.py``, ``alloc_host_us.py``) on hand-made
aggregates and on a traced window of each sweep cell at a CPU size."""

import sys
import time

import pytest
import torch

from bench import harness

SPAN_METRICS = ("draw_ms", "to_host_ms", "loop_host_us", "alloc_host_us")
CPU = torch.device("cpu")

#: Two grids of 10 event steps each.
SNAPSHOT = {
    "spans": {
        "sweep": {"count": 2, "total_s": 1.0, "self_s": 0.1},
        "sweep.draw": {"count": 2, "total_s": 0.4, "self_s": 0.4},
        "sweep.to_host": {"count": 2, "total_s": 0.1, "self_s": 0.1},
        "engine.loop": {"count": 2, "total_s": 0.4, "self_s": 0.3},
        "engine.allocate": {"count": 20, "total_s": 0.1, "self_s": 0.1},
    },
    "counters": {"engine.steps": 20},
}
WANT = {"draw_ms": 200.0, "to_host_ms": 50.0, "loop_host_us": 15000.0,
        "alloc_host_us": 5000.0}


def read(name, ctx):
    return harness.load_reader(name).read(ctx)


@pytest.fixture
def snapshot(monkeypatch):
    from repro_torch import spans

    snap = {"spans": dict(SNAPSHOT["spans"]), "counters": dict(SNAPSHOT["counters"])}
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    return snap


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_readers_on_a_snapshot(name, snapshot):
    assert read(name, {"trace": {}}) == pytest.approx(WANT[name])
    assert read(name, {"trace": None}) is None
    assert read(name, {}) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_readers_without_their_spans(name, snapshot):
    snapshot["spans"].clear()
    snapshot["counters"].clear()
    assert read(name, {"trace": {}}) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_readers_of_a_program_without_spans(name, monkeypatch):
    # A program that keeps no spans (no repro_torch.spans): nothing to read.
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert read(name, {"trace": {}}) is None


@pytest.mark.parametrize("cell", ["online-n256.fused", "online-n256.continuous"])
def test_both_cells_report_the_four(cell):
    per_layer = {m["name"]: m for m in harness.load_cell(cell).per_layer}
    for name in SPAN_METRICS:
        m = per_layer[name]
        assert m["source"] == "program_span" and m["moves"] == "jobs_per_s"
        assert "workloads" not in m


@pytest.mark.parametrize("cell", ["online-n256.fused", "online-n256.continuous"])
def test_a_traced_window_counts_the_drivers_steps(cell):
    from repro_torch import spans

    small = harness.load_cell(cell, config={"rates": [0.5, 4.0], "n_jobs": 12},
                              traffic={"n_seeds": 3, "check_seeds": 3})
    work = harness.load_driver(small.driver).prepare(small, 2**31 + 3, CPU)
    spans.reset()
    win = harness.measure(work, 0.05, True, CPU, time.perf_counter())
    snap = spans.snapshot()
    n = len(win.outputs)
    assert snap["counters"]["engine.steps"] == win.ctx["steps"] == n * 2 * 12
    assert snap["spans"]["sweep"]["count"] == n
    assert snap["spans"]["engine.allocate"]["count"] == win.ctx["steps"]
    got = harness.read_per_layer(small, win.ctx)
    for name in SPAN_METRICS:
        assert got[name]["value"] > 0
    # Untraced, the warm-up and the window record nothing.
    spans.reset()
    harness.measure(work, 0.01, False, CPU, time.perf_counter())
    assert spans.snapshot() == {"spans": {}, "counters": {}}
