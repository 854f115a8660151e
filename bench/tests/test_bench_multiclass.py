"""The water-filling cell (``multiclass-k4.waterfill``): its plain reference
against formulations that share no code with it (a two-job optimum found in
plain Python, the KKT condition), the reference's draw against the port's,
the port against the reference at a tiny size on the CPU, the float32
control against the limits, the faults that ``correct`` has to catch, and
the two readers of the class-aware allocate.  The ``cuda`` test reads the
program and the control at the cell's own size on a card."""

import math
import sys
import time

import numpy as np
import pytest
import torch

from bench import harness
from bench.reference import multiclass, tapes

CPU = torch.device("cpu")
CELL = "multiclass-k4.waterfill"
N = 256.0
#: The class grid of the configuration, as rows of fields.
CLASSES = harness.load_cell(CELL).config["classes"]


def small_cell(**traffic):
    """K = 4, 3 rates x 2 seeds x 40 jobs, every seed checked."""
    return harness.load_cell(CELL, config={"n_jobs": 40},
                             traffic={"n_seeds": 2, "check_seeds": 2, **traffic})


def run_small(cell, seed=2**31 + 11, trace=False):
    return harness.run_cell(cell, seed, 0.05, trace, CPU, time.perf_counter())


# ------------------------------------------------------------ water-filling
def _objective(theta, x, p, w):
    return sum(wi / xi * (ti * N) ** pi for ti, xi, pi, wi in zip(theta, x, p, w))


def _two_job_optimum(x, p, w):
    """The share of job 0 where the marginal gains of two jobs meet, found
    by bisection on the share itself in plain Python floats."""
    def excess(t):  # job 0's marginal gain less job 1's; falls in t
        return (w[0] * p[0] * N ** p[0] * t ** (p[0] - 1) / x[0]
                - w[1] * p[1] * N ** p[1] * (1 - t) ** (p[1] - 1) / x[1])
    lo, hi = 0.0, 1.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if mid in (lo, hi):
            break
        lo, hi = (mid, hi) if excess(mid) > 0 else (lo, mid)
    return 0.5 * (lo + hi)


@pytest.mark.parametrize(("x", "w"), [((1.0, 1.0), (1.0, 1.0)), ((3.7, 0.2), (1.0, 1.0)),
                                      ((0.05, 40.0), (1.0, 2.0)), ((12.0, 12.0), (3.0, 0.5)),
                                      ((1e-3, 1e3), (1.0, 1.0))])
def test_two_jobs_of_two_classes_meet_the_optimum(x, w):
    p = (CLASSES[0]["p"], CLASSES[3]["p"])
    theta = multiclass.waterfill(torch.tensor([x], dtype=torch.float64),
                                 torch.tensor([p], dtype=torch.float64),
                                 torch.tensor([w], dtype=torch.float64), N)[0].tolist()
    want = _two_job_optimum(x, p, w)
    assert theta[0] == pytest.approx(want, rel=1e-12, abs=1e-15)
    assert theta[0] + theta[1] == pytest.approx(1.0, abs=1e-15)
    best = max(_objective((t, 1 - t), x, p, w) for t in np.linspace(0.0, 1.0, 10001))
    assert _objective(theta, x, p, w) >= best * (1 - 1e-14)


def _rows(seed, C=16, M=60):
    """Rows of jobs of the four classes, with idle slots, one row empty and
    one row of a single job; per-job weights drawn over [0.5, 4)."""
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 4, (C, M), generator=gen)
    p = torch.tensor([c["p"] for c in CLASSES], dtype=torch.float64)[ids]
    x = torch.rand((C, M), generator=gen, dtype=torch.float64) ** -2.0
    x = torch.where(torch.rand((C, M), generator=gen) < 0.3, 0.0, x)
    x[0] = 0.0
    x[1, 0], x[1, 1:] = 2.0, 0.0
    w = 0.5 + 3.5 * torch.rand((C, M), generator=gen, dtype=torch.float64)
    return x, p, w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_shares_meet_the_kkt_condition(seed):
    x, p, w = _rows(seed)
    theta = multiclass.waterfill(x, p, w, N)
    active = x > 0
    assert torch.all(theta[~active] == 0.0) and torch.all(theta[active] > 0.0)
    assert torch.all(theta[0] == 0.0) and theta[1, 0] == 1.0
    for r in range(2, x.shape[0]):
        a = active[r]
        assert float(theta[r].sum()) == pytest.approx(1.0, abs=1e-12)
        gain = w[r, a] * p[r, a] * N ** p[r, a] * theta[r, a] ** (p[r, a] - 1) / x[r, a]
        assert float(gain.max() / gain.min()) - 1.0 <= 1e-12


@pytest.mark.parametrize("seed", [3, 4])
def test_the_programs_water_fill_meets_the_reference(seed):
    from repro_torch.core.policies import waterfill

    x, p, w = _rows(seed)
    want = multiclass.waterfill(x, p, w, N)
    got = waterfill(x, p, N, w)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-300)


def test_tapes_are_the_ports():
    from repro_torch.core.sweeps import Sweep, draw_scenario

    rates = [0.5, 2.0, 8.0]
    spec = Sweep.create(("waterfill",), rates, scenario="multiclass_poisson", n_jobs=50,
                        n_seeds=3, seed=2**33 + 1, n_servers=N,
                        classes=CLASSES)
    scn = draw_scenario(spec, device="cpu")
    for s in range(3):
        x, a, ids = multiclass.draw(tapes.seed_generator(spec.seed, s, CPU), rates, 50, CLASSES)
        assert torch.equal(x, scn.x0[:, s]) and torch.equal(a, scn.arrival_times[:, s])
        assert torch.equal(ids, scn.class_ids[:, s])
    assert len(set(ids[0].tolist())) == 4


def test_one_job_alone_runs_at_its_full_speedup():
    # A lone job on all N servers departs after x / N^p; its slowdown is 1.
    x0 = torch.tensor([[5.0], [5.0]], dtype=torch.float64)
    arr = torch.tensor([[2.0], [0.0]], dtype=torch.float64)
    ids = torch.tensor([[0], [3]])
    out = multiclass.answers(x0, arr, ids, CLASSES, N)
    want = 5.0 / N ** torch.tensor([CLASSES[0]["p"], CLASSES[3]["p"]], dtype=torch.float64)
    assert torch.allclose(out["mean_flowtime"], want, rtol=1e-15)
    assert torch.allclose(out["makespan"], arr[:, 0] + want, rtol=1e-15)
    assert torch.allclose(out["mean_slowdown"], torch.ones(2, dtype=torch.float64), rtol=1e-15)
    assert out["class_flowtime"][0, 0] == out["mean_flowtime"][0]
    assert math.isnan(out["class_flowtime"][0, 1])


# ------------------------------------------------------------ the cell
def test_port_agrees_with_reference():
    out = run_small(small_cell())
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) == {"flow_gap", "slowdown_gap", "makespan_gap", "class_flow_gap"}
    for c in out["checks"].values():
        assert c["value"] <= 1e-13
    assert list(out)[-1] == "checks"


def test_float32_control_fails():
    cell = small_cell()
    driver = harness.load_driver(cell.driver)
    for seed in (3, 4, 5):
        work = driver.prepare(cell, seed, CPU)
        verdict = work.check([driver.control_unit(work, 0)])
        assert not verdict.correct
        assert max(c.value / c.limit for c in verdict.checks) > 10


def test_only_water_filling_has_a_reference():
    cell = small_cell(policy="hesrpt_pc")
    with pytest.raises(ValueError, match="water-filling"):
        harness.load_driver(cell.driver).prepare(cell, 1, CPU).check([])


def _halve_rows(fn):
    """The answers of the second half of the rows left out: each takes the
    mean of the first half's."""
    def wrapped(*a, **k):
        res = fn(*a, **k)
        times = res.completion_times.clone()
        flat = times.reshape(-1, times.shape[-1])
        half = max(1, flat.shape[0] // 2)
        flat[half:] = flat[:half].mean(0, keepdim=True)
        return res._replace(completion_times=times)
    return wrapped


def _alter_one(fn):
    """One job's completion time in the first row moved by a millionth."""
    def wrapped(*a, **k):
        res = fn(*a, **k)
        times = res.completion_times.clone()
        times.reshape(-1, times.shape[-1])[0, 0] *= 1 + 1e-6
        return res._replace(completion_times=times)
    return wrapped


def _same_class(fn):
    """Every job's shares computed as if it were of the first job's class."""
    def wrapped(name, x, p, **k):
        return fn(name, x, p[..., :1].expand_as(p), **k)
    return wrapped


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_answer",
                                   "class_blind_shares"])
def test_a_fault_makes_the_run_incorrect(fault, monkeypatch):
    from repro_torch.core import engine, multiclass as port_multiclass

    if fault == "unchanged_state":  # no job is ever served
        monkeypatch.setattr(engine, "speedup", lambda k, p: torch.zeros_like(k))
    elif fault == "half_batch":
        monkeypatch.setattr(engine, "run", _halve_rows(engine.run))
    elif fault == "altered_answer":
        monkeypatch.setattr(engine, "run", _alter_one(engine.run))
    else:
        monkeypatch.setattr(port_multiclass, "class_theta",
                            _same_class(port_multiclass.class_theta))
    out = run_small(small_cell())
    assert not out["correct"]


# ------------------------------------------------------------ the readers
READERS = ("class_theta_us", "waterfill_iters_per_step")
SNAPSHOT = {"spans": {"multiclass.theta": {"count": 20, "total_s": 0.2, "self_s": 0.2}},
            "counters": {"engine.steps": 20, "policy.waterfill_iters": 1280}}
WANT = {"class_theta_us": 10000.0, "waterfill_iters_per_step": 64.0}


def read(name, ctx):
    return harness.load_reader(name).read(ctx)


@pytest.fixture
def snapshot(monkeypatch):
    from repro_torch import spans

    snap = {"spans": dict(SNAPSHOT["spans"]), "counters": dict(SNAPSHOT["counters"])}
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    return snap


@pytest.mark.parametrize("name", READERS)
def test_readers_on_a_snapshot(name, snapshot):
    assert read(name, {"trace": {}}) == pytest.approx(WANT[name])
    assert read(name, {"trace": None}) is None
    assert read(name, {}) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_of_a_program_without_the_class_spans(name, snapshot):
    # The parent of this cell's spans: the loop's counter, nothing else.
    del snapshot["spans"]["multiclass.theta"]
    del snapshot["counters"]["policy.waterfill_iters"]
    assert read(name, {"trace": {}}) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_of_a_program_without_spans(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert read(name, {"trace": {}}) is None


def test_the_cell_reports_its_metrics():
    cell = harness.load_cell(CELL)
    per_layer = {m["name"]: m for m in cell.per_layer}
    assert set(per_layer) >= {"host_ops_per_step", "kernels_per_step", "loop_roofline",
                              "idle_share", "peak_gb", "draw_ms", "to_host_ms",
                              "loop_host_us", "alloc_host_us", *READERS}
    assert "alloc_roofline" not in per_layer  # no alloc kernel runs here
    for name in READERS:
        m = per_layer[name]
        assert m["layer"] == "class-aware allocate" and m["moves"] == "jobs_per_s"
        assert CELL in m["workloads"]
    assert [m["name"] for m in cell.end_to_end] == ["jobs_per_s", "setup_s"]


def test_a_traced_window_reads_every_metric():
    from repro_torch import spans

    cell = harness.load_cell(CELL, config={"n_jobs": 12, "rates": [0.5, 8.0]},
                             traffic={"n_seeds": 3, "check_seeds": 3})
    work = harness.load_driver(cell.driver).prepare(cell, 2**31 + 3, CPU)
    spans.reset()
    win = harness.measure(work, 0.05, True, CPU, time.perf_counter())
    snap = spans.snapshot()
    steps = len(win.outputs) * 2 * 12
    assert snap["counters"]["engine.steps"] == win.ctx["steps"] == steps
    assert snap["spans"]["multiclass.theta"]["count"] == steps
    assert snap["counters"]["policy.waterfill_iters"] == 64 * steps
    got = harness.read_per_layer(cell, win.ctx)
    assert got["waterfill_iters_per_step"]["value"] == 64.0
    assert 0 < got["class_theta_us"]["value"] <= got["alloc_host_us"]["value"]
    # Every metric but the card's peak memory, which the CPU does not keep.
    assert set(got) == {m["name"] for m in cell.per_layer} - {"peak_gb"}
    spans.reset()


# ------------------------------------------------------------ on a card
@pytest.mark.cuda
def test_control_fails_at_the_cells_size_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench import control

    cell = harness.load_cell(CELL)
    driver = harness.load_driver(cell.driver)
    dev = torch.device("cuda", 0)
    assert not control.readings(cell, 2**31 + 101, dev, True, driver)["correct"]
    assert control.readings(cell, 2**31 + 104, dev, False, driver)["correct"]
