"""The plain reference against the port on the CPU at a tiny size, the
float32 control against the limits, and the faults that a run's ``correct``
has to catch.  The ``cuda`` test reads the program and the control at each
cell's own size on a card."""

import time

import numpy as np
import pytest
import torch

from bench import harness
from bench.reference import scheduler, tapes

CPU = torch.device("cpu")
SMALL = {"online-n256.fused": ({"rates": [0.5, 4.0, 16.0], "n_jobs": 40}, {"n_seeds": 4}),
         "online-n256.continuous": ({"rates": [0.5, 4.0, 16.0], "n_jobs": 40}, {"n_seeds": 4})}


def small_cell(name, **traffic):
    config, tr = SMALL[name]
    tr = {**tr, "check_seeds": tr["n_seeds"], **traffic}
    return harness.load_cell(name, config=config, traffic=tr)


def run_small(cell, seed=2**31 + 11, trace=False):
    return harness.run_cell(cell, seed, 0.05, trace, CPU, time.perf_counter())


@pytest.mark.parametrize("name", list(SMALL))
def test_port_agrees_with_reference(name):
    out = run_small(small_cell(name))
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    for c in out["checks"].values():
        assert c["value"] <= 1e-13
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name", list(SMALL))
def test_float32_control_fails(name):
    cell = small_cell(name)
    driver = harness.load_driver(cell.driver)
    for seed in (3, 4, 5):
        work = driver.prepare(cell, seed, CPU)
        verdict = work.check([driver.control_unit(work, 0)])
        assert not verdict.correct
        assert max(c.value / c.limit for c in verdict.checks) > 10


def test_tapes_are_the_ports():
    from repro_torch.core.sweeps import Sweep, draw_scenario

    spec = Sweep.create(("hesrpt",), [0.5, 2.0], n_jobs=16, n_seeds=3, seed=2**33 + 1)
    scn = draw_scenario(spec, device="cpu")
    for s in range(3):
        x, a = tapes.poisson_pareto(spec.seed, s, spec.rates, 16, 1.5, CPU)
        assert torch.equal(x, scn.x0[:, s]) and torch.equal(a, scn.arrival_times[:, s])


def test_whole_chips_sum_and_floor():
    gen = torch.Generator().manual_seed(0)
    theta = torch.rand(50, 300, generator=gen, dtype=torch.float64)
    theta = torch.where(theta < 0.3, 0.0, theta)
    theta = theta / theta.sum(-1, keepdim=True)
    chips = scheduler.whole_chips(theta[:, :200], 256)
    assert torch.all(chips.sum(-1) == 256) and torch.all(chips[theta[:, :200] > 0] >= 1)
    crowded = scheduler.whole_chips(theta, 64)  # more active jobs than chips
    assert torch.all(crowded.sum(-1) == 64) and torch.all(crowded >= 0)


# ------------------------------------------------------------ faults
def _halve_rows(fn):
    """The answers of the second half of the rows left out: each takes the
    mean of the first half's."""
    def wrapped(*a, **k):
        res = fn(*a, **k)
        times = (res if isinstance(res, torch.Tensor) else res.completion_times).clone()
        flat = times.reshape(-1, times.shape[-1])
        half = max(1, flat.shape[0] // 2)
        flat[half:] = flat[:half].mean(0, keepdim=True)
        return times if isinstance(res, torch.Tensor) else res._replace(completion_times=times)
    return wrapped


def _alter_one(fn):
    """One job's completion time in the first row moved by a millionth."""
    def wrapped(*a, **k):
        res = fn(*a, **k)
        times = (res if isinstance(res, torch.Tensor) else res.completion_times).clone()
        flat = times.reshape(-1, times.shape[-1])
        flat[0, 0] *= 1 + 1e-6
        return times if isinstance(res, torch.Tensor) else res._replace(completion_times=times)
    return wrapped


# Every fault a one-card cell can have (none exchanges parts between chips).
FAULTS = [(name, fault) for name in SMALL
          for fault in ("unchanged_state", "half_batch", "altered_answer")]


@pytest.mark.parametrize(("name", "fault"), FAULTS)
def test_a_fault_makes_the_run_incorrect(name, fault, monkeypatch):
    from repro_torch.core import engine

    if fault == "unchanged_state":  # no job is ever served: every step leaves x as it was
        monkeypatch.setattr(engine, "speedup", lambda k, p: torch.zeros_like(k))
    elif fault == "half_batch":
        monkeypatch.setattr(engine, "run", _halve_rows(engine.run))
        monkeypatch.setattr(engine, "run_ranked", _halve_rows(engine.run_ranked))
    else:
        monkeypatch.setattr(engine, "run", _alter_one(engine.run))
        monkeypatch.setattr(engine, "run_ranked", _alter_one(engine.run_ranked))
    out = run_small(small_cell(name))
    assert not out["correct"]


# ------------------------------------------------------------ on a card
@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SMALL))
def test_control_fails_at_the_cells_size_on_a_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench import control

    cell = harness.load_cell(name)
    driver = harness.load_driver(cell.driver)
    dev = torch.device("cuda", 0)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        assert not control.readings(cell, seed, dev, True, driver)["correct"]
    assert control.readings(cell, 2**31 + 104, dev, False, driver)["correct"]


def test_sampled_seeds_are_distinct_and_follow_the_seed():
    from bench.drivers.sweep import sample_seeds

    s = sample_seeds(2**31 + 5, 1024, 8)
    assert len(s) == 8 and len(set(s)) == 8 and s.max() < 1024
    assert np.array_equal(s, sample_seeds(2**31 + 5, 1024, 8))
    assert not np.array_equal(s, sample_seeds(2**31 + 6, 1024, 8))
