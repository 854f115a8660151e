"""The event loop's step after the allocate (``kernels/event_step.py``) on
the CPU.

- ``event_step`` on CPU tensors is the plain version ``event_step_ref``.
- The plain version under a drift boundary that never comes is the step
  without drift, bit for bit.
- ``engine.run`` takes the kernel's path for every step, under ``p_drift``
  too, and counts them (``engine.step_kernel``, under the profiler): here
  with the launch replaced by the plain version, so the wiring runs on the
  CPU and moves no result; 0 on the CPU.
- The wrapper refuses what the kernel does not take.
- A stateful rule's ``observe`` sees the epoch's active set.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.core import engine, estimation, multiclass, policies  # noqa: E402
from repro_torch.kernels import event_step as kstep  # noqa: E402


def _tapes(seed, C, M, *, ties=False):
    """Pareto sizes and Poisson arrivals ``[C, M]``; with ``ties``, sizes in
    {1, 2} and arrivals in pairs (equal times)."""
    rng = np.random.default_rng(seed)
    if ties:
        x = rng.integers(1, 3, (C, M)).astype(float)
        arr = np.repeat(np.cumsum(rng.exponential(0.5, (C, (M + 1) // 2)), -1), 2, -1)[:, :M]
    else:
        x = rng.pareto(1.5, (C, M)) + 0.5
        arr = np.cumsum(rng.exponential(0.25, (C, M)), -1)
    return torch.tensor(x), torch.tensor(arr)


def _state(x, arr, *, admitted):
    """A mid-run state: the first ``admitted`` jobs of each row arrived and
    a third of those already departed."""
    C, M = x.shape
    i = torch.full((C, 1), admitted, dtype=torch.int64)
    x = torch.where(torch.arange(M) % 3 == 0, 0.0, x)
    t = arr[:, admitted - 1:admitted].clone() if admitted else torch.zeros((C, 1),
                                                                             dtype=x.dtype)
    tol = 1e-9 * x.amax(-1, keepdim=True)
    times = torch.where(x == 0, 0.5, 0.0).to(x.dtype)
    return x, i, t, tol, times


def _equal(a: kstep.Step, b: kstep.Step):
    for name in kstep.Step._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("admitted", [0, 5, 40])
def test_event_step_on_the_cpu_is_the_plain_version(ties, admitted):
    x0, arr = _tapes(1, 6, 40, ties=ties)
    x, i, t, tol, times = _state(x0, arr, admitted=admitted)
    rate = torch.where(torch.arange(40) % 2 == 0, 2.0, 1.0).expand(6, 40).to(x.dtype)
    got = kstep.event_step(x, rate, arr, t, i, tol, times.clone())
    want = kstep.event_step_ref(x, rate, arr, t, i, tol, times.clone())
    _equal(got, want)
    assert torch.equal(got.x_act, torch.where((torch.arange(40) < got.i) & (got.x > 0),
                                              got.x, 0.0))


def test_a_row_with_no_job_left_takes_a_no_op_step():
    x = torch.zeros((2, 5), dtype=torch.float64)
    arr = torch.arange(10, dtype=torch.float64).reshape(2, 5)
    i = torch.full((2, 1), 5)
    t = torch.full((2, 1), 7.0, dtype=torch.float64)
    times = torch.rand((2, 5), dtype=torch.float64)
    step = kstep.event_step(x, torch.ones_like(x), arr, t, i, torch.zeros_like(t), times)
    assert torch.equal(step.dt, torch.zeros_like(t))
    assert torch.equal(step.t, t) and torch.equal(step.i, i)
    assert torch.equal(step.x, x) and torch.equal(step.times, times)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_a_boundary_that_never_comes_is_the_step_without_drift(seed):
    x0, arr = _tapes(seed, 4, 30, ties=seed == 2)
    x, i, t, tol, times = _state(x0, arr, admitted=12)
    rate = torch.tensor(np.random.default_rng(seed).uniform(0.5, 3.0, (4, 30)))
    never = torch.full((4, 1), torch.inf, dtype=torch.float64)
    _equal(kstep.event_step_ref(x, rate, arr, t, i, tol, times, t_next_drift=never),
           kstep.event_step_ref(x, rate, arr, t, i, tol, times))


def _steps_counted(fn):
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    counters = spans.snapshot()["counters"]
    spans.reset()
    return out, counters


def _fake_launch(monkeypatch):
    """Route ``event_step`` to its kernel path on the CPU, the launch
    replaced by the plain version; returns the list of launches."""
    launches = []

    def launch(x, rate, arr, t, i, tol, times, t_next_drift=None):
        launches.append(x.shape)
        return kstep.event_step_ref(x, rate, arr, t, i, tol, times, t_next_drift)

    monkeypatch.setattr(kstep, "on_kernel", lambda x: True)
    monkeypatch.setattr(kstep, "_step_cuda", launch)
    return launches


RUNS = {
    "fused": lambda x, a: engine.run(x, a, 0.5, engine.quantized_rule(policies.hesrpt, 16),
                                     fused=True, record=True),
    "pre_arrived": lambda x, a: engine.run(x, a, 0.5, engine.continuous_rule(
        policies.hesrpt, 16.0), pre_arrived=True, record=True),
    "horizon": lambda x, a: engine.run(x, a, 0.5, engine.continuous_rule(policies.equi, 16.0),
                                       horizon=7),
    "estimating": lambda x, a: engine.run(x, a, 0.5, estimation.estimating_rule(
        policies.hesrpt, 16.0, prior_p=0.8, n_jobs=x.shape[-1], device="cpu")),
    "per_job_p": lambda x, a: engine.run(
        x, a, torch.where(torch.arange(x.shape[-1]) % 2 == 0, 0.3, 0.8).expand_as(x).to(x.dtype),
        multiclass.class_rule("hesrpt_pc", n_chips=16), record=True),
    "drift": lambda x, a: engine.run(
        x, a, 0.5, engine.quantized_rule(policies.hesrpt, 16), fused=True, record=True,
        p_drift=engine.PDrift(a[:, 4:5].clone(), torch.tensor([0.8, 0.3], dtype=torch.float64))),
}


@pytest.mark.parametrize("path", sorted(RUNS))
def test_run_takes_the_kernel_path_every_step_and_counts_them(monkeypatch, path):
    x, a = _tapes(3, 5, 12)
    plain, counters = _steps_counted(lambda: RUNS[path](x, a))
    E = counters["engine.steps"]
    assert counters.get("engine.step_kernel", 0) == 0  # the CPU takes the plain version
    launches = _fake_launch(monkeypatch)
    routed, counters = _steps_counted(lambda: RUNS[path](x, a))
    assert counters == {"engine.steps": E, "engine.step_kernel": E}
    assert len(launches) == E
    assert torch.equal(routed.completion_times, plain.completion_times)
    assert torch.equal(routed.x_final, plain.x_final)
    if plain.trace is not None:
        for name in engine.EngineTrace._fields:
            assert torch.equal(getattr(routed.trace, name), getattr(plain.trace, name)), name


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    x0, arr = _tapes(5, 3, 8)
    x, i, t, tol, times = _state(x0, arr, admitted=4)
    rate = torch.ones_like(x)
    with pytest.raises(ValueError, match="CUDA"):
        kstep._step_cuda(x, rate, arr, t, i, tol, times)
    with pytest.raises(TypeError, match="dtype=torch.float32"):
        kstep._check(x.float(), rate, arr.float(), t.float(), i, tol.float(), times.float())
    with pytest.raises(TypeError, match="int64"):
        kstep._check(x, rate, arr, t, i.int(), tol, times)
    with pytest.raises(ValueError, match="t must be"):
        kstep._check(x, rate, arr, t[:2], i, tol, times)
    with pytest.raises(ValueError, match="contiguous times"):
        kstep._check(x, rate, arr, t, i, tol, times.t().contiguous().t())
    with pytest.raises(TypeError, match="float64 or float32"):
        kstep._check(x.half(), rate, arr, t, i, tol, times)
    with pytest.raises(ValueError, match="rate must be"):
        kstep._check(x, rate[:, :1], arr, t, i, tol, times)
    with pytest.raises(TypeError, match="t_next_drift"):
        kstep._check(x, rate, arr, t, i, tol, times, t.float())
    with pytest.raises(ValueError, match="contiguous t_next_drift"):
        kstep._check(x, rate, arr, t, i, tol, times, torch.zeros((3, 2), dtype=t.dtype)[:, :1])
    # A rule's rate may be a view: it is made contiguous, not refused.
    view = torch.ones((x.shape[1], x.shape[0]), dtype=x.dtype).t()
    assert torch.equal(kstep._check(x, view, arr, t, i, tol, times), rate)


def test_a_stateful_rules_observe_sees_the_epochs_active_set():
    x, a = _tapes(6, 4, 9)
    seen = []
    base = engine.quantized_rule(policies.hesrpt, 16)

    def observe(state, obs):
        seen.append(obs.active)
        return state

    rule = engine.StatefulRule(init=lambda: (), observe=observe,
                               allocate=lambda state, x_act, p: base(x_act, p))
    res = engine.run(x, a, 0.5, rule, pre_arrived=True, record=True)
    assert len(seen) == 9
    assert torch.equal(torch.stack(seen, 1), res.trace.sizes > 0)
