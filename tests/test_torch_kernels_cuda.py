"""The port's CUDA kernels on a card, against their plain versions.

- the fused allocate: bit for bit, with one p a launch or one a cell read
  from device memory (a drifting p), and through the engine under drift;
- the event loop's step (``kernels/event_step.py``): bit for bit, step by
  step along a trajectory and through ``engine.run`` against the same run
  with the plain step, at the sweeps' [6144, 1000] and over the callers'
  options (``record``, ``pre_arrived``, ``horizon``, a stateful rule,
  per-job exponents, a drifting p per cell and per job), one launch a
  step;
- flash attention: within the tolerances of ``tests/test_kernels.py``
  (float32 2e-5, bfloat16 5e-2: the kernel sums in another order than the
  plain version's einsum, and bf16 rounds the float32 result once), float32
  at the edges of its design's tiles at each of its six instances;
- the SSD chunked scan: against its plain version ``kernels.chunked.ssd``
  and the recurrence ``kernels.ref.ssd``, y at the same tolerances and the
  final state within 1e-3 (those of ``tests/test_kernels.py``'s SSD test);
- the RG-LRU scan: against its plain version
  ``kernels.ref.linear_recurrence`` (the same rounded steps: bit for bit)
  and the log-depth ``kernels.chunked.linear_scan`` on the same a and g, y
  at the same tolerances and the state within 1e-3, and ``ops.rglru``
  against ``kernels.chunked.rglru`` in float32;
- the smoke models' prefills through the flash kernel against plain
  attention (logits 2e-4), the moe, vlm and audio ones included (routing
  equal, the launches one per attention call);
- the MoE ``ragged_local`` dispatch's backward, twice: bit for bit.

Needs an NVIDIA card and nvcc (the kernels have no CPU mode), so every test
is marked ``cuda`` and skips where ``torch.cuda.is_available()`` is False.
The file imports neither jax nor the JAX package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_cuda.py

(``--noconftest``: the shared ``tests/conftest.py`` configures jax.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import engine, estimation, multiclass, policies  # noqa: E402
from repro_torch.kernels import alloc, chunked, ops, ref  # noqa: E402
from repro_torch.kernels import event_step as kstep  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import rglru_scan as rglru_kernel  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_kernel  # noqa: E402
from repro_torch.models.common import ModelOptions  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

# (cells, M, n_chips, min_chips, sizes): plenty of chips, floored (trims),
# oversubscribed, the lane shape, one to sixteen jobs a thread (1024 and
# 1025 on either side of four), the largest M one CTA takes; sizes drawn
# from {1, 2, 3} (ties in the ranks and in the fractional parts), rows with
# every job inactive, and 1 and 300 cells (more than two CTAs an SM).
COMBOS = (
    (4, 6, 16, 1, "pareto"), (4, 16, 32, 3, "pareto"), (4, 16, 8, 1, "pareto"),
    (4, 9, 8, 2, "pareto"), (4, 300, 256, 1, "pareto"), (4, 1000, 256, 1, "pareto"),
    (4, 1024, 16, 2, "pareto"), (4, 1025, 256, 1, "pareto"), (4, 2048, 64, 2, "pareto"),
    (4, alloc.MAX_JOBS, 256, 1, "pareto"), (4, alloc.MAX_JOBS, 16, 3, "pareto"),
    (4, 37, 8, 1, "ties"), (4, 1000, 256, 1, "ties"), (4, alloc.MAX_JOBS, 256, 2, "ties"),
    (4, 1000, 256, 1, "inactive"), (4, alloc.MAX_JOBS, 16, 1, "inactive"),
    (1, 1000, 256, 1, "pareto"), (300, 1000, 256, 1, "pareto"),
    (300, alloc.MAX_JOBS, 256, 1, "ties"),
)
PS = (0.2, 0.5, 0.8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _sizes(rng, shape, zero_frac=0.3):
    x = rng.pareto(1.5, shape) + 0.01
    x[rng.random(shape) < zero_frac] = 0.0
    k = shape[-1] // 4
    x[..., :k] = x[..., k : 2 * k]  # exact ties
    return x


def _rows(rng, shape, sizes):
    """Sizes of one COMBOS kind: "pareto" (_sizes), "ties" (1, 2 or 3 with
    ~20% departed) or "inactive" (zeros and negatives only)."""
    if sizes == "ties":
        return np.where(rng.random(shape) < 0.2, 0.0, rng.integers(1, 4, shape).astype(float))
    if sizes == "inactive":
        return np.where(rng.random(shape) < 0.5, 0.0, -1.0)
    return _sizes(rng, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_equals_plain_version_on_card(cuda_device, dtype):
    rng = np.random.default_rng(0)
    for cells, m, n_chips, min_chips, sizes in COMBOS:
        x = torch.tensor(_rows(rng, (cells, m), sizes), device=cuda_device).to(dtype)
        for p in PS:
            before = alloc.LAUNCHES
            theta, chips = alloc.hesrpt_alloc_fused(x, p, n_chips, min_chips=min_chips)
            assert alloc.LAUNCHES == before + 1
            theta0, chips0 = alloc.hesrpt_alloc_fused_ref(x, p, n_chips, min_chips=min_chips)
            assert torch.equal(theta, theta0)
            assert torch.equal(chips, chips0)
            assert torch.equal(alloc.hesrpt_theta_fused(x, p), theta0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("cells", [1, 6, 192])
def test_kernel_with_per_cell_p_equals_plain_version_on_card(cuda_device, dtype, cells):
    """p from device memory, one a cell, every bracket_pow mode in one
    launch (c = 1, 2, 3, 5, 1/0.7): bit for bit with the plain version and
    with each cell's scalar-p launch."""
    rng = np.random.default_rng(7)
    mixed = torch.tensor([0.0, 0.5, 2.0 / 3.0, 0.8, 0.3, 0.5], dtype=torch.float64)
    p_col = mixed.repeat(-(-cells // 6))[:cells, None].to(cuda_device)
    for m, n_chips, min_chips, sizes in ((1000, 256, 1, "pareto"), (37, 8, 1, "ties"),
                                         (alloc.MAX_JOBS, 16, 2, "pareto")):
        x = torch.tensor(_rows(rng, (cells, m), sizes), device=cuda_device).to(dtype)
        before = alloc.LAUNCHES
        theta, chips = alloc.hesrpt_alloc_fused(x, p_col, n_chips, min_chips=min_chips)
        assert alloc.LAUNCHES == before + 1
        theta0, chips0 = alloc.hesrpt_alloc_fused_ref(x, p_col, n_chips, min_chips=min_chips)
        assert torch.equal(theta, theta0)
        assert torch.equal(chips, chips0)
        assert torch.equal(alloc.hesrpt_theta_fused(x, p_col[:, 0]), theta0)
        for p in mixed.unique().tolist():
            rows = (p_col[:, 0] == p).nonzero()[:, 0]
            theta_s, chips_s = alloc.hesrpt_alloc_fused(x, p, n_chips, min_chips=min_chips)
            assert torch.equal(theta[rows], theta_s[rows]), p
            assert torch.equal(chips[rows], chips_s[rows]), p


@pytest.mark.cuda
def test_fused_drift_run_on_card_equals_unfused_and_cpu(cuda_device):
    """A drifting p through the fused engine on the card: one launch an
    event step (2M + D), chips equal to the unfused run's and the CPU's at
    every event."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.pareto(1.5, (6, 50)) + 0.5)
    arr = torch.tensor(np.cumsum(rng.exponential(0.25, (6, 50)), -1))
    drift = engine.PDrift(arr[:, 20:21].clone(), torch.tensor([0.8, 0.3], dtype=torch.float64))
    rule = engine.quantized_rule(policies.hesrpt, 32)
    cpu = engine.run(x, arr, 0.5, rule, record=True, fused=True, p_drift=drift)
    gdrift = engine.PDrift(drift.times.to(cuda_device), drift.values.to(cuda_device))
    xg, ag = x.to(cuda_device), arr.to(cuda_device)
    before = alloc.LAUNCHES
    fused = engine.run(xg, ag, 0.5, rule, record=True, fused=True, p_drift=gdrift)
    assert alloc.LAUNCHES == before + 2 * 50 + 1
    unfused = engine.run(xg, ag, 0.5, rule, record=True, p_drift=gdrift)
    assert torch.equal(fused.trace.alloc, unfused.trace.alloc)
    assert torch.equal(fused.completion_times, unfused.completion_times)
    assert torch.equal(fused.trace.alloc.cpu(), cpu.trace.alloc)


@pytest.mark.cuda
def test_fused_run_on_card_equals_cpu_run(cuda_device):
    """The fused engine on the card (kernel) and on the CPU (plain
    version): the same chips at every event; completion times within
    1e-12 relative (the engine's elementwise ops, e.g. ``chips ** p``,
    round differently in the last ulp on CPU and CUDA)."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.pareto(1.5, (6, 50)) + 0.5)
    arr = torch.tensor(np.cumsum(rng.exponential(0.25, (6, 50)), -1))
    rule = engine.quantized_rule(policies.hesrpt, 32)
    cpu = engine.run(x, arr, 0.5, rule, record=True, fused=True)
    gpu = engine.run(x.to(cuda_device), arr.to(cuda_device), 0.5, rule, record=True, fused=True)
    assert torch.equal(gpu.trace.alloc.cpu(), cpu.trace.alloc)
    np.testing.assert_allclose(
        gpu.completion_times.cpu().numpy(), cpu.completion_times.numpy(), rtol=1e-12, atol=0
    )


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    x = torch.ones((2, alloc.MAX_JOBS + 1), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        alloc.hesrpt_alloc_fused(x, 0.5, 16)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.ones((8, 4), device=cuda_device, dtype=torch.float64).t()
        alloc.hesrpt_alloc_fused(strided, 0.5, 16)
    with pytest.raises(TypeError):
        half = torch.ones(4, device=cuda_device, dtype=torch.float16)
        alloc.hesrpt_alloc_fused(half, 0.5, 16)
    x = torch.ones((3, 8), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="lies on"):  # a CPU p never reaches the card
        alloc.hesrpt_alloc_fused(x, torch.full((3, 1), 0.5, dtype=torch.float64), 16)
    with pytest.raises(ValueError, match="cells"):
        alloc.hesrpt_alloc_fused(x, torch.full((2, 1), 0.5, device=cuda_device), 16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [1, 12, 24, 64, 256])
def test_kernel_at_slot_pool_widths_equals_plain_version(cuda_device, dtype, m):
    """The streaming loop's rows: a pool of 1-256 slots, padded to at least
    32, with half to nearly all slots free (exactly 0) and rows with every
    slot free, bit for bit."""
    rng = np.random.default_rng(25)
    for zero_frac in (0.5, 0.9, 1.0):
        x = torch.tensor(_sizes(rng, (48, m), zero_frac), device=cuda_device).to(dtype)
        for n_chips, min_chips in ((0, 1), (256, 1), (16, 2)):
            for p in PS:
                theta, chips = alloc.hesrpt_alloc_fused(x, p, n_chips, min_chips=min_chips)
                theta0, chips0 = alloc.hesrpt_alloc_fused_ref(x, p, n_chips, min_chips=min_chips)
                assert torch.equal(theta, theta0), (zero_frac, n_chips, p)
                assert torch.equal(chips, chips0), (zero_frac, n_chips, p)


@pytest.mark.cuda
def test_fused_stream_on_card_equals_unfused_and_refuses_wide_pools(cuda_device):
    """run_stream(fused=True) over 4 recycled slots: one launch an event
    step, every StreamResult field equal to the unfused loop's; a pool wider
    than MAX_JOBS is refused under fused=True, as on the finite-tape path."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.pareto(1.5, (6, 50)) + 0.5, device=cuda_device)
    arr = torch.tensor(np.cumsum(rng.exponential(0.25, (6, 50)), -1), device=cuda_device)
    rule = engine.quantized_rule(policies.hesrpt, 32)
    window = (arr[:, 5], arr[:, 45])
    before = alloc.LAUNCHES
    fused = engine.run_stream(x, arr, 0.5, rule, n_slots=4, window=window, record_times=True,
                              fused=True)
    assert alloc.LAUNCHES == before + 2 * 50
    unfused = engine.run_stream(x, arr, 0.5, rule, n_slots=4, window=window,
                                record_times=True)
    for field, value in zip(fused._fields, fused):
        if value is not None:
            assert torch.equal(value, getattr(unfused, field)), field
    assert int(fused.blocked_steps.sum()) > 0
    with pytest.raises(ValueError, match="at most"):
        engine.run_stream(x, arr, 0.5, rule, n_slots=alloc.MAX_JOBS + 1, fused=True)


# ------------------------------------------------------------ flash attention
FLASH_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
             torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}
# (b, hq, hkv, sq, skv, d, causal, window): the cases of tests/test_kernels.py,
# non-causal, windows, every head dim the kernel takes.
FLASH_CASES = (
    (1, 4, 4, 128, 128, 64, True, 0), (2, 4, 2, 256, 256, 64, True, 0),
    (1, 8, 1, 128, 128, 32, True, 0), (2, 4, 2, 130, 190, 64, True, 0),
    (1, 2, 2, 64, 64, 128, True, 0), (2, 2, 2, 128, 192, 64, False, 0),
    (1, 4, 2, 256, 256, 64, True, 16), (1, 4, 2, 256, 256, 64, True, 100),
    (1, 4, 2, 200, 200, 16, False, 100), (2, 6, 3, 77, 77, 256, True, 0),
    (1, 3, 1, 5, 300, 128, True, 0),
)


def _online_tapes(rng, cells, m, *, ties=False):
    """Sizes and ascending arrivals ``[cells, m]``: Pareto(1.5) sizes >= 1
    over Poisson arrivals at rates from 0.25 to 16 across the rows, or with
    ``ties`` sizes in {1, 2} arriving in pairs at equal times."""
    if ties:
        x = rng.integers(1, 3, (cells, m)).astype(float)
        arr = np.repeat(np.cumsum(rng.exponential(0.5, (cells, (m + 1) // 2)), -1), 2, -1)
        return x, arr[:, :m]
    rates = np.geomspace(0.25, 16.0, cells)[:, None]
    return rng.pareto(1.5, (cells, m)) + 1.0, np.cumsum(rng.exponential(1.0, (cells, m)) / rates,
                                                        -1)


def _equal_steps(got, want):
    for name in kstep.Step._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _drift_bounds(arr):
    """Four regime boundaries a row and ``+inf`` past them, as ``engine.run``
    gathers them: two on arrival times (ties with the arrival) and two
    between arrivals; and the five regimes' exponents."""
    m = arr.shape[-1]
    mid = lambda k: (arr[:, k:k + 1] + arr[:, k + 1:k + 2]) / 2  # noqa: E731
    bounds = torch.cat([arr[:, m // 4:m // 4 + 1], mid(m // 3), arr[:, m // 2:m // 2 + 1],
                        mid(2 * m // 3)], -1).sort(-1).values
    bounds = torch.cat([bounds, torch.full_like(bounds[:, :1], torch.inf)], -1).contiguous()
    regimes = torch.tensor([0.5, 0.8, 0.3, 0.6, 0.9], dtype=arr.dtype, device=arr.device)
    return bounds, regimes.expand(arr.shape[0], 5)


# (dtype, cells, M, tapes, rule, drift): one job a row, a warp and one more,
# the sweeps' 1000, more than a CTA keeps in registers; ties in x / rate
# (EQUI gives equal sizes equal rates) with arrivals at equal times;
# float32; regime boundaries as a third candidate event, on arrivals too.
TRAJECTORIES = (
    (torch.float64, 6, 1, "pareto", "fused", False),
    (torch.float64, 6, 33, "pareto", "fused", False),
    (torch.float64, 6, 1000, "pareto", "fused", False),
    (torch.float64, 3, 4097, "pareto", "plain", False),
    (torch.float64, 6, 40, "ties", "equi", False),
    (torch.float32, 192, 1000, "pareto", "fused", False),
    (torch.float64, 6, 1000, "pareto", "fused", True),
    (torch.float32, 6, 33, "pareto", "fused", True),
    (torch.float64, 6, 40, "ties", "equi", True),
)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, cells, m, tapes, rule, drift", TRAJECTORIES)
def test_event_step_kernel_equals_plain_step_along_a_trajectory(cuda_device, dtype, cells, m,
                                                                tapes, rule, drift):
    """Step by step, each from the plain trajectory's state: the kernel's
    x, x_act, t, i, times and dt equal the plain version's bit for bit, one
    launch a step, to the trajectory's end (dt = 0) up to 1000 jobs."""
    rng = np.random.default_rng(m)
    x0, arr = (torch.tensor(v, device=cuda_device).to(dtype)
               for v in _online_tapes(rng, cells, m, ties=tapes == "ties"))
    if rule == "equi":
        allocate = engine.continuous_rule(policies.equi, 64.0, dtype=dtype)
    else:
        allocate = engine.quantized_rule(policies.hesrpt, 256, dtype=dtype)
        allocate = allocate.fused_variant if rule == "fused" else allocate
    bounds, regimes = _drift_bounds(arr) if drift else (None, None)
    x, t = x0, torch.zeros((cells, 1), dtype=dtype, device=cuda_device)
    i = torch.zeros((cells, 1), dtype=torch.int64, device=cuda_device)
    times = torch.zeros_like(x)
    tol = 1e-9 * x0.amax(-1, keepdim=True)
    x_act = torch.where((torch.arange(m, device=cuda_device) < i) & (x > 0), x, 0.0)
    to_end = m <= 1000
    for _ in range(2 * m + 3 + 4 * drift if to_end else 603):
        p, t_drift = 0.5, None
        if drift:  # the regime at each row's clock and its next boundary
            r = torch.searchsorted(bounds, t, right=True)
            p, t_drift = regimes.gather(-1, r), bounds.gather(-1, r)
        _, rate = allocate(x_act, p)
        before = kstep.LAUNCHES
        got = kstep.event_step(x, rate, arr, t, i, tol, times.clone(), t_drift)
        assert kstep.LAUNCHES == before + 1
        want = kstep.event_step_ref(x, rate, arr, t, i, tol, times, t_drift)
        _equal_steps(got, want)
        x, x_act, t, i, times = want.x, want.x_act, want.t, want.i, want.times
    if to_end:
        assert bool((x == 0).all()) and bool((want.dt == 0).all())


def _e2e_runs(device):
    """name -> (run(), E): ``engine.run`` at the sweeps' size and over every
    caller's options."""
    rng = np.random.default_rng(11)

    def tapes(cells, m, dtype=torch.float64, ties=False):
        return (torch.tensor(v, device=device).to(dtype)
                for v in _online_tapes(rng, cells, m, ties=ties))

    q256 = engine.quantized_rule(policies.hesrpt, 256)
    x_g, a_g = tapes(6144, 1000)
    x_32, a_32 = tapes(192, 1000, torch.float32)
    q32 = engine.quantized_rule(policies.hesrpt, 256, dtype=torch.float32)
    small = {m: tapes(4, m) for m in (1, 33, 1000)}
    x_w, a_w = tapes(2, 4097)
    x_t, a_t = tapes(6, 40, ties=True)
    x_e, a_e = tapes(8, 200)
    p_job = torch.where(torch.arange(200, device=device) % 3 == 0, 0.3, 0.8).expand(8, 200)
    est = estimation.estimating_rule(policies.hesrpt, 256.0, prior_p=0.8, n_jobs=200,
                                     n_chips=256, device=device)
    x_d, a_d = tapes(192, 1000)
    drift_cells = engine.PDrift(torch.stack([a_d[:, 250], (a_d[:, 600] + a_d[:, 601]) / 2], -1),
                                torch.tensor([0.8, 0.3, 0.6], dtype=torch.float64, device=device))
    drift_jobs = engine.PDrift(
        a_e[:, 50:51].clone(),
        torch.stack([p_job, 1.1 - p_job], -2).contiguous())  # [8, 2, 200]: each job's two regimes
    runs = {
        "fused_6144x1000_f64": (lambda: engine.run(x_g, a_g, 0.5, q256, fused=True), 2000),
        "fused_192x1000_f32": (lambda: engine.run(x_32, a_32, 0.5, q32, fused=True), 2000),
        "plain_2x4097_record": (lambda: engine.run(
            x_w, a_w, 0.5, engine.continuous_rule(policies.hesrpt, 256.0), record=True), 8194),
        "pre_arrived_record": (lambda: engine.run(
            x_e, a_e, 0.5, q256, pre_arrived=True, record=True, fused=True), 200),
        "ties_equi_horizon": (lambda: engine.run(
            x_t, a_t, 0.5, engine.continuous_rule(policies.equi, 64.0), horizon=100,
            record=True), 100),
        "estimating_rule": (lambda: engine.run(x_e, a_e, 0.5, est, record=True), 400),
        "per_job_p": (lambda: engine.run(
            x_e, a_e, p_job, multiclass.class_rule("hesrpt_pc", n_chips=32), record=True), 400),
        "drift_fused_192x1000_record": (lambda: engine.run(
            x_d, a_d, 0.5, q256, fused=True, record=True, p_drift=drift_cells), 2002),
        "drift_per_job_p": (lambda: engine.run(
            x_e, a_e, p_job, multiclass.class_rule("hesrpt_pc", n_chips=32), record=True,
            p_drift=drift_jobs), 401),
    }
    for m, (x, a) in small.items():
        runs[f"fused_4x{m}_record"] = (lambda x=x, a=a: engine.run(x, a, 0.5, q256, fused=True,
                                                                  record=True), 2 * m)
    return runs


E2E = ("fused_6144x1000_f64", "fused_192x1000_f32", "plain_2x4097_record", "pre_arrived_record",
       "ties_equi_horizon", "estimating_rule", "per_job_p", "fused_4x1_record",
       "fused_4x33_record", "fused_4x1000_record", "drift_fused_192x1000_record",
       "drift_per_job_p")


@pytest.mark.cuda
@pytest.mark.parametrize("case", E2E)
def test_run_through_the_event_step_kernel_equals_the_plain_step(cuda_device, monkeypatch,
                                                                  case):
    """``engine.run`` with the kernel against the same run with the plain
    step on the card: completion times, final sizes and the recorded trace
    bit for bit; the kernel launched once a step."""
    run, E = _e2e_runs(cuda_device)[case]
    before = kstep.LAUNCHES
    got = run()
    torch.cuda.synchronize()
    assert kstep.LAUNCHES == before + E
    monkeypatch.setattr(kstep, "event_step", kstep.event_step_ref)
    want = run()
    assert kstep.LAUNCHES == before + E
    assert torch.equal(got.completion_times, want.completion_times)
    assert torch.equal(got.x_final, want.x_final)
    assert bool(torch.isfinite(got.completion_times).all())
    if want.trace is not None:
        for name in engine.EngineTrace._fields:
            assert torch.equal(getattr(got.trace, name), getattr(want.trace, name)), name


@pytest.mark.cuda
def test_event_step_kernel_refuses_what_it_does_not_take(cuda_device):
    x = torch.ones((2, 5), dtype=torch.float64, device=cuda_device)
    arr, times = torch.zeros_like(x), torch.zeros_like(x)
    t, tol = torch.zeros((2, 1), dtype=torch.float64, device=cuda_device), torch.zeros(
        (2, 1), dtype=torch.float64, device=cuda_device)
    i = torch.zeros((2, 1), dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError, match="dtype"):
        kstep.event_step(x, x.float(), arr, t, i, tol, times)
    with pytest.raises(ValueError, match="lies on"):
        kstep.event_step(x, x, arr.cpu(), t, i, tol, times)
    with pytest.raises(TypeError, match="float64 or float32"):
        kstep.event_step(x.half(), x, arr, t, i, tol, times)
    with pytest.raises(TypeError, match="t_next_drift"):
        kstep.event_step(x, x, arr, t, i, tol, times, t.float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_version_on_card(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for b, hq, hkv, sq, skv, d, causal, window in FLASH_CASES:
        q = torch.randn((b, hq, sq, d), generator=gen, device=cuda_device).to(dtype)
        k = torch.randn((b, hkv, skv, d), generator=gen, device=cuda_device).to(dtype)
        v = torch.randn((b, hkv, skv, d), generator=gen, device=cuda_device).to(dtype)
        off = max(skv - sq, 0)
        kw = dict(causal=causal, window=window, q_offset=off)
        before = flash.LAUNCHES
        got = ops.attention(q, k, v, **kw)
        assert flash.LAUNCHES == before + 1
        want = ref.attention(q, k, v, **kw)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [160, 80, 200])
@pytest.mark.parametrize("window", [0, 100])
def test_flash_kernel_takes_head_dim_160_and_padded_head_dims(cuda_device, dtype, d, window):
    """stablelm's D = 160 (an instance of its own) and D's the kernel pads
    (80 to 128, 200 to 256): still one launch, in the model's transposed
    views too, at the true D's scale."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + window)
    for b, hq, hkv, sq, skv, views in ((2, 4, 2, 190, 190, False), (1, 8, 2, 130, 330, True)):
        def make(h, s):
            if views:
                return torch.randn((b, s, h, d), generator=gen, device=cuda_device).to(
                    dtype).transpose(1, 2)
            return torch.randn((b, h, s, d), generator=gen, device=cuda_device).to(dtype)
        q, k, v = make(hq, sq), make(hkv, skv), make(hkv, skv)
        kw = dict(causal=True, window=window, q_offset=skv - sq)
        before = flash.LAUNCHES
        got = ops.attention(q, k, v, **kw)
        assert flash.LAUNCHES == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), ref.attention(q, k, v, **kw).float(),
                                   **FLASH_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 80])
@pytest.mark.parametrize("scale", [0.1, 1.0])
def test_flash_kernel_takes_a_softmax_scale(cuda_device, dtype, d, scale):
    """``scale=`` reaches the kernel as it is, also where D is zero-padded
    (80 to 128); ``scale=None`` is the call without it, bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    q = torch.randn((2, 4, 190, d), generator=gen, device=cuda_device).to(dtype)
    k = torch.randn((2, 2, 190, d), generator=gen, device=cuda_device).to(dtype)
    v = torch.randn((2, 2, 190, d), generator=gen, device=cuda_device).to(dtype)
    before = flash.LAUNCHES
    got = flash.flash_attention(q, k, v, scale=scale)
    assert flash.LAUNCHES == before + 1
    torch.testing.assert_close(got.float(), ref.attention(q, k, v, scale=scale).float(),
                               **FLASH_TOL[dtype])
    assert torch.equal(flash.flash_attention(q, k, v, scale=None), flash.flash_attention(q, k, v))


@pytest.mark.cuda
def test_flash_kernel_takes_the_models_transposed_views(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn((2, 70, 6, 32), generator=gen, device=cuda_device).transpose(1, 2)
    k = torch.randn((2, 70, 2, 32), generator=gen, device=cuda_device).transpose(1, 2)
    v = torch.randn((2, 70, 2, 32), generator=gen, device=cuda_device).transpose(1, 2)
    got = flash.flash_attention(q, k, v)
    assert got.stride() == q.stride()  # the output takes q's layout
    torch.testing.assert_close(got, ref.attention(q, k, v), **FLASH_TOL[torch.float32])


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda_device):
    q = torch.ones((1, 2, 8, 16), device=cuda_device)
    with pytest.raises(TypeError):
        flash.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dim"):
        x = torch.ones((1, 2, 8, 272), device=cuda_device)
        flash.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="GQA"):
        flash.flash_attention(q, q[:, :1].expand(1, 3, 8, 16), q[:, :1].expand(1, 3, 8, 16))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash.flash_attention(q, q.cpu(), q)


# (b, hq, hkv, sq, skv, causal, window, layout): the float32 design's edges:
# q_offset = skv - sq > 0, lengths that are not multiples of its 64-row and
# 64-key tiles, a window narrower than a tile, a single query row, MQA,
# non-causal, the model's transposed views ("view"), and a q that is not
# 16-byte aligned ("unaligned": one element into its storage, rows d + 1
# apart), which the wrapper copies once.
F32_EDGE_CASES = (
    (1, 4, 2, 77, 300, True, 0, "dense"), (2, 4, 2, 130, 190, True, 0, "dense"),
    (1, 4, 2, 200, 200, True, 20, "dense"), (1, 4, 1, 1, 333, True, 0, "dense"),
    (1, 2, 1, 1, 1, True, 0, "dense"), (1, 8, 1, 150, 150, True, 0, "dense"),
    (2, 2, 2, 70, 129, False, 0, "dense"), (2, 6, 2, 150, 150, True, 48, "view"),
    (1, 4, 2, 90, 90, True, 40, "unaligned"),
)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128, 160, 256])
def test_f32_flash_kernel_matches_plain_version_at_its_edges(cuda_device, d):
    """The CUDA-core design at each of its six instances, on the edges of its
    tiles, its ring of K/V copies and its 16-byte copies."""
    gen = torch.Generator(device=cuda_device).manual_seed(100 + d)
    for b, hq, hkv, sq, skv, causal, window, layout in F32_EDGE_CASES:
        def make(h, s):
            if layout == "view":  # [B, S, H, D] memory, as the model's projections
                return torch.randn((b, s, h, d), generator=gen, device=cuda_device).transpose(1, 2)
            return torch.randn((b, h, s, d), generator=gen, device=cuda_device)
        q, k, v = make(hq, sq), make(hkv, skv), make(hkv, skv)
        if layout == "unaligned":
            q = torch.randn((b, hq, sq, d + 1), generator=gen, device=cuda_device)[..., 1:]
            assert not flash.f32_copies_in_place(q) and flash.f32_copies_in_place(k)
        kw = dict(causal=causal, window=window, q_offset=skv - sq)
        launches, copies = flash.LAUNCHES, flash.ALIGN_COPIES
        got = flash.flash_attention(q, k, v, **kw)
        assert flash.LAUNCHES == launches + 1
        assert flash.ALIGN_COPIES == copies + (layout == "unaligned")
        assert got.dtype == torch.float32 and got.shape == q.shape
        if layout == "view":
            assert got.stride() == q.stride()
        torch.testing.assert_close(got, ref.attention(q, k, v, **kw),
                                   **FLASH_TOL[torch.float32])


# The bf16 kernel is also held closer than FLASH_TOL, as chip_smoke.py's phase
# 7 holds it: every element within 1e-2 + 1e-2 |want|, and ||got - want|| within
# 7e-3 ||want|| (its worst on an H100 was 2.3e-3; a dropped K/V tile reads 0.116).
FLASH_BF16_TIGHT = dict(rtol=1e-2, atol=1e-2)
FLASH_BF16_REL = 7e-3


def _check_bf16(got, want):
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, **FLASH_TOL[torch.bfloat16])
    torch.testing.assert_close(got, want, **FLASH_BF16_TIGHT)
    assert (got - want).norm() <= FLASH_BF16_REL * want.norm()


# (b, hq, hkv, sq, skv, causal, window): GQA and MQA, causal and not, a
# window, q_offset = skv - sq > 0, and lengths that are not multiples of the
# bf16 kernel's 128-row and 64-key tiles.
BF16_CASES = (
    (2, 4, 2, 128, 128, True, 0), (1, 8, 1, 200, 200, False, 0),
    (2, 6, 3, 130, 190, True, 0), (1, 4, 1, 333, 333, True, 100),
    (1, 4, 2, 77, 300, True, 48), (2, 2, 2, 5, 70, False, 0),
)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128, 160, 256, 80, 200])
def test_bf16_flash_kernel_matches_plain_version_at_each_instance(cuda_device, d):
    """The tensor-core design at each of its six instances and two padded
    head dims, against ``ref.attention`` (P is rounded to bf16 before P V:
    the reference keeps it in float32)."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    for b, hq, hkv, sq, skv, causal, window in BF16_CASES:
        q, k, v = (torch.randn((b, h, s, d), generator=gen, device=cuda_device).to(torch.bfloat16)
                   for h, s in ((hq, sq), (hkv, skv), (hkv, skv)))
        kw = dict(causal=causal, window=window, q_offset=skv - sq)
        launches, copies = flash.LAUNCHES, flash.ALIGN_COPIES
        got = flash.flash_attention(q, k, v, **kw)
        assert flash.LAUNCHES == launches + 1 and flash.ALIGN_COPIES == copies
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        _check_bf16(got, ref.attention(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_bf16_flash_kernel_reads_the_models_transposed_views_in_place(cuda_device, d):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v = (torch.randn((2, 150, h, d), generator=gen, device=cuda_device)
               .to(torch.bfloat16).transpose(1, 2) for h in (8, 2, 2))
    copies = flash.ALIGN_COPIES
    got = flash.flash_attention(q, k, v)
    assert flash.ALIGN_COPIES == copies
    assert got.stride() == q.stride()
    _check_bf16(got, ref.attention(q, k, v))


@pytest.mark.cuda
def test_bf16_flash_kernel_copies_an_unaligned_view_once(cuda_device):
    """q starts one element into its storage and its rows are 129 elements
    apart: the wrapper copies it (one count) and the kernel still runs."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q = torch.randn((1, 4, 90, 129), generator=gen, device=cuda_device).to(torch.bfloat16)[..., 1:]
    k, v = (torch.randn((1, 2, 90, 128), generator=gen, device=cuda_device).to(torch.bfloat16)
            for _ in range(2))
    assert not flash.copies_in_place(q) and flash.copies_in_place(k)
    launches, copies = flash.LAUNCHES, flash.ALIGN_COPIES
    got = flash.flash_attention(q, k, v, window=40)
    assert flash.LAUNCHES == launches + 1 and flash.ALIGN_COPIES == copies + 1
    _check_bf16(got, ref.attention(q, k, v, window=40))


@pytest.mark.cuda
def test_smoke_model_prefill_through_the_kernel_matches_plain_attention(cuda_device):
    cfg = smoke_config("phi4-mini-3.8b")
    kernel = build_model(cfg, ModelOptions(activation_dtype="float32"), device=cuda_device)
    plain = build_model(cfg, ModelOptions(attn_impl="ref", activation_dtype="float32"),
                        device=cuda_device)
    params = kernel.init(torch.Generator(device=cuda_device).manual_seed(0))
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 70)),
                        device=cuda_device)
    before = flash.LAUNCHES
    got, _ = kernel.prefill_fn(params, {"tokens": toks})
    assert flash.LAUNCHES == before + cfg.n_layers
    want, _ = plain.prefill_fn(params, {"tokens": toks})
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


# (arch, flash launches of one prefill): a MoE layer's attention, the vlm's
# 14 / 2 heads (GQA group 7 at full width), whisper's encoder (non-causal),
# decoder self-attention and cross attention (Sq != Skv) in each layer.
FAMILY_LAUNCHES = (("mixtral-8x7b", 2), ("qwen3-moe-235b-a22b", 2), ("internvl2-1b", 2),
                   ("whisper-base", 6))


@pytest.mark.cuda
@pytest.mark.parametrize("arch, launches", FAMILY_LAUNCHES)
@pytest.mark.parametrize("moe_impl", ["dense", "ragged_local"])
def test_smoke_family_prefill_through_the_kernel_matches_plain_attention(cuda_device, arch,
                                                                         launches, moe_impl):
    """Phase 31 (b) of chip_smoke.py at the smoke size: the moe, vlm and
    audio prefills launch flash once per attention call and give the plain
    path's logits, routing the same tokens to the same experts."""
    from repro_torch.launch.serve import make_batch
    from repro_torch.models import moe

    cfg = smoke_config(arch)
    if moe_impl != "dense" and not cfg.n_experts:
        pytest.skip("no MoE layer")
    opts = dict(activation_dtype="float32", moe_impl=moe_impl)
    kernel = build_model(cfg, ModelOptions(**opts), device=cuda_device)
    plain = build_model(cfg, ModelOptions(attn_impl="ref", **opts), device=cuda_device)
    params = kernel.init(torch.Generator(device=cuda_device).manual_seed(0))
    batch = make_batch(cfg, 2, 40, cuda_device)
    before = flash.LAUNCHES
    with moe.recording_routes() as routes:
        got, _ = kernel.prefill_fn(params, batch)
    assert flash.LAUNCHES == before + launches
    with moe.recording_routes() as plain_routes:
        want, _ = plain.prefill_fn(params, batch)
    for (a, _), (b, _) in zip(routes, plain_routes, strict=True):
        assert torch.equal(a, b)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


# -------------------------------------------------------------------- SSD
SSD_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
           torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
# (b, s, h, p, n): the shapes of tests/test_kernels.py (ragged, a sequence
# shorter than a chunk), fewer steps than the conv width, a single step, and
# a few chunks of the mamba2-130m widths.
SSD_CASES = ((1, 128, 2, 32, 16), (2, 200, 3, 32, 16), (1, 64, 1, 64, 128), (2, 96, 4, 16, 8),
             (2, 2, 3, 16, 16), (1, 1, 2, 64, 128), (2, 333, 24, 64, 128))


def _ssd_inputs(gen, device, dtype, b, s, h, p, n):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    x = randn(b, s, h, p).to(dtype)
    dt = torch.rand((b, s, h), generator=gen, device=device) * 0.19 + 0.01
    a = -(torch.rand((h,), generator=gen, device=device) * 1.5 + 0.5)
    return x, dt, a, randn(b, s, n).to(dtype), randn(b, s, n).to(dtype), randn(h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain_version_on_card(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for case in SSD_CASES:
        args = _ssd_inputs(gen, cuda_device, dtype, *case)
        before = ssd_kernel.LAUNCHES
        y, st = ops.ssd(*args, impl="cuda", return_state=True)
        assert ssd_kernel.LAUNCHES == before + 1
        assert y.dtype == dtype and y.shape == args[0].shape
        assert st.dtype == torch.float32 and st.shape == (case[0], case[2], case[3], case[4])
        for plain in (chunked.ssd, ref.ssd):
            y0, st0 = plain(*args, return_state=True)
            torch.testing.assert_close(y.float(), y0.float(), **SSD_TOL[dtype])
            torch.testing.assert_close(st, st0, **STATE_TOL)


@pytest.mark.cuda
def test_ssd_kernel_takes_strided_slices(cuda_device):
    """x, b and c as slices of one projection, as the model hands them."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    B, S, H, P, N = 2, 150, 4, 32, 16
    xbc = torch.randn((B, S, H * P + 2 * N), generator=gen, device=cuda_device)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    bm, cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.rand((B, S, H), generator=gen, device=cuda_device) * 0.1 + 0.01
    a = -torch.linspace(1.0, 4.0, H, device=cuda_device)
    d = torch.ones(H, device=cuda_device)
    assert not x.is_contiguous() and not bm.is_contiguous()
    y, st = ssd_kernel.ssd_scan(x, dt, a, bm, cm, d, return_state=True)
    y0, st0 = chunked.ssd(x, dt, a, bm, cm, d, return_state=True)
    torch.testing.assert_close(y, y0, **SSD_TOL[torch.float32])
    torch.testing.assert_close(st, st0, **STATE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_on_many_chunks_matches_chunked_at_its_chunk_length(cuda_device, dtype):
    """65 chunks, the last of 17 steps: the state pass carries across all of
    them; y and the state against the plain version at Q = 64."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    args = _ssd_inputs(gen, cuda_device, dtype, 2, 4096 + 17, 24, 64, 128)
    y, st = ssd_kernel.ssd_scan(*args, return_state=True)
    y0, st0 = chunked.ssd(*args, block=ssd_kernel.CHUNK, return_state=True)
    assert bool(torch.isfinite(y).all())
    torch.testing.assert_close(y.float(), y0.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(st, st0, **STATE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p, h", [(80, 3), (128, 5)])
def test_ssd_kernel_on_head_dims_of_two_slices(cuda_device, dtype, p, h):
    """P wider than one 64-channel slice (the second one partial at P = 80)
    and an odd number of heads, over 5 chunks: y and the state against the
    plain version at Q = 64."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    args = _ssd_inputs(gen, cuda_device, dtype, 2, 300, h, p, 64)
    y, st = ssd_kernel.ssd_scan(*args, return_state=True)
    y0, st0 = chunked.ssd(*args, block=ssd_kernel.CHUNK, return_state=True)
    assert bool(torch.isfinite(y).all()) and st.shape == (2, h, p, 64)
    torch.testing.assert_close(y.float(), y0.float(), **SSD_TOL[dtype])
    torch.testing.assert_close(st, st0, **STATE_TOL)


@pytest.mark.cuda
def test_ssd_kernel_takes_strided_slices_over_many_chunks(cuda_device):
    """The mamba2 widths as slices of one projection (x, b, c at offsets
    that are not 16-byte multiples of each other), over 9 chunks."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    B, S, H, P, N = 2, 513, 24, 64, 128
    xbc = torch.randn((B, S, H * P + 2 * N + 1), generator=gen, device=cuda_device)[..., 1:]
    x = xbc[..., :H * P].reshape(B, S, H, P)
    bm, cm = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.rand((B, S, H), generator=gen, device=cuda_device) * 0.19 + 0.01
    a = -(torch.rand((H,), generator=gen, device=cuda_device) * 1.5 + 0.5)
    d = torch.randn((H,), generator=gen, device=cuda_device)
    assert not x.is_contiguous() and x.data_ptr() % 16
    y, st = ssd_kernel.ssd_scan(x, dt, a, bm, cm, d, return_state=True)
    y0, st0 = chunked.ssd(x, dt, a, bm, cm, d, block=ssd_kernel.CHUNK, return_state=True)
    torch.testing.assert_close(y, y0, **SSD_TOL[torch.float32])
    torch.testing.assert_close(st, st0, **STATE_TOL)


@pytest.mark.cuda
def test_ssd_kernel_refuses_what_it_does_not_take(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x, dt, a, bm, cm, d = _ssd_inputs(gen, cuda_device, torch.float32, 1, 8, 2, 16, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_kernel.ssd_scan(x.cpu(), dt, a, bm, cm, d)
    with pytest.raises(ValueError, match="rank"):
        ssd_kernel.ssd_scan(x[0], dt, a, bm, cm, d)
    with pytest.raises(TypeError):
        ssd_kernel.ssd_scan(x.half(), dt, a, bm.half(), cm.half(), d)
    with pytest.raises(TypeError):
        ssd_kernel.ssd_scan(x, dt, a, bm.bfloat16(), cm, d)
    with pytest.raises(TypeError):
        ssd_kernel.ssd_scan(x, dt.double(), a, bm, cm, d)
    with pytest.raises(ValueError, match="multiple of 16"):
        ssd_kernel.ssd_scan(x[..., :8], dt, a, bm, cm, d)
    wide = torch.zeros((1, 8, ssd_kernel.MAX_STATE + 1), device=cuda_device)
    with pytest.raises(ValueError, match="N <="):
        ssd_kernel.ssd_scan(x, dt, a, wide, wide, d)


@pytest.mark.cuda
def test_smoke_mamba2_prefill_through_the_kernel_matches_chunked(cuda_device):
    cfg = smoke_config("mamba2-130m")
    kernel = build_model(cfg, ModelOptions(activation_dtype="float32"), device=cuda_device)
    plain = build_model(cfg, ModelOptions(mixer_impl="chunked", activation_dtype="float32"),
                        device=cuda_device)
    params = kernel.init(torch.Generator(device=cuda_device).manual_seed(0))
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 150)),
                        device=cuda_device)
    before = ssd_kernel.LAUNCHES
    got, caches = kernel.prefill_fn(params, {"tokens": toks})
    assert ssd_kernel.LAUNCHES == before + cfg.n_layers
    want, want_caches = plain.prefill_fn(params, {"tokens": toks})
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    for c, c0 in zip(caches["blocks"], want_caches["blocks"]):
        torch.testing.assert_close(c["sub0"]["ssm"], c0["sub0"]["ssm"], **STATE_TOL)
    before = ssd_kernel.LAUNCHES  # a 1-token prompt runs the kernel too
    got, _ = kernel.prefill_fn(params, {"tokens": toks[:, :1]})
    assert ssd_kernel.LAUNCHES == before + cfg.n_layers
    torch.testing.assert_close(got, plain.prefill_fn(params, {"tokens": toks[:, :1]})[0],
                               rtol=2e-4, atol=2e-4)


# ----------------------------------------------------------------- RG-LRU
# (b, s, w, a_param shift): the shapes of tests/test_kernels.py, one step, a
# width not a multiple of the 128-channel block, and decay within ~1e-3 of 1
# over 4096 steps.
RGLRU_CASES = ((2, 100, 48, 0.0), (1, 256, 64, 0.0), (2, 64, 128, 0.0), (3, 1, 40, 0.0),
               (2, 77, 200, 0.0), (1, 4096, 256, -9.0))


def _rglru_inputs(gen, device, dtype, b, s, w, shift):
    x, gx, ga = (torch.randn((b, s, w), generator=gen, device=device).to(dtype)
                 for _ in range(3))
    return x, gx, ga, torch.randn((w,), generator=gen, device=device) + shift


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_kernel_matches_plain_version_on_card(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for b, s, w, shift in RGLRU_CASES:
        x, gx, ga, ap = _rglru_inputs(gen, cuda_device, dtype, b, s, w, shift)
        a, g = (t.to(dtype) for t in ref.rglru_gates(x, gx, ga, ap))
        before = rglru_kernel.LAUNCHES
        y, st = rglru_kernel.rglru_scan(a, g, return_state=True)
        assert rglru_kernel.LAUNCHES == before + 1
        assert y.dtype == dtype and y.shape == (b, s, w)
        assert st.dtype == torch.float32 and st.shape == (b, w)
        assert torch.equal(st, y[:, -1].float())
        assert st.untyped_storage().nbytes() == st.numel() * 4  # not a view of y
        assert torch.equal(y, ref.linear_recurrence(a, g))
        y0 = chunked.linear_scan(a.float(), g.float()).to(dtype)
        torch.testing.assert_close(y.float(), y0.float(), **SSD_TOL[dtype])
        torch.testing.assert_close(st, y0[:, -1].float(), **STATE_TOL)
        yk, stk = ops.rglru(x, gx, ga, ap, impl="cuda", return_state=True)
        assert rglru_kernel.LAUNCHES == before + 2
        assert torch.equal(yk, y) and torch.equal(stk, st)
        if dtype == torch.float32:
            yr, str_ = chunked.rglru(x, gx, ga, ap, return_state=True)
            torch.testing.assert_close(yk, yr, **SSD_TOL[dtype])
            torch.testing.assert_close(stk, str_, **STATE_TOL)


@pytest.mark.cuda
def test_rglru_kernel_refuses_what_it_does_not_take(cuda_device):
    a = torch.rand((2, 8, 16), device=cuda_device)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rglru_kernel.rglru_scan(a.cpu(), a)
    with pytest.raises(ValueError, match="contiguous"):
        rglru_kernel.rglru_scan(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        rglru_kernel.rglru_scan(a[0], a[0])
    with pytest.raises(TypeError):
        rglru_kernel.rglru_scan(a.half(), a.half())
    with pytest.raises(TypeError):
        rglru_kernel.rglru_scan(a, a.bfloat16())
    with pytest.raises(ValueError, match="do not fit"):
        rglru_kernel.rglru_scan(a, a[:, :4].contiguous())


@pytest.mark.cuda
def test_smoke_recurrentgemma_prefill_through_the_kernels_matches_chunked(cuda_device):
    """The smoke hybrid (rglru, rglru, attn): two RG-LRU launches and one
    flash launch a prefill, past the window of 16; logits and recurrent
    states as the log-depth scan's."""
    cfg = smoke_config("recurrentgemma-9b")
    kernel = build_model(cfg, ModelOptions(activation_dtype="float32"), device=cuda_device)
    plain = build_model(cfg, ModelOptions(mixer_impl="chunked", activation_dtype="float32"),
                        device=cuda_device)
    params = kernel.init(torch.Generator(device=cuda_device).manual_seed(0))
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 150)),
                        device=cuda_device)
    before = (rglru_kernel.LAUNCHES, flash.LAUNCHES)
    got, caches = kernel.prefill_fn(params, {"tokens": toks})
    assert (rglru_kernel.LAUNCHES, flash.LAUNCHES) == (before[0] + 2, before[1] + 1)
    want, want_caches = plain.prefill_fn(params, {"tokens": toks})
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    for c, c0 in zip(caches["blocks"], want_caches["blocks"]):
        for sub in ("sub0", "sub1"):
            torch.testing.assert_close(c[sub]["h"], c0[sub]["h"], **STATE_TOL)


# -------------------------------------------------------------- training
# The chunked attention's hand-written backward on the card (the kernels have
# none): float32, against autograd through the plain version, at the bar of
# tests/test_torch_chunked_attention.py (relative norm 2e-5); chip_smoke.py
# phase 29 (a) runs the same check at the training shapes.
@pytest.mark.cuda
@pytest.mark.parametrize("b, hq, hkv, s, d, window", [
    (2, 24, 8, 600, 128, 0), (1, 16, 1, 1500, 256, 512),
])
def test_chunked_attention_vjp_matches_plain_autograd_on_card(cuda_device, b, hq, hkv, s, d,
                                                              window):
    gen = torch.Generator(device=cuda_device).manual_seed(29)
    q, do = (torch.randn((b, hq, s, d), generator=gen, device=cuda_device) for _ in range(2))
    k, v = (torch.randn((b, hkv, s, d), generator=gen, device=cuda_device) for _ in range(2))
    runs = []
    for fn in (chunked.attention, ref.attention):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, causal=True, window=window)
        out.backward(do)
        runs.append([out.detach()] + [t.grad for t in leaves])
    for got, want in zip(*runs):
        assert ((got - want).norm() / want.norm()).item() <= 2e-5
    for impl in ("cuda", "auto"):  # no backward: the card never takes another route
        with pytest.raises(RuntimeError, match="chunked"):
            ops.attention(q.clone().requires_grad_(True), k, v, impl=impl)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "mamba2-130m", "recurrentgemma-9b"])
def test_smoke_train_steps_on_card_match_the_cpu(cuda_device, arch):
    """A smoke model (the mixers' chunked paths under autograd) on the card
    and on the CPU from the same parameters and batches, float32: the first
    step's gradient, each leaf by relative norm, its grad norm, and two train
    steps' losses and parameters within 1e-5 relative (phase 29 (d))."""
    from repro_torch.data.pipeline import make_stream_for
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.tree import leaves, tree_map

    cfg = smoke_config(arch)
    opts = ModelOptions(attn_impl="chunked", mixer_impl="chunked", activation_dtype="float32",
                        remat="none")
    tc = TrainConfig(optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=4))
    init = build_model(cfg, opts, device="cpu").init(torch.Generator().manual_seed(29))
    stream = make_stream_for(cfg, 64, 4)
    runs = []
    for dev in ("cpu", cuda_device):
        model = build_model(cfg, opts, device=dev)
        params = tree_map(lambda t: t.to(dev, copy=True), init)
        alias = tree_map(lambda t: t.detach().requires_grad_(True), params)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in stream.batch(0).items()}
        grads = torch.autograd.grad(model.loss_fn(alias, batch)[0], leaves(alias))
        state = init_opt_state(params)
        step = make_train_step(model, tc)
        losses, norms = [], []
        for i in range(2):
            params, state, metrics = step(params, state, stream.batch(i))
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
        runs.append((losses, norms, [g.cpu() for g in grads], [t.cpu() for t in leaves(params)]))
    (lc, nc, gc, pc), (lg, ng, gg, pg) = runs

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    for a, b in zip(lg + ng, lc + nc):
        assert abs(a - b) <= 1e-5 * abs(b)
    for a, b in zip(gg, gc, strict=True):
        assert rel(a, b) <= 1e-5
    assert rel(torch.cat([t.flatten() for t in pg]), torch.cat([t.flatten() for t in pc])) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b"])
def test_ragged_local_backward_twice_is_bit_for_bit_on_card(cuda_device, arch):
    """``models/moe.py::_ragged``'s backward gathers and scatters by unique
    indices only, so it adds no two values with float atomics: two backward
    passes of the smoke configs' MoE layer agree bit for bit on the card
    (``tests/torch_moe_twice.py``, which the CPU test runs too)."""
    from torch_moe_twice import ragged_local_twice

    runs = ragged_local_twice(smoke_config(arch), cuda_device)
    for a, b in zip(*runs, strict=True):
        assert torch.equal(a, b)
