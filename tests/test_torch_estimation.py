"""The port's single-class online estimation against the JAX package's.

The mirror of the single-class tests of ``tests/test_estimation.py`` and of
three properties of ``tests/test_estimation_properties.py``, with the NumPy
``repro.sched.estimator`` as the oracle where the JAX tests use it, and
JAX's ``repro.core.estimation`` on the same inputs:

- the recursive sufficient statistics against the NumPy history fit
  (forgetting, prior fallbacks, clip bounds) and the one-shot weighted OLS;
- the stateful-rule contract: a plain rule and its ``as_stateful`` wrapper
  are the same loop bit for bit;
- ``estimating_rule`` and ``simulate_scenario_estimated`` against JAX's on
  JAX's tapes (flows within ``RTOL = 1e-12`` relative, continuous and whole
  chips, under drift), and the three arms' order on a drift stream;
- estimation noise: ``simulate_scenario`` with JAX's ``size_factors`` /
  ``p_hat``, noisy sweeps and the three arms of ``Sweep(arm=)`` through
  ``simulate_cells`` on the JAX sampler's tapes and noise against JAX's
  ``run_sweep`` (every column, the ``tel_*`` ones of an estimator sweep
  included); the port's noise draws in distribution;
- the class-pooled fit (``p_hat_classes``) on the NumPy estimator's
  pooled twin (the multi-class estimator against JAX is held in
  ``tests/test_torch_multiclass.py``); what stays refused: per-class sigma
  sequences on a one-class scenario, arms with ``n_chips``/``fused``/
  ``stream``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import assume, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import engine as je  # noqa: E402
from repro.core import estimation as jes  # noqa: E402
from repro.core import sweeps as js  # noqa: E402
from repro.core import telemetry as jt  # noqa: E402
from repro.core.arrivals import simulate_scenario as jax_simulate_scenario  # noqa: E402
from repro.core.policies import make_policy as jax_make_policy  # noqa: E402
from repro.core.scenarios import make_scenario  # noqa: E402
from repro.sched.estimator import SpeedupEstimator, blended_p  # noqa: E402
from repro_torch.core import arrivals as ta  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import estimation as tes  # noqa: E402
from repro_torch.core import policies as tp  # noqa: E402
from repro_torch.core import scenarios as tsc  # noqa: E402
from repro_torch.core import sweeps as tsw  # noqa: E402
from repro_torch.core import telemetry as tt  # noqa: E402

RTOL = 1e-12


def _t(v, dtype=torch.float64):
    return torch.as_tensor(np.array(v), dtype=dtype)


def _obs(chips, rate, active=None, dt=1.0):
    chips = _t(chips)
    return te.Observation(alloc=chips, rate=_t(rate), dt=torch.tensor(dt, dtype=torch.float64),
                          active=torch.ones(chips.shape, dtype=torch.bool)
                          if active is None else torch.as_tensor(active))


def _fold(samples, discount):
    state = tes.init_est_state(1, device="cpu")
    for k, t in samples:
        state = tes.observe_throughput(state, _obs([k], [t]), discount=discount)
    return state


def _observe_seq(rng, n_obs, p, c=2.0, noise=0.0):
    ks = rng.uniform(1.0, 64.0, n_obs)
    ts = c * ks ** p * np.exp(noise * rng.standard_normal(n_obs))
    return ks, ts


# ------------------------------------------------- NumPy <-> port agreement
@pytest.mark.parametrize("discount", [1.0, 0.9, 0.5])
def test_rls_matches_numpy_estimator_and_jax(discount):
    """The sufficient-statistics fit equals the NumPy history fit (forgetting,
    prior fallbacks) and JAX's state, field by field."""
    rng = np.random.default_rng(0)
    M = 7
    prior_p = rng.uniform(0.2, 0.8, M)
    prior_w = rng.uniform(0.1, 3.0, M)
    ests = [SpeedupEstimator(prior_p=float(prior_p[j]), prior_weight=float(prior_w[j]),
                             discount=discount) for j in range(M)]
    state = tes.init_est_state(M, device="cpu")
    jstate = jes.init_est_state(M, jnp.float64)
    for _ in range(12):
        chips = rng.uniform(0.0, 32.0, M)
        chips[rng.random(M) < 0.25] = 0.0  # queued jobs learn nothing
        rate = 1.7 * chips ** 0.6
        for j in range(M):
            ests[j].observe(chips[j], rate[j])
        state = tes.observe_throughput(state, _obs(chips, rate, dt=0.5), discount=discount)
        jstate = jes.observe_throughput(jstate, je.Observation(
            alloc=jnp.asarray(chips), rate=jnp.asarray(rate), dt=jnp.asarray(0.5),
            active=jnp.ones(M, bool)), discount=discount)
    for got, want in zip(state, jstate, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-13)
    got = tes.p_hat_jobs(state, _t(prior_p), prior_weight=_t(prior_w)).numpy()
    np.testing.assert_allclose(got, [e.p_hat() for e in ests], rtol=1e-9, atol=1e-12)
    x_rem = rng.uniform(0.5, 5.0, M)
    got_b = float(tes.blended_p_hat(state, _t(x_rem), _t(prior_p), prior_weight=_t(prior_w)))
    np.testing.assert_allclose(got_b, blended_p(ests, x_rem), rtol=1e-9)


def test_recursive_wls_equals_batch_ols():
    rng = np.random.default_rng(1)
    for _ in range(25):
        n_obs = int(rng.integers(2, 40))
        discount = float(rng.uniform(0.5, 1.0))
        ks, ts = _observe_seq(rng, n_obs, rng.uniform(0.1, 0.9), noise=0.3)
        state = _fold(zip(ks, ts, strict=True), discount)
        got = float(tes.p_hat_jobs(state, 0.5, prior_weight=1e-12)[0])
        w = discount ** np.arange(n_obs - 1, -1, -1, dtype=np.float64)
        lk, lt = np.log(ks), np.log(ts)
        mk = (w * lk).sum() / w.sum()
        mt = (w * lt).sum() / w.sum()
        slope = (w * (lk - mk) * (lt - mt)).sum() / (w * (lk - mk) ** 2).sum()
        np.testing.assert_allclose(got, np.clip(slope, 0.01, 0.999), rtol=1e-8, atol=1e-10)


def test_p_hat_prior_fallback_and_clip_bounds():
    state = tes.init_est_state(1, device="cpu")
    assert float(tes.p_hat_jobs(state, 0.42)[0]) == 0.42
    state = _fold([(8.0, 3.0), (8.0, 3.0)], 1.0)  # var == 0: the prior
    assert float(tes.p_hat_jobs(state, 0.42)[0]) == 0.42
    state = _fold([(2.0, 2.0 ** 4), (64.0, 64.0 ** 4)], 1.0)
    assert float(tes.p_hat_jobs(state, 0.5, prior_weight=1e-9)[0]) == tes.P_CLIP[1]
    assert tes.P_CLIP == jes.P_CLIP
    e = SpeedupEstimator(prior_p=0.5, prior_weight=1e-9)
    e.observe(2.0, 2.0 ** 4)
    e.observe(64.0, 64.0 ** 4)
    assert e.p_hat() == tes.P_CLIP[1]


def test_estimator_recovers_true_p_seeded():
    for p in (0.15, 0.5, 0.85):
        state = _fold([(k, 3.7 * k ** p) for k in (1, 2, 4, 8, 16, 32)], 1.0)
        assert abs(float(tes.p_hat_jobs(state, 0.5, prior_weight=1e-6)[0]) - p) < 0.02


def test_state_from_history_matches_jax():
    rng = np.random.default_rng(2)
    hist = [[(float(rng.normal()), float(rng.normal()), float(rng.uniform()))
             for _ in range(int(rng.integers(0, 5)))] for _ in range(6)]
    got = tes.est_state_from_history(hist, device="cpu")
    want = jes.est_state_from_history(hist)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.n.dtype == torch.int32


def test_multiclass_estimator_stays_refused():
    """The class-pooled estimator is ported: two jobs of one class, each with
    a 2-point history, pool into the NumPy ``pooled_p_hat`` fit of all four
    samples (tests/test_estimation.py's check), in both packages."""
    from repro.sched.estimator import pooled_p_hat

    p_true = 0.63
    a = SpeedupEstimator(prior_p=0.3, prior_weight=1e-9)
    b = SpeedupEstimator(prior_p=0.3, prior_weight=1e-9)
    for k in (2.0, 8.0):
        a.observe(k, k ** p_true)
    for k in (16.0, 64.0):
        b.observe(k, k ** p_true)
    pooled = pooled_p_hat([a, b], 0.3, 1e-9)
    state = tes.init_est_state(2, device="cpu")
    jstate = jes.init_est_state(2, jnp.float64)
    for ka, kb in ((2.0, 16.0), (8.0, 64.0)):
        state = tes.observe_throughput(state, _obs([ka, kb], [ka ** p_true, kb ** p_true]))
        jstate = jes.observe_throughput(jstate, je.Observation(
            alloc=jnp.asarray([ka, kb]), rate=jnp.asarray([ka ** p_true, kb ** p_true]),
            dt=jnp.asarray(1.0), active=jnp.ones(2, bool)))
    ids = torch.zeros(2, dtype=torch.int64)
    got = float(tes.p_hat_classes(state, ids, 1, 0.3, prior_weight=1e-9)[0])
    want = float(jes.p_hat_classes(jstate, jnp.zeros(2, jnp.int32), 1, 0.3,
                                   prior_weight=1e-9)[0])
    np.testing.assert_allclose(got, pooled, rtol=1e-9)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert int(tes.pool_by_class(state, ids, 1).n[0]) == 4


# ------------------------------------------------------ stateful-rule engine
def test_stateless_rule_and_as_stateful_are_bit_for_bit():
    rng = np.random.default_rng(3)
    x = _t(rng.pareto(1.5, 24) + 1.0)
    arr = _t(np.cumsum(rng.exponential(0.5, 24)))
    plain = te.continuous_rule(tp.hesrpt, 64.0)
    wrapped = te.as_stateful(plain)
    explicit = te.StatefulRule(init=lambda: (), observe=lambda st, obs: st,
                               allocate=lambda st, x_act, p: plain(x_act, p))
    a = te.run(x, arr, 0.5, plain, record=True)
    for other in (te.run(x, arr, 0.5, wrapped, record=True),
                  te.run(x, arr, 0.5, explicit, record=True)):
        assert torch.equal(a.completion_times, other.completion_times)
        assert torch.equal(a.trace.alloc, other.trace.alloc)
        assert torch.equal(a.trace.times, other.trace.times)
    assert te.as_stateful(wrapped) is wrapped


@pytest.mark.parametrize("n_chips", [None, 48])
def test_estimating_rule_converges_and_matches_jax(n_chips):
    """A batch with a wrong prior: allocations a distribution, the run no
    better than the known-p run, and every event's allocation as JAX's."""
    rng = np.random.default_rng(4)
    x = rng.pareto(1.5, 30) + 1.0
    arr = np.zeros(30)
    p_true = 0.7
    kw = dict(prior_p=0.3, prior_weight=1.0, discount=1.0, n_jobs=30, n_chips=n_chips)
    rule = tes.estimating_rule(tp.hesrpt, 128.0, device="cpu", **kw)
    jrule = jes.estimating_rule(jax_make_policy("hesrpt"), 128.0, dtype=jnp.float64, **kw)
    res = te.run(_t(x), _t(arr), p_true, rule, pre_arrived=True, horizon=30, record=True)
    want = je.run(x, arr, p_true, jrule, pre_arrived=True, horizon=30, record=True)
    np.testing.assert_allclose(res.completion_times.numpy(), np.asarray(want.completion_times),
                               rtol=RTOL, atol=0)
    if n_chips is None:
        np.testing.assert_allclose(res.trace.alloc.numpy(), np.asarray(want.trace.alloc),
                                   rtol=RTOL, atol=1e-15)
        theta = res.trace.alloc.numpy()
        live = res.trace.sizes.numpy() > 0
        assert np.all(theta.sum(axis=1)[live.any(axis=1)] <= 1 + 1e-9)
        assert np.all(theta >= -1e-12)
        oracle = ta.simulate_online(_t(x), _t(arr), p_true, 128.0, tp.hesrpt, device="cpu")
        assert float(oracle.total_flowtime) <= float(res.completion_times.sum()) * (1 + 1e-9)
    else:
        assert torch.equal(res.trace.alloc, torch.as_tensor(np.array(want.trace.alloc)))
    assert bool(torch.isfinite(res.completion_times).all())


def test_drift_single_job_exact():
    rule = te.continuous_rule(tp.hesrpt, 16.0)
    x = torch.tensor([10.0], dtype=torch.float64)
    t_d, p0, p1 = 0.75, 0.8, 0.2
    drift = te.PDrift(torch.tensor([t_d], dtype=torch.float64),
                      torch.tensor([p0, p1], dtype=torch.float64))
    res = te.run(x, torch.zeros(1, dtype=torch.float64), p0, rule, pre_arrived=True,
                 p_drift=drift)
    expect = t_d + (10.0 - t_d * 16 ** p0) / 16 ** p1
    np.testing.assert_allclose(float(res.completion_times[0]), expect, rtol=1e-12)


@functools.lru_cache(maxsize=None)
def _drift_scn(seed=2, n_jobs=80, rate=4.0, **noise):
    scn = make_scenario("drift_poisson", p0=0.8, p1=0.3, drift_frac=0.4, **noise)(
        jax.random.PRNGKey(seed), n_jobs, rate)
    return scn


def _port_scn(scn):
    return tsc.Scenario(
        _t(scn.x0), _t(scn.arrival_times),
        p_drift=te.PDrift(_t(scn.p_drift.times), _t(scn.p_drift.values)),
        size_factors=None if scn.size_factors is None else _t(scn.size_factors),
        p_hat=None if scn.p_hat is None else _t(scn.p_hat),
    )


def test_drift_scenario_arms_order_and_match_jax():
    """oracle <= estimator < stale on a drift stream, each arm's flows as
    JAX's on the same scenario."""
    scn_j = _drift_scn()
    scn = _port_scn(scn_j)
    pol = tp.hesrpt
    jpol = jax_make_policy("hesrpt", n_servers=128.0)
    oracle = ta.simulate_scenario(scn, 0.8, 128.0, pol, device="cpu")
    stale = ta.simulate_scenario(scn._replace(p_hat=0.8), 0.8, 128.0, pol, device="cpu")
    est = tes.simulate_scenario_estimated(scn, 0.8, 128.0, pol, prior_p=0.8, discount=0.9,
                                          device="cpu")
    wants = (jax_simulate_scenario(scn_j, 0.8, 128.0, jpol),
             jax_simulate_scenario(scn_j._replace(p_hat=jnp.asarray(0.8)), 0.8, 128.0, jpol),
             jes.simulate_scenario_estimated(scn_j, 0.8, 128.0, jpol, prior_p=0.8,
                                             discount=0.9))
    for got, want in zip((oracle, stale, est), wants, strict=True):
        np.testing.assert_allclose(got.flow_times.numpy(), np.asarray(want.flow_times),
                                   rtol=RTOL, atol=0)
    f_o, f_s, f_e = (float(r.mean_flowtime) for r in (oracle, stale, est))
    assert f_o <= f_e * (1 + 1e-9)
    assert f_e < f_s


@pytest.mark.parametrize("n_chips", [None, 32])
def test_simulate_scenario_estimated_with_probe_matches_jax(n_chips):
    """The estimator with a p_hat_err series probe: flows and every event's
    p-hat error as JAX's, whole chips included."""
    scn_j = _drift_scn(seed=3, n_jobs=40, rate=2.0)
    metrics = ("p_hat_err", "queue")
    got, tel = tes.simulate_scenario_estimated(
        _port_scn(scn_j), 0.8, 64.0, tp.hesrpt, prior_p=0.6, discount=0.9, n_chips=n_chips,
        device="cpu", telemetry=tt.make_probe(
            metrics, mode="series", p_hat_reader=tt.p_hat_error_metric(0.6),
            alloc_unit=float(n_chips or 1.0)))
    want, jtel = jes.simulate_scenario_estimated(
        scn_j, 0.8, 64.0, jax_make_policy("hesrpt", n_servers=64.0), prior_p=0.6,
        discount=0.9, n_chips=n_chips, telemetry=jt.make_probe(
            metrics, mode="series", dtype=jnp.float64, alloc_unit=float(n_chips or 1.0),
            p_hat_reader=jt.p_hat_error_metric(0.6)))
    np.testing.assert_allclose(got.flow_times.numpy(), np.asarray(want.flow_times),
                               rtol=RTOL, atol=0)
    for k in ("t", "dt", *metrics):
        np.testing.assert_allclose(tel.series[k].numpy(), np.asarray(jtel.series[k]),
                                   rtol=RTOL, atol=1e-12, err_msg=k)


# ---------------------------------------------------------- estimation noise
@pytest.mark.parametrize("kind", ["continuous", "quantized", "fused"])
def test_noisy_scenario_matches_jax(kind):
    """JAX's size factors and p_hat through the port's simulate_scenario:
    the policy sees the noise, the physics do not."""
    scn_j = make_scenario("poisson", p=0.5, sigma_size=0.4, sigma_p=0.1)(
        jax.random.PRNGKey(5), 40, 2.0)
    assert scn_j.size_factors is not None and scn_j.p_hat is not None
    n_chips = None if kind == "continuous" else 32
    scn = tsc.Scenario(_t(scn_j.x0), _t(scn_j.arrival_times),
                       size_factors=_t(scn_j.size_factors), p_hat=_t(scn_j.p_hat))
    got = ta.simulate_scenario(scn, 0.5, 32.0, tp.hesrpt, n_chips=n_chips,
                               fused=kind == "fused", device="cpu")
    want = jax_simulate_scenario(scn_j, 0.5, 32.0, jax_make_policy("hesrpt"), n_chips=n_chips,
                                 fused=kind == "fused")
    np.testing.assert_allclose(got.flow_times.numpy(), np.asarray(want.flow_times),
                               rtol=RTOL, atol=0)
    clean = ta.simulate_scenario(scn._replace(size_factors=None, p_hat=None), 0.5, 32.0,
                                 tp.hesrpt, n_chips=n_chips, device="cpu")
    assert not torch.equal(clean.flow_times, got.flow_times)


def test_port_noise_in_distribution():
    """The port's noise draws: lognormal factors with log-sd sigma_size and
    median 1, shared by the rate axis; p_hat centered on p, clipped."""
    n = 100_000
    sampler = tsc.make_scenario("poisson", p=0.5, sigma_size=0.3, sigma_p=0.1)
    scn = sampler(tsc.seed_generator(0, 0, device="cpu"), n, (1.0, 4.0))
    assert scn.size_factors.shape == (2, n) and scn.p_hat.shape == (2, 1)
    assert torch.equal(scn.size_factors[0], scn.size_factors[1])
    assert torch.equal(scn.p_hat[0], scn.p_hat[1])
    lf = scn.size_factors[0].log()
    assert float(lf.std()) == pytest.approx(0.3, rel=0.02)
    assert abs(float(lf.mean())) < 0.005
    hats = torch.stack([
        sampler(tsc.seed_generator(0, s, device="cpu"), 8, 1.0).p_hat.reshape(())
        for s in range(400)])
    assert float(hats.mean()) == pytest.approx(0.5, abs=0.02)
    assert float(hats.std()) == pytest.approx(0.1, rel=0.15)
    assert bool(((hats >= 0.05) & (hats <= 0.95)).all())
    plain = tsc.make_scenario("poisson")(tsc.seed_generator(0, 0, device="cpu"), n, (1.0, 4.0))
    assert torch.equal(plain.x0, scn.x0) and plain.size_factors is None  # base draw first


def _jax_sweep_tapes(spec):
    """The JAX sweep's tapes, drift times and noise, ``[R, S, ...]``."""
    keys = jax.random.split(jax.random.PRNGKey(spec.seed), spec.n_seeds)
    sample = make_scenario(spec.scenario, size_alpha=spec.size_alpha, p=spec.p,
                           **dict(spec.scenario_kw))
    cells = [[sample(k, spec.n_jobs, r) for k in keys] for r in spec.rates]

    def grid(field, f=np.asarray):
        if getattr(cells[0][0], field) is None:
            return None
        return np.asarray([[f(getattr(c, field)) for c in row] for row in cells])

    drift = None
    if cells[0][0].p_drift is not None:
        drift = te.PDrift(grid("p_drift", lambda d: np.asarray(d.times)),
                          np.asarray(cells[0][0].p_drift.values))
    p_hat = grid("p_hat", lambda v: np.asarray(v).reshape(1))
    return dict(x0=grid("x0"), arr=grid("arrival_times"), p_drift=drift,
                size_factors=grid("size_factors"), p_hat=p_hat)


def _assert_sweep_matches_jax(jspec):
    res_j = js.run_sweep(jspec, log=False)
    spec = tsw.Sweep.from_spec_dict(res_j.record()["spec"])
    tapes = _jax_sweep_tapes(jspec)
    got = tsw.simulate_cells(spec, tapes.pop("x0"), tapes.pop("arr"), device="cpu", **tapes)
    for name in spec.policies:
        assert set(got[name]) == set(res_j.stats[name]) == set(spec.out_names())
        for col in spec.out_names():
            want = np.asarray(res_j.stats[name][col])
            assert got[name][col].shape == want.shape, col
            np.testing.assert_allclose(got[name][col], want, rtol=RTOL, atol=1e-12,
                                       err_msg=f"{name} {col}")
    return spec, got


@pytest.mark.parametrize("n_chips", [None, 32])
def test_noisy_sweep_matches_jax_on_its_tapes(n_chips):
    _assert_sweep_matches_jax(js.Sweep.create(
        ("hesrpt", "equi"), (1.0, 8.0), scenario="bursty",
        scenario_kw={"sigma_size": 0.3, "sigma_p": 0.15}, n_jobs=24, n_seeds=2,
        n_servers=32.0, n_chips=n_chips, metrics=("mean_flowtime", "mean_slowdown")))


@pytest.mark.parametrize("arm", ["oracle", "stale", "estimator"])
@pytest.mark.parametrize("scenario", ["drift_poisson", "drift_bursty"])
def test_arm_sweep_matches_jax_on_its_tapes(scenario, arm):
    """benchmarks/estimation.py's sweep spec, cut to size, each arm's flows
    as JAX's on its tapes."""
    _assert_sweep_matches_jax(js.Sweep.create(
        ("hesrpt",), (0.5, 8.0), scenario=scenario,
        scenario_kw={"p0": 0.8, "p1": 0.3, "drift_frac": 0.5}, n_jobs=30, n_seeds=2, p=0.8,
        n_servers=64.0, arm=arm, arm_kw={"discount": 0.9, "prior_weight": 1.0}))


def test_estimator_telemetry_sweep_matches_jax_on_its_tapes():
    """Sweep(telemetry=..., arm="estimator") gives JAX's tel_* and flow
    columns (benchmarks/telemetry.py's estimator arm, cut to size)."""
    spec, got = _assert_sweep_matches_jax(js.Sweep.create(
        ["hesrpt"], [2.0, 4.0], scenario="drift_poisson", scenario_kw={"p0": 0.7, "p1": 0.3},
        n_jobs=30, n_seeds=2, arm="estimator",
        telemetry=("efficiency", "utilization", "queue", "p_hat_err")))
    err = got["hesrpt"]["tel_p_hat_err_mean"]
    assert spec.arm == "estimator" and np.all((err > 0) & (err <= 1.0))


def test_arm_and_noise_refusals():
    kw = dict(scenario="drift_poisson", scenario_kw={"p0": 0.8})
    for bad, match in (
        (dict(arm="guess", **kw), "unknown arm"),
        (dict(arm="stale", n_chips=16, **kw), "continuous-only"),
        (dict(arm="stale", scenario="drift_poisson"), "p0"),
        (dict(arm="estimator", n_chips=16, fused=True, **kw), "continuous-only"),
        (dict(arm="oracle", superstep=True, **kw), "single-class, arm-free"),
        (dict(arm="oracle", stream={"n_slots": 4}, **kw), "arm-free"),
        (dict(stream={"n_slots": 4}, scenario_kw={"sigma_size": 0.2}), "plain tape scenario"),
        (dict(superstep=True, scenario_kw={"sigma_p": 0.2}), "noise-free"),
    ):
        with pytest.raises(ValueError, match=match):
            tsw.Sweep.create(("hesrpt",), (1.0,), **bad)
    spec = tsw.Sweep.create(("hesrpt",), (1.0,), scenario_kw={"sigma_size": (0.3, 0.1)},
                            n_jobs=4, n_seeds=1)  # accepted, as by JAX; the draw refuses
    with pytest.raises(ValueError, match="per-class sigma needs a multi-class scenario"):
        tsw.run_sweep(spec, device="cpu")
    scn = tsc.make_scenario("poisson", sigma_size=0.2)(torch.Generator().manual_seed(0), 8, 1.0)
    with pytest.raises(ValueError, match="size_factors cannot stream"):
        ta.simulate_stream(scn, 0.5, 4.0, tp.hesrpt, n_slots=4, device="cpu")
    spec = tsw.Sweep.create(("hesrpt",), (1.0,), arm="estimator",
                            arm_kw={"discount": 0.9}, **kw)
    rec = tsw.SweepResult(spec, {}, 0.0, "cpu", 1, torch.device("cpu")).record()
    assert rec["spec"]["arm"] == "estimator" and rec["spec"]["arm_kw"] == [["discount", 0.9]]
    assert tsw.Sweep.from_spec_dict(rec["spec"]) == spec


# ------------------------------------------------------------- properties
obs_strategy = st.lists(
    st.tuples(st.floats(min_value=0.5, max_value=256.0),
              st.floats(min_value=0.01, max_value=1e3)),
    min_size=2, max_size=25,
)


def _design_var(samples, discount):
    n = len(samples)
    w = np.array([discount ** (n - 1 - i) for i in range(n)])
    lk = np.log([k for k, _ in samples])
    mk = (w * lk).sum() / w.sum()
    return float((w * (lk - mk) ** 2).sum())


@settings(max_examples=30, deadline=None)
@given(obs_strategy, st.floats(min_value=0.05, max_value=0.95),
       st.floats(min_value=0.3, max_value=1.0), st.floats(min_value=1e-6, max_value=10.0))
def test_recursive_wls_equals_numpy_property(samples, prior, discount, prior_w):
    assume(not 1e-13 < _design_var(samples, discount) < 1e-11)
    est = SpeedupEstimator(prior_p=prior, prior_weight=prior_w, discount=discount)
    for k, t in samples:
        est.observe(k, t)
    got = float(tes.p_hat_jobs(_fold(samples, discount), prior, prior_weight=prior_w)[0])
    np.testing.assert_allclose(got, est.p_hat(), rtol=1e-8, atol=1e-9)


@settings(max_examples=30, deadline=None)
@given(obs_strategy, st.floats(min_value=0.05, max_value=0.95),
       st.floats(min_value=0.3, max_value=1.0))
def test_p_hat_respects_clip_and_prior_bounds_property(samples, prior, discount):
    p = float(tes.p_hat_jobs(_fold(samples, discount), prior)[0])
    lo, hi = tes.P_CLIP
    assert min(lo, prior) - 1e-12 <= p <= max(hi, prior) + 1e-12
    assert float(tes.p_hat_jobs(tes.init_est_state(1, device="cpu"), prior)[0]) == prior
    same = _fold([(8.0, t) for _, t in samples], discount)
    assert float(tes.p_hat_jobs(same, prior)[0]) == prior


@settings(max_examples=15, deadline=None)
@given(st.lists(st.floats(min_value=0.05, max_value=50.0), min_size=12, max_size=12),
       st.floats(min_value=0.1, max_value=0.9))
def test_stateless_rule_wrapping_is_bit_for_bit_property(xs, p):
    x = torch.tensor(xs, dtype=torch.float64)
    arr = torch.linspace(0.0, 1.0, 12, dtype=torch.float64)
    plain = te.continuous_rule(tp.hesrpt, 64.0)
    a = te.run(x, arr, p, plain)
    b = te.run(x, arr, p, te.as_stateful(plain))
    assert torch.equal(a.completion_times, b.completion_times)
    assert torch.equal(a.x_final, b.x_final)
