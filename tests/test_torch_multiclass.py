"""The port's multi-class workloads against the JAX package, on JAX's tapes.

Tapes come from the JAX samplers (``x0``, ``arrival_times``, ``class_ids``,
``p_job``, ``p_drift.values``, the estimation noise) as numpy arrays and go
through both packages.  Scheduler tolerances: flows within ``RTOL = 1e-12``
relative, chips equal at every event (``record=True`` on both sides).

- ``class_theta`` for the four class-aware policies on ``[C, M]`` rows with
  a per-job ``p`` (zeros, ties, one active job, an empty row) against JAX,
  with conservation; ``hesrpt_per_class``'s index tie-break.
- ``simulate_multiclass`` for K = 2, 3 and 4, continuous, whole chips and
  slice-snapped, on a ``multiclass_poisson`` and a ``multiclass_bursty``
  tape: flows, slowdowns and per-class means against JAX's engine run of
  the same class rule, chips at every event; with ``estimator_kw``; on a
  noisy tape; and the class-blind ``simulate_scenario`` there.
- The equal-p reduction: K equal-``p`` classes are the port's single-class
  run bit for bit, continuous and quantized.
- ``drift_multiclass``: JAX's tape (per-job drift rows) through both
  packages, the single-job two-piece closed form, ``p1`` validation.
- The per-class aggregates, ``pool_by_class`` / ``p_hat_classes`` (with
  ``base=``) and the ``M == 1`` truth of the p-hat probe against JAX;
  ``efficiency`` with a per-job ``p``.
- ``Sweep(classes=)`` through ``simulate_cells`` on JAX's tapes against
  JAX's ``run_sweep`` (all four columns at ``[R, S, K]``), the drift sweep,
  the class-blind ``load_sweep_raw`` fallback, the record round trip,
  every refusal, and chunked == unchunked bit for bit.
- The port's own samplers in distribution: the bursty census, the marks'
  mix, the per-class Pareto tails, the per-job per-seed drift rows.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import benchmarks.multiclass as bmc  # noqa: E402
from repro.core import analysis as jan  # noqa: E402
from repro.core import engine as je  # noqa: E402
from repro.core import estimation as jes  # noqa: E402
from repro.core import multiclass as jmc  # noqa: E402
from repro.core import sweeps as js  # noqa: E402
from repro.core import telemetry as jt  # noqa: E402
from repro.core.arrivals import load_sweep_raw as jax_load_sweep_raw  # noqa: E402
from repro.core.arrivals import simulate_online as jax_simulate_online  # noqa: E402
from repro.core.arrivals import simulate_scenario as jax_simulate_scenario  # noqa: E402
from repro.core.policies import make_policy as jax_make_policy  # noqa: E402
from repro.core.scenarios import make_scenario  # noqa: E402
from repro_torch import lanes  # noqa: E402
from repro_torch.core import analysis as tan  # noqa: E402
from repro_torch.core import arrivals as ta  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import estimation as tes  # noqa: E402
from repro_torch.core import multiclass as tmc  # noqa: E402
from repro_torch.core import policies as tp  # noqa: E402
from repro_torch.core import scenarios as tsc  # noqa: E402
from repro_torch.core import sweeps as tsw  # noqa: E402
from repro_torch.core import telemetry as tt  # noqa: E402

RTOL = 1e-12
M = 16
N = 64.0
POLICIES = tmc.MULTICLASS_POLICY_NAMES
REGIMES = {"continuous": {}, "chips": {"n_chips": 64},
           "snapped": {"n_chips": 64, "snap_slices": True}}
TWO = ((0.3, 0.5, 1.5), (0.8, 0.5, 2.5, 2.0))  # ClassSpec fields, both packages


def _t(v, dtype=torch.float64):
    return torch.as_tensor(np.array(v), dtype=dtype)


def _close(got, want, rtol=RTOL, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _jclasses(K):
    return jmc.as_specs(bmc.class_grid(K))


def _np(v):
    return None if v is None else np.asarray(v)


def _port(jscns):
    """JAX scenarios (one per row, same M) stacked into one port Scenario
    ``[C, M]``; a scalar ``p_hat`` becomes a ``[C, 1]`` column."""
    def stack(field, dtype=torch.float64):
        vals = [_np(getattr(s, field)) for s in jscns]
        if vals[0] is None:
            return None
        return torch.as_tensor(np.stack(vals), dtype=dtype)

    p_hat = stack("p_hat")
    if p_hat is not None and p_hat.ndim == 1:
        p_hat = p_hat[:, None]
    drift = None
    if jscns[0].p_drift is not None:
        drift = te.PDrift(torch.as_tensor(np.stack([_np(s.p_drift.times) for s in jscns])),
                          torch.as_tensor(np.stack([_np(s.p_drift.values) for s in jscns])))
    return tsc.Scenario(x0=stack("x0"), arrival_times=stack("arrival_times"), p_drift=drift,
                        size_factors=stack("size_factors"), p_hat=p_hat,
                        class_ids=stack("class_ids", torch.int64), p_job=stack("p_job"))


@functools.lru_cache(maxsize=None)
def _tapes(K):
    """A multiclass_poisson and a multiclass_bursty tape of K classes."""
    classes = _jclasses(K)
    return (make_scenario("multiclass_poisson", classes=classes)(jax.random.PRNGKey(K), M, 2.0),
            make_scenario("multiclass_bursty", classes=classes)(
                jax.random.PRNGKey(10 + K), M, 2.0))


def _jax_run(scn, classes, policy, *, n_chips=None, snap_slices=False, n_servers=N):
    """JAX's engine run of ``simulate_multiclass``'s class rule, recorded:
    the rule and its per-job weights built as that function builds them."""
    x0 = jnp.asarray(scn.x0)
    arr = jnp.asarray(scn.arrival_times)
    order = jnp.argsort(arr)
    class_w = jnp.asarray([c.weight for c in classes])[scn.class_ids]
    w = jmc.policy_weights(policy, x0=x0, class_w=class_w)
    rule = jmc.class_rule(policy, n_servers=n_servers, n_chips=n_chips,
                          snap_slices=snap_slices, dtype=jnp.float64,
                          w=None if w is None else w[order])
    return je.run(x0, arr, scn.p_job, rule, record=True, p_drift=scn.p_drift)


def _port_run(scn, classes, policy, *, n_chips=None, snap_slices=False, n_servers=N):
    """The port's recorded engine run of the same class rule."""
    Mj = scn.x0.shape[-1]
    order = torch.argsort(scn.arrival_times, dim=-1, stable=True)
    class_w = torch.tensor([c.weight for c in classes], dtype=torch.float64)[scn.class_ids]
    w = tmc.policy_weights(policy, x0=scn.x0, class_w=class_w)
    rule = tmc.class_rule(policy, n_servers=n_servers, n_chips=n_chips,
                          snap_slices=snap_slices,
                          w=None if w is None else w.reshape(-1, Mj).gather(-1, order))
    return te.run(scn.x0, scn.arrival_times, scn.p_job, rule, record=True,
                  p_drift=scn.p_drift)


def _jax_flows(scn, times, n_alone):
    """Flows and slowdowns from JAX's completion times, as ``_finalize``."""
    flows = np.asarray(times) - np.asarray(scn.arrival_times)
    alone = np.asarray(scn.x0) / n_alone ** np.asarray(scn.p_job)
    return flows, flows / alone


# ------------------------------------------------------------- allocation
def _theta_rows():
    """[6, 9] rows: random sizes, zeros, exact ties, one active job, an
    empty row; a per-job p and x0 a row."""
    rng = np.random.default_rng(11)
    x0 = rng.pareto(1.3, (6, 9)) + 0.05
    x = x0 * rng.uniform(0.05, 1.0, (6, 9))
    x[1, rng.random(9) < 0.4] = 0.0
    x[2, :4] = 2.5  # ties
    x[2, 4:] = 0.0
    x[3, 1:] = 0.0  # one active job
    x[4] = 0.0  # no active job
    x[5, ::2] = 1.0
    p = rng.uniform(0.1, 0.9, (6, 9))
    p[5] = 0.5
    return x0, x, p


@pytest.mark.parametrize("name", POLICIES)
def test_class_theta_matches_jax_and_conserves(name):
    x0, x, p = _theta_rows()
    w = tmc.policy_weights(name, x0=_t(x0))
    got = tmc.class_theta(name, _t(x), _t(p), n_servers=N, w=w).numpy()
    for row in range(x.shape[0]):
        jw = jmc.policy_weights(name, x0=jnp.asarray(x0[row]))
        want = np.asarray(jmc.class_theta(name, jnp.asarray(x[row]), jnp.asarray(p[row]),
                                          n_servers=N, w=jw))
        _close(got[row], want, atol=1e-15, what=f"row {row}")
        assert np.all(got[row] >= 0) and np.all(got[row][x[row] <= 0] == 0)
        if (x[row] > 0).any():
            assert got[row].sum() == pytest.approx(1.0, rel=1e-12)
        else:
            assert got[row].sum() == 0
    assert got[3, 0] == pytest.approx(1.0, rel=1e-15)  # a lone job takes everything


def test_hesrpt_per_class_breaks_ties_by_index_as_the_reference():
    """x = [1, 1] at p = 0.5: [0.25, 0.75] in both packages (the contract
    behind the reference's known monotonicity failure, kept as is)."""
    want = np.asarray(jmc.class_theta("hesrpt_pc", jnp.asarray([1.0, 1.0]),
                                      jnp.asarray([0.5, 0.5]), n_servers=4.0))
    got = tp.hesrpt_per_class(_t([[1.0, 1.0]]), _t([[0.5, 0.5]])).numpy()[0]
    np.testing.assert_array_equal(got, [0.25, 0.75])
    np.testing.assert_array_equal(want, [0.25, 0.75])


def test_weighted_hesrpt_and_waterfill_take_a_per_job_p():
    """A [C, M] exponent that differs by row and by job: each row as JAX's
    vector call, beside the [C, 1] and scalar forms they took before."""
    x0, x, p = _theta_rows()
    xs, ps, w = _t(x), _t(p), 1.0 / _t(x0)
    got_w = tp.weighted_hesrpt(xs, ps, w).numpy()
    got_f = tp.waterfill(xs, ps, N, w).numpy()
    for row in range(x.shape[0]):
        jx, jp_ = jnp.asarray(x[row]), jnp.asarray(p[row])
        jw = jnp.asarray(1.0 / x0[row])
        from repro.core.policies import waterfill, weighted_hesrpt

        _close(got_w[row], np.asarray(weighted_hesrpt(jx, jp_, jw)), atol=1e-15)
        _close(got_f[row], np.asarray(waterfill(jx, jp_, N, jw)), atol=1e-15)
    col = tp.waterfill(xs, _t(p[:, :1]), N, w).numpy()
    per_job = tp.waterfill(xs, _t(np.repeat(p[:, :1], 9, 1)), N, w).numpy()
    np.testing.assert_array_equal(col, per_job)


# -------------------------------------------------------------- the engine
@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("K", [2, 3, 4])
def test_simulate_multiclass_matches_jax(K, regime):
    """Both tapes as one [2, M] batch in the port, each through JAX's engine
    run of the same class rule: flows, slowdowns and per-class means within
    1e-12, and under whole chips the chips of every event equal."""
    kw = REGIMES[regime]
    jscns = _tapes(K)
    scn = _port(jscns)
    classes = tmc.as_specs(lanes.class_grid(K))
    assert classes == tuple(tmc.ClassSpec(*c) for c in bmc.class_grid(K))
    n_alone = kw.get("n_chips", N)
    for name in POLICIES:
        res = tmc.simulate_multiclass(scn, classes=classes, policy=name, n_servers=N,
                                      device="cpu", **kw)
        per_class = tmc.per_class_metrics(res, scn.class_ids, K)
        mine = _port_run(scn, classes, name, **kw) if "n_chips" in kw else None
        if mine is not None:
            assert torch.equal(mine.completion_times, res.completion_times)
        for row, jscn in enumerate(jscns):
            want = _jax_run(jscn, jmc.as_specs(bmc.class_grid(K)), name, **kw)
            flows, slow = _jax_flows(jscn, want.completion_times, n_alone)
            what = f"{name} row {row}"
            _close(res.completion_times[row], want.completion_times, what=what)
            _close(res.flow_times[row], flows, what=what)
            _close(res.slowdowns[row], slow, what=what)
            for col, v in (("mean_flowtime", flows), ("mean_slowdown", slow)):
                _close(per_class[col][row],
                       jan.per_class_mean(jnp.asarray(v), jscn.class_ids, K), what=col)
            if mine is not None:
                np.testing.assert_array_equal(mine.trace.alloc[row].numpy(),
                                              np.asarray(want.trace.alloc), err_msg=what)


def test_jax_helper_is_simulate_multiclass():
    """The JAX run the engine test holds the port to is JAX's own
    simulate_multiclass (weights and order as it builds them)."""
    jscn = _tapes(2)[0]
    classes = _jclasses(2)
    for name in ("hesrpt_sd", "waterfill"):
        want = jmc.simulate_multiclass(jscn, classes=classes, policy=name, n_chips=64)
        got = _jax_run(jscn, classes, name, n_chips=64)
        np.testing.assert_array_equal(np.asarray(got.completion_times),
                                      np.asarray(want.completion_times))


@pytest.mark.parametrize("n_chips", [None, 64])
def test_simulate_multiclass_with_estimated_class_exponents_matches_jax(n_chips):
    """tests/test_estimation.py's setup (two classes at 0.35 / 0.75, 40 jobs,
    rate 3, a per-class prior, discount 0.95), and the default prior (each
    cell's mean p_job, a [C, 1] column here)."""
    jclasses = jmc.as_specs(((0.35, 1.0), (0.75, 1.0)))
    jscn = make_scenario("multiclass_poisson", classes=jclasses)(jax.random.PRNGKey(5), 40, 3.0)
    scn = _port([jscn])
    classes = tmc.as_specs(((0.35, 1.0), (0.75, 1.0)))
    for kw_j, kw_t in (
        (dict(prior_p=jnp.asarray([0.5, 0.5]), discount=0.95),
         dict(prior_p=_t([0.5, 0.5]), discount=0.95)),
        (dict(prior_weight=2.0), dict(prior_weight=2.0)),
    ):
        want = jmc.simulate_multiclass(jscn, classes=jclasses, policy="hesrpt_pc",
                                       n_servers=64.0, n_chips=n_chips, estimator_kw=kw_j)
        got = tmc.simulate_multiclass(scn, classes=classes, policy="hesrpt_pc",
                                      n_servers=64.0, n_chips=n_chips, estimator_kw=kw_t,
                                      device="cpu")
        _close(got.completion_times[0], want.completion_times)
        _close(got.mean_slowdown[0], want.mean_slowdown)
    truth = tmc.simulate_multiclass(scn, classes=classes, policy="hesrpt_pc", n_servers=64.0,
                                    device="cpu")
    assert float(truth.mean_flowtime[0]) <= float(got.mean_flowtime[0]) * 1.05


@pytest.mark.parametrize("K", [2, 3])
def test_equal_p_classes_are_the_single_class_run_bit_for_bit(K):
    """K classes sharing p = 0.55: simulate_multiclass is the port's own
    single-class run, continuous and whole chips, for heSRPT-family
    policies (and not for the others, which take the class rule)."""
    classes = tuple(tmc.ClassSpec(p=0.55, mix=1.0 / K, size_alpha=1.4 + 0.3 * i,
                                  size_scale=1.0 + i) for i in range(K))
    assert tmc.uniform_p(classes) == 0.55
    gen = tsc.seed_generator(3, K, device="cpu")
    scn = tsc.make_scenario("multiclass_poisson", classes=classes)(gen, 30, (0.5, 2.0, 8.0))
    for policy in ("hesrpt_pc", "hesrpt_blind", "hesrpt"):
        got = tmc.simulate_multiclass(scn, classes=classes, policy=policy, n_servers=128.0,
                                      device="cpu")
        ref = ta.simulate_online(scn.x0, scn.arrival_times, 0.55, 128.0, tp.hesrpt,
                                 device="cpu")
        assert torch.equal(got.completion_times, ref.completion_times)
        assert torch.equal(got.slowdowns, ref.slowdowns)
        q = tmc.simulate_multiclass(scn, classes=classes, policy=policy, n_chips=32,
                                    device="cpu")
        q_ref = ta.simulate_online_quantized(scn.x0, scn.arrival_times, 0.55, 32, tp.hesrpt,
                                             device="cpu")
        assert torch.equal(q.completion_times, q_ref.completion_times)
    # Through the class rule the same physics agree to the last ulps only.
    wf = tmc.simulate_multiclass(scn, classes=classes, policy="hesrpt_pc", n_chips=32,
                                 snap_slices=True, device="cpu")
    assert torch.all(torch.isfinite(wf.completion_times))


def test_equal_p_reduction_matches_jax_on_its_tape():
    """The same reduction on JAX's tape: both packages' single-class runs."""
    jclasses = jmc.as_specs(((0.55, 0.5), (0.55, 0.5, 2.0, 3.0)))
    jscn = make_scenario("multiclass_poisson", classes=jclasses)(jax.random.PRNGKey(2), M, 2.0)
    want = jax_simulate_online(jscn.x0, jscn.arrival_times, 0.55, N,
                               jax_make_policy("hesrpt", n_servers=N))
    got = tmc.simulate_multiclass(_port([jscn]), classes=tmc.as_specs(jclasses),
                                  policy="hesrpt_pc", n_servers=N, device="cpu")
    _close(got.completion_times[0], want.completion_times)


# ------------------------------------------------------------ drift rows
@functools.lru_cache(maxsize=1)
def _drift_tapes():
    sampler = make_scenario("drift_multiclass", classes=_jclasses(2), p1=(0.15, 0.45))
    return tuple(sampler(jax.random.PRNGKey(s), M, 2.0) for s in (0, 1))


@pytest.mark.parametrize("regime", ["continuous", "chips"])
def test_drift_multiclass_tape_through_both_packages(regime):
    """Per-job drift rows [2, M] a tape: the rows travel with their jobs into
    arrival order and each job reads its own regime."""
    kw = REGIMES[regime]
    jscns = _drift_tapes()
    scn = _port(jscns)
    assert scn.p_drift.values.shape == (2, 2, M) and scn.p_drift.times.shape == (2, 1)
    classes = tmc.as_specs(lanes.class_grid(2))
    for name in ("hesrpt_pc", "waterfill", "hesrpt_blind"):
        res = tmc.simulate_multiclass(scn, classes=classes, policy=name, n_servers=N,
                                      device="cpu", **kw)
        mine = _port_run(scn, classes, name, **kw)
        assert torch.equal(mine.completion_times, res.completion_times)
        for row, jscn in enumerate(jscns):
            want = jmc.simulate_multiclass(jscn, classes=_jclasses(2), policy=name,
                                           n_servers=N, **kw)
            _close(res.completion_times[row], want.completion_times, what=name)
            _close(res.slowdowns[row], want.slowdowns, what=name)
            if "n_chips" in kw:
                jrun = _jax_run(jscn, _jclasses(2), name, **kw)
                np.testing.assert_array_equal(mine.trace.alloc[row].numpy(),
                                              np.asarray(jrun.trace.alloc))
    # The class-blind baseline under the same rows (simulate_scenario).
    got = ta.simulate_scenario(scn, 0.5, N, tp.hesrpt, device="cpu")
    for row, jscn in enumerate(jscns):
        want = jax_simulate_scenario(jscn, 0.5, N, jax_make_policy("hesrpt"))
        _close(got.completion_times[row], want.completion_times)
        _close(got.slowdowns[row], want.slowdowns)


def test_drift_multiclass_single_job_two_piece_closed_form():
    """One job alone under its class's p -> p1[k] change: the port hits the
    two-piece closed form on JAX's draws, 8 seeds as one [8, 1] batch (a
    per-job p at M == 1)."""
    jclasses = jmc.as_specs(((0.8, 0.5), (0.6, 0.5)))
    sampler = make_scenario("drift_multiclass", classes=jclasses, p1=(0.3, 0.2),
                            drift_frac=0.5)
    jscns = [sampler(jax.random.PRNGKey(s), 1, 1.0) for s in range(8)]
    scn = _port(jscns)
    res = tmc.simulate_multiclass(scn, classes=tmc.as_specs(jclasses), policy="hesrpt_pc",
                                  n_servers=64.0, device="cpu")
    cases = set()
    for row, j in enumerate(jscns):
        a1, x = float(j.arrival_times[0]), float(j.x0[0])
        p0v, p1v = float(j.p_drift.values[0][0]), float(j.p_drift.values[1][0])
        t_d = float(j.p_drift.times[0])
        r0, r1 = 64.0 ** p0v, 64.0 ** p1v
        if t_d <= a1:
            expect, case = a1 + x / r1, "before"
        elif a1 + x / r0 <= t_d:
            expect, case = a1 + x / r0, "inside"
        else:
            expect, case = t_d + (x - (t_d - a1) * r0) / r1, "two-piece"
        cases.add(case)
        assert float(res.completion_times[row, 0]) == pytest.approx(expect, rel=1e-12)
    assert "two-piece" in cases


def test_drift_multiclass_p1_length_validation():
    sampler = tsc.make_scenario("drift_multiclass", classes=lanes.class_grid(2), p1=(0.3,))
    with pytest.raises(ValueError, match="post-drift exponent per class"):
        sampler(tsc.seed_generator(0, 0, device="cpu"), 8, 1.0)


# ---------------------------------------------------------- per-class noise
@functools.lru_cache(maxsize=1)
def _noisy_tape():
    return make_scenario("multiclass_poisson", classes=jmc.as_specs(TWO),
                         sigma_size=(0.0, 0.5), sigma_p=(0.2, 0.2))(jax.random.PRNGKey(4), M, 2.0)


def test_per_class_noise_reaches_only_the_policy_view():
    """JAX's noisy tape (per-class sigma_size, per-job p_hat) through both
    packages: the class rule sees x * factors and p_hat, the physics x0 and
    p_job; and the blind wrapper's one belief a row is the mean p_hat."""
    jscn = _noisy_tape()
    assert np.asarray(jscn.p_hat).shape == (M,)
    scn = _port([jscn])
    classes = tmc.as_specs(TWO)
    for name in ("hesrpt_pc", "hesrpt_sd", "waterfill"):
        want = jmc.simulate_multiclass(jscn, classes=jmc.as_specs(TWO), policy=name,
                                       n_servers=N)
        got = tmc.simulate_multiclass(scn, classes=classes, policy=name, n_servers=N,
                                      device="cpu")
        _close(got.completion_times[0], want.completion_times, what=name)
        _close(got.slowdowns[0], want.slowdowns, what=name)
    clean = tmc.simulate_multiclass(scn._replace(size_factors=None, p_hat=None),
                                    classes=classes, policy="hesrpt_pc", n_servers=N,
                                    device="cpu")
    assert not torch.equal(clean.completion_times, got.completion_times)
    # The slowdowns normalize by the true sizes and exponents either way.
    alone = scn.x0 / N ** scn.p_job
    _close(got.slowdowns, got.flow_times / alone)
    blind_j = jax_simulate_scenario(jscn, 0.5, N, jax_make_policy("hesrpt"))
    blind = ta.simulate_scenario(scn, 0.5, N, tp.hesrpt, device="cpu")
    _close(blind.completion_times[0], blind_j.completion_times)
    pinned = ta.simulate_scenario(scn._replace(p_hat=scn.p_hat.mean(-1, keepdim=True)), 0.5,
                                  N, tp.hesrpt, device="cpu")
    assert torch.equal(pinned.completion_times, blind.completion_times)


def test_port_per_class_noise_draw():
    """The port's own draw: class 0 (sigma 0) keeps factors of 1 and its true
    p; class 1's p_hat is clipped; p_hat is per job and shared by the rates;
    a per-class sigma on a one-class scenario raises as in JAX."""
    sampler = tsc.make_scenario("multiclass_poisson", classes=TWO, sigma_size=(0.0, 0.8),
                                sigma_p=(0.0, 10.0))
    scn = sampler(tsc.seed_generator(0, 4, device="cpu"), 400, (1.0, 4.0))
    cls = scn.class_ids
    assert scn.p_hat.shape == scn.size_factors.shape == scn.x0.shape == (2, 400)
    assert torch.equal(scn.p_hat[0], scn.p_hat[1])
    assert torch.all(scn.size_factors[cls == 0] == 1.0)
    assert torch.any(scn.size_factors[cls == 1] != 1.0)
    assert torch.all(scn.p_hat[cls == 0] == 0.3)
    hat1 = scn.p_hat[cls == 1]
    assert torch.all((hat1 >= 0.05) & (hat1 <= 0.95))
    assert torch.any(hat1 == 0.05) and torch.any(hat1 == 0.95)
    scalar = tsc.make_scenario("multiclass_poisson", classes=TWO, sigma_p=0.1)(
        tsc.seed_generator(0, 5, device="cpu"), 50, 1.0)
    assert scalar.p_hat.shape == (50,)  # centred on each job's own p_job
    assert float((scalar.p_hat - scalar.p_job).abs().max()) < 0.6
    with pytest.raises(ValueError, match="multi-class scenario"):
        tsc.make_scenario("poisson", sigma_size=(0.1, 0.2))(
            tsc.seed_generator(0, 0, device="cpu"), 8, 1.0)


# --------------------------------------------- aggregates, pooled estimator
def test_per_class_aggregates_match_jax():
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 3, (4, 12))
    ids[0] = np.where(ids[0] == 2, 0, ids[0])  # class 2 empty in row 0
    flows, slows = rng.uniform(0.1, 5.0, (2, 4, 12))
    times = np.round(rng.uniform(0.0, 4.0, (4, 12)), 1)  # ties in completion
    got = tan.per_class_summary(_t(flows), _t(slows), _t(times), torch.as_tensor(ids), 4)
    for row in range(4):
        want = jan.per_class_summary(jnp.asarray(flows[row]), jnp.asarray(slows[row]),
                                     jnp.asarray(times[row]), jnp.asarray(ids[row]), 4)
        for k in ("mean_flowtime", "mean_slowdown", "mean_completion_order"):
            _close(got[k][row], want[k], what=k)
            assert np.array_equal(np.isnan(got[k][row].numpy()), np.isnan(np.asarray(want[k])))
        np.testing.assert_array_equal(got["count"][row].numpy(), np.asarray(want["count"]))
    assert torch.isnan(got["mean_flowtime"][0, 2]) and torch.isnan(got["mean_flowtime"][0, 3])
    np.testing.assert_array_equal(tan.per_class_count(torch.as_tensor([0, 1, 1, 0]), 3),
                                  [2, 2, 0])


def _est_states(rng, M_=9, rows=2):
    """One port state [rows, M] and JAX's state for each row, on the same
    observations (some jobs queued)."""
    state = tes.init_est_state(M_, device="cpu")
    jstates = [jes.init_est_state(M_, jnp.float64) for _ in range(rows)]
    for _ in range(6):
        chips = rng.uniform(0.0, 32.0, (rows, M_))
        chips[rng.random((rows, M_)) < 0.3] = 0.0
        rate = 1.3 * chips ** rng.uniform(0.3, 0.8, (rows, M_))
        state = tes.observe_throughput(state, te.Observation(
            alloc=_t(chips), rate=_t(rate), dt=torch.full((rows, 1), 0.5, dtype=torch.float64),
            active=torch.ones(rows, M_, dtype=torch.bool)), discount=0.9)
        jstates = [jes.observe_throughput(js_, je.Observation(
            alloc=jnp.asarray(chips[r]), rate=jnp.asarray(rate[r]), dt=jnp.asarray(0.5),
            active=jnp.ones(M_, bool)), discount=0.9) for r, js_ in enumerate(jstates)]
    return state, jstates


def test_pool_by_class_and_p_hat_classes_match_jax():
    rng = np.random.default_rng(8)
    state, jstates = _est_states(rng)
    ids = rng.integers(0, 3, (2, 9))
    base_j = jes.EstState(jnp.asarray([3, 0, 1], jnp.int32),
                          *(jnp.asarray(rng.uniform(0.0, 2.0, 3)) for _ in range(5)))
    base_t = tes.EstState(*(torch.as_tensor(np.asarray(f)) for f in base_j))
    pooled = tes.pool_by_class(state, torch.as_tensor(ids), 3)
    prior = _t([[0.4], [0.6]])
    for row in range(2):
        want = jes.pool_by_class(jstates[row], jnp.asarray(ids[row]), 3)
        for g, w in zip(pooled, want, strict=True):
            _close(g[row], w, atol=1e-15)
        for base in (None, "base"):
            kw = {} if base is None else {"base": base_t}
            jkw = {} if base is None else {"base": base_j}
            got = tes.p_hat_classes(state, torch.as_tensor(ids), 3, prior, prior_weight=0.5,
                                    **kw)
            want_p = jes.p_hat_classes(jstates[row], jnp.asarray(ids[row]), 3,
                                       float(prior[row, 0]), prior_weight=0.5, **jkw)
            _close(got[row], want_p, what=f"row {row} {base}")
    per_class_prior = tes.p_hat_classes(state, torch.as_tensor(ids), 3, _t([0.2, 0.5, 0.9]))
    assert per_class_prior.shape == (2, 3)


def test_multiclass_p_hat_probe_truth_at_one_job():
    """M == 1 with a per-job p: on an idle epoch JAX's truth is the
    active-job mean, 0, so p_hat_err reads 0 there; the port decides by the
    p's source (per job), not its shape, and matches JAX event by event."""
    x = np.array([[2.0], [0.7], [5.0]])
    a = np.array([[3.0], [0.5], [1.0]])
    p_job = np.array([[0.3], [0.6], [0.85]])
    prior = 0.5
    metrics = ("p_hat_err", "queue", "efficiency")
    rule = tes.estimating_rule(tp.hesrpt, 4.0, prior_p=prior, n_jobs=1, device="cpu")
    got = te.run(_t(x), _t(a), _t(p_job), rule, telemetry=tt.make_probe(
        metrics, mode="series", n_jobs=1, p_hat_reader=tt.p_hat_error_metric(prior)))
    s = {k: v.numpy() for k, v in got.telemetry.series.items()}
    for row in range(3):
        jrule = jes.estimating_rule(jax_make_policy("hesrpt"), 4.0, prior_p=prior,
                                    dtype=jnp.float64, n_jobs=1)
        want = je.run(x[row], a[row], jnp.asarray(p_job[row]), jrule,
                      telemetry=jt.make_probe(metrics, mode="series", n_jobs=1,
                                              p_hat_reader=jt.p_hat_error_metric(prior),
                                              dtype=jnp.float64))
        _close(got.completion_times[row], want.completion_times)
        for k in ("t", "dt", *metrics):
            _close(s[k][row], want.telemetry.series[k], atol=1e-12, what=k)
    idle = (s["dt"] > 0) & (s["queue"] == 0)
    assert idle.sum() >= 3
    np.testing.assert_array_equal(s["p_hat_err"][idle], 0.0)


def test_probe_efficiency_with_a_per_job_p_matches_jax():
    """engine.run(telemetry=) on a multi-class tape: efficiency is
    sum theta_i^p_i, as JAX's."""
    jscn = _tapes(3)[0]
    scn = _port([jscn])
    classes = tmc.as_specs(lanes.class_grid(3))
    metrics = ("efficiency", "utilization", "queue", "entropy")
    got = te.run(scn.x0, scn.arrival_times, scn.p_job,
                 tmc.class_rule("hesrpt_pc", n_servers=N),
                 telemetry=tt.make_probe(metrics, mode="series", n_jobs=M))
    want = je.run(jscn.x0, jscn.arrival_times, jscn.p_job,
                  jmc.class_rule("hesrpt_pc", n_servers=N, dtype=jnp.float64),
                  telemetry=jt.make_probe(metrics, mode="series", n_jobs=M, dtype=jnp.float64))
    del classes
    for k in metrics:
        _close(got.telemetry.series[k][0], want.telemetry.series[k], atol=1e-12, what=k)


def test_per_job_p_stays_refused_where_the_reference_refuses_it():
    x, a = _t([[2.0, 1.0]]), _t([[0.0, 0.5]])
    p = _t([[0.3, 0.7]])
    with pytest.raises(ValueError, match="scalar p"):
        te.run_ranked(x, a, p, 4.0, tp.hesrpt_theta_from_ranks)
    with pytest.raises(ValueError, match="scalar p"):
        te.run(x, a, p, te.continuous_rule(tp.hesrpt, 4.0), superstep=True)
    with pytest.raises(ValueError, match="scalar p"):
        te.run_stream(x, a, p, te.continuous_rule(tp.hesrpt, 4.0), n_slots=2)
    with pytest.raises(ValueError, match="p_job cannot stream"):
        tsc.stream_tape(tsc.Scenario(x, a, p_job=p))


# ------------------------------------------------------------------ sweeps
def _jax_sweep_tapes(spec):
    """The tapes JAX's run_sweep draws for a multi-class spec: one key a
    seed, shared by the rates; every per-job field stacked [R, S, ...]."""
    keys = jax.random.split(jax.random.PRNGKey(spec.seed), spec.n_seeds)
    kw = dict(spec.scenario_kw)
    if spec.classes is not None:
        kw["classes"] = spec.classes
    sample = make_scenario(spec.scenario, size_alpha=spec.size_alpha, p=spec.p, **kw)
    cells = [[sample(k, spec.n_jobs, r) for k in keys] for r in spec.rates]

    def field(get):
        vals = [[get(c) for c in row] for row in cells]
        return None if vals[0][0] is None else np.asarray(
            [[np.asarray(v) for v in row] for row in vals])

    drift = None
    if cells[0][0].p_drift is not None:
        drift = te.PDrift(torch.as_tensor(field(lambda c: c.p_drift.times)),
                          torch.as_tensor(field(lambda c: c.p_drift.values)))
    return dict(x0=field(lambda c: c.x0), arr=field(lambda c: c.arrival_times),
                class_ids=field(lambda c: c.class_ids), p_job=field(lambda c: c.p_job),
                p_drift=drift, size_factors=field(lambda c: c.size_factors),
                p_hat=field(lambda c: c.p_hat))


def _sweep_vs_jax(jspec):
    res_j = js.run_sweep(jspec, log=False)
    spec = tsw.Sweep.from_spec_dict(res_j.record()["spec"])
    tp_ = _jax_sweep_tapes(jspec)
    got = tsw.simulate_cells(spec, tp_.pop("x0"), tp_.pop("arr"), device="cpu", **tp_)
    for name in jspec.policies:
        for m in jspec.metrics:
            want = res_j.stats[name][m]
            assert got[name][m].shape == want.shape, (name, m)
            _close(got[name][m], want, what=f"{name} {m}")
    return spec, got


def test_sweep_classes_matches_jax_run_sweep_on_its_tapes():
    """Sweep(classes=) of the four policies (K = 3, two rates) through
    simulate_cells on JAX's tapes: all four columns, per-class [R, S, K]."""
    jspec = js.Sweep.create(bmc.POLICIES, (0.5, 4.0), scenario="multiclass_poisson",
                            n_jobs=M, n_seeds=2, n_servers=N, classes=bmc.class_grid(3))
    spec, got = _sweep_vs_jax(jspec)
    assert spec.classes == tmc.as_specs(lanes.class_grid(3))
    assert spec.metrics == ("mean_flowtime", "mean_slowdown", "class_flowtime",
                            "class_slowdown")
    assert got["hesrpt_pc"]["class_flowtime"].shape == (2, 2, 3)


def test_sweep_classes_snapped_and_drift_match_jax():
    """The snap pair's regime (whole chips snapped to slices) and a
    drift_multiclass sweep (per-job rows [R, S, 2, M]) against JAX."""
    _sweep_vs_jax(js.Sweep.create(("hesrpt_pc",), (0.5, 4.0), scenario="multiclass_poisson",
                                  n_jobs=M, n_seeds=2, n_servers=N, n_chips=64,
                                  snap_slices=True, classes=bmc.class_grid(2)))
    spec, _ = _sweep_vs_jax(js.Sweep.create(
        ("hesrpt_pc", "hesrpt_blind"), (0.5, 4.0), scenario="drift_multiclass",
        scenario_kw={"p1": (0.15, 0.25)}, n_jobs=M, n_seeds=2, n_servers=N,
        classes=TWO))
    scn = tsw.draw_scenario(spec, device="cpu")
    assert scn.p_drift.values.shape == (2, 2, 2, M) and scn.p_drift.times.shape == (2, 2, 1)


def test_class_blind_load_sweep_raw_falls_back_to_the_generic_loop():
    """A multiclass_* scenario without classes: the class-blind baseline on
    the generic loop (never the carried ranks), against JAX's load_sweep_raw
    on its tapes, with per-class noise (the blind policy's one p_hat a row)."""
    kw = dict(n_jobs=M, n_seeds=2, p=0.5, n_servers=32.0, scenario="multiclass_poisson")
    for skw in ({"classes": TWO}, {"classes": TWO, "sigma_size": (0.0, 0.5),
                                   "sigma_p": (0.2, 0.2)}):
        want = jax_load_sweep_raw(("hesrpt", "equi"), (0.5, 2.0), scenario_kw=skw, **kw)
        jspec = js.Sweep.create(("hesrpt", "equi"), (0.5, 2.0), scenario_kw=skw,
                                **{k: v for k, v in kw.items()})
        spec = tsw.Sweep.from_spec_dict(
            js.SweepResult(jspec, {}, 0.0, 0.0, "cpu", 1, None, False).record()["spec"])
        tp_ = _jax_sweep_tapes(jspec)
        got = tsw.simulate_cells(spec, tp_.pop("x0"), tp_.pop("arr"), device="cpu", **tp_)
        for name in ("hesrpt", "equi"):
            _close(got[name]["mean_flowtime"], want[name], what=name)
    raw = ta.load_sweep_raw(("hesrpt",), (0.5, 2.0), scenario_kw={"classes": TWO},
                            device="cpu", **kw)
    assert raw["hesrpt"].shape == (2, 2) and np.all(np.isfinite(raw["hesrpt"]))


def test_sweep_classes_refusals_and_record_round_trip():
    cls = {"classes": TWO}
    for bad, match in (
        (dict(stream={"n_slots": 4}, **cls), "single-class and arm-free"),
        (dict(arm="stale", scenario_kw={"p0": 0.8}, **cls), "single-class sweeps"),
        (dict(fused=True, n_chips=16, **cls), "single-class, arm-free"),
        (dict(superstep=True, **cls), "single-class, arm-free"),
        (dict(telemetry=True, **cls), "single-class only for now"),
        (dict(snap_slices=True, n_chips=16), "only wired for multi-class"),
        (dict(metrics=("class_flowtime",)), "needs a multi-class sweep"),
    ):
        kw = {"scenario": "multiclass_poisson", **bad}
        if "classes" not in bad:
            kw["scenario_kw"] = {"classes": TWO}
        with pytest.raises(ValueError, match=match):
            tsw.Sweep.create(("hesrpt_pc",) if "classes" in bad else ("hesrpt",), (1.0,),
                             **kw)
        with pytest.raises(ValueError, match=match):
            js.Sweep.create(("hesrpt_pc",) if "classes" in bad else ("hesrpt",), (1.0,),
                            **kw)
    with pytest.raises(ValueError, match="per-job exponents take the generic scan"):
        tsw.Sweep.create(("hesrpt",), (1.0,), scenario="multiclass_poisson",
                         scenario_kw={"classes": TWO}, superstep=True)
    with pytest.raises(ValueError, match="unknown multi-class policy"):
        tsw.Sweep.create(("equi",), (1.0,), scenario="multiclass_poisson", classes=TWO)
    spec = dict(lanes.multiclass_specs("smoke"))["snap-on"]
    rec = tsw.SweepResult(spec, {}, 0.0, backend="cpu", device=torch.device("cpu")).record()
    jrec = js.SweepResult(js.Sweep.create(("hesrpt_pc",), (1.0,), scenario="multiclass_poisson",
                                          classes=TWO), {}, 0.0, 0.0, "cpu", 1, None,
                          False).record()
    assert set(rec["spec"]) == set(jrec["spec"])
    assert rec["spec"]["classes"] == [list(c) for c in spec.classes]
    assert tsw.Sweep.from_spec_dict(rec["spec"]) == spec
    assert tsw.Sweep.from_spec_dict(jrec["spec"]).classes == tmc.as_specs(TWO)


@functools.lru_cache(maxsize=1)
def _mc_unchunked():
    spec = dict(lanes.multiclass_specs("smoke"))["K=2"]._replace(n_jobs=20, n_seeds=5)
    return spec, tsw.run_sweep(spec, device="cpu")


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_multiclass_sweep_chunked_equals_unchunked_bit_for_bit(chunk):
    spec, whole = _mc_unchunked()
    res = tsw.run_sweep(spec, chunk_seeds=chunk, device="cpu")
    for name in spec.policies:
        for m in spec.metrics:
            assert np.array_equal(res.stats[name][m], whole.stats[name][m]), (name, m)
    means = res.cell_means("class_flowtime")
    assert len(means[0.5]["hesrpt_pc"]) == 2
    rec = res.record()
    assert len(rec["cells"]["waterfill"]["class_slowdown"]["mean"][0]) == 2
    assert tsw.Sweep.from_spec_dict(rec["spec"]) == spec


def test_multiclass_specs_are_the_benchmark_grid():
    """lanes.multiclass_specs at each tier: benchmarks/multiclass.py's
    classes, policies, rates and sizes, and its snap pair; multiclass_sweep
    is a spec over run_sweep."""
    for size, (ks, n_jobs, n_seeds, rates) in lanes.MC_SIZES.items():
        specs = dict(lanes.multiclass_specs(size))
        assert list(specs) == [f"K={k}" for k in ks] + ["snap-off", "snap-on"]
        for k in ks:
            s = specs[f"K={k}"]
            assert s.classes == tmc.as_specs(bmc.class_grid(k))
            assert (s.policies, s.rates, s.n_jobs, s.n_seeds) == (bmc.POLICIES, rates, n_jobs,
                                                                  n_seeds)
        on = specs["snap-on"]
        assert on.snap_slices and on.n_chips == 256 and on.n_jobs == min(n_jobs, 300)
        assert on.n_seeds == min(n_seeds, 8) and on.classes == tmc.as_specs(bmc.class_grid(2))
    out = tmc.multiclass_sweep(("hesrpt_pc", "hesrpt_blind"), (0.5, 2.0), classes=TWO,
                               n_jobs=20, n_seeds=2, n_servers=32.0, device="cpu")
    assert out["hesrpt_pc"]["class_flowtime"].shape == (2, 2, 2)
    res = tsw.run_sweep(dict(lanes.multiclass_specs("smoke"))["K=2"]._replace(n_jobs=20),
                        device="cpu")
    gaps = lanes.gap_ratios(res)
    assert set(gaps) == {"flow", "slowdown"} and all(g > 0 for g in gaps["flow"])


# --------------------------------------------------- the port's own samplers
def test_multiclass_bursty_census_is_exact():
    classes = ((0.4, 0.25), (0.6, 0.75))
    sampler = tsc.make_scenario("multiclass_bursty", classes=classes)
    for n in (40, 41, 7):
        scn = sampler(tsc.seed_generator(1, n, device="cpu"), n, (1.0, 4.0))
        want = tmc._class_counts(tmc.as_specs(classes), n)
        assert want == jmc._class_counts(jmc.as_specs(classes), n)
        for row in range(2):
            assert torch.bincount(scn.class_ids[row], minlength=2).tolist() == want
        assert torch.equal(scn.class_ids[0], scn.class_ids[1])
        assert torch.equal(scn.p_job, _t([0.4, 0.6])[scn.class_ids])
    assert tmc._class_counts(tmc.as_specs(((0.5, 1.0), (0.5, 1.0), (0.5, 1.0))), 4) == [2, 1, 1]


def test_multiclass_poisson_marks_and_size_tails_in_distribution():
    """200,000 jobs: the marks follow the mix, each class's sizes are
    Pareto(alpha_k) with minimum scale_k (P(X > t scale) = t^-alpha), and
    the rate axis shares the sizes, marks and unit gaps."""
    n = 200_000
    classes = lanes.class_grid(3)
    scn = tsc.make_scenario("multiclass_poisson", classes=classes)(
        tsc.seed_generator(0, 7, device="cpu"), n, (1.0, 4.0))
    assert torch.equal(scn.class_ids[0], scn.class_ids[1])
    assert torch.equal(scn.x0[0], scn.x0[1])
    _close(scn.arrival_times[0] / 4.0, scn.arrival_times[1])
    counts = torch.bincount(scn.class_ids[0], minlength=3).double() / n
    np.testing.assert_allclose(counts.numpy(), [1 / 3] * 3, atol=0.01)
    for k, c in enumerate(classes):
        x = scn.x0[0][scn.class_ids[0] == k] / c.size_scale
        assert float(x.min()) >= 1.0
        for t in (2.0, 4.0):
            assert float((x > t).double().mean()) == pytest.approx(t ** -c.size_alpha,
                                                                   rel=0.06)
        assert torch.all(scn.p_job[0][scn.class_ids[0] == k] == c.p)


def test_drift_rows_are_per_job_and_per_seed():
    spec = tsw.Sweep.create(("hesrpt_pc",), (0.5, 2.0), scenario="drift_multiclass",
                            scenario_kw={"p1": (0.2, 0.9)}, n_jobs=30, n_seeds=3,
                            classes=((0.7, 0.6), (0.4, 0.4)))
    scn = tsw.draw_scenario(spec, device="cpu")
    v = scn.p_drift.values
    assert v.shape == (2, 3, 2, 30) and scn.p_drift.times.shape == (2, 3, 1)
    assert torch.equal(v[:, :, 0], scn.p_job)
    assert torch.equal(v[:, :, 1], torch.tensor([0.2, 0.9], dtype=torch.float64)[scn.class_ids])
    assert not torch.equal(scn.class_ids[:, 0], scn.class_ids[:, 1])  # each seed its draw
    np.testing.assert_allclose(scn.p_drift.times[:, 0, 0].numpy(), [0.5 * 30 / 0.5,
                                                                   0.5 * 30 / 2.0])
    res = tsw.run_sweep(spec, device="cpu")
    assert np.all(np.isfinite(res.stats["hesrpt_pc"]["class_slowdown"]))
