"""repro_torch under a drifting speedup exponent against the JAX package.

Tapes are drawn by ``repro.core.scenarios.make_scenario("poisson")`` and
handed to both packages as numpy arrays, with drift boundaries set per row
from each tape (one before the first arrival, one exactly on an arrival,
one past the last departure); each JAX configuration runs once,
``jit(vmap)`` over all rows.

- ``engine.run(p_drift=)`` for the quantized, continuous, KNEE and fused
  (plain) rules, ``D = 1`` and ``D = 3``, online and ``pre_arrived``:
  completion times within ``RTOL = 1e-12`` relative (the ROADMAP bar), chips
  equal at every event (``record=True``); fused == unfused bit for bit;
- the superstep path under drift against JAX's and the port's generic loop
  (``1e-10`` absolute, as ``tests/test_torch_superstep.py``);
- ``drift_poisson`` / ``drift_bursty`` sweeps through ``simulate_cells`` on
  the JAX sampler's tapes and drift times against ``repro.core.sweeps``;
- per-job drift rows (the multi-class form) that give every job the
  row's regime are the scalar regimes bit for bit (the multi-class rows
  themselves are held in ``tests/test_torch_multiclass.py``); what stays
  refused: per-job rows on the superstep, weighted heSRPT under drift.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as je  # noqa: E402
from repro.core import policies as jp  # noqa: E402
from repro.core import superstep as jss  # noqa: E402
from repro.core import sweeps as js  # noqa: E402
from repro.core.scenarios import make_scenario  # noqa: E402
from repro_torch import lanes  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import policies as tp  # noqa: E402
from repro_torch.core import superstep as tss  # noqa: E402
from repro_torch.core import sweeps as tsw  # noqa: E402

RTOL = 1e-12
M = 30
P = 0.5  # superseded by the drift; it normalizes nothing here
N = 64.0


@functools.lru_cache(maxsize=1)
def _tapes():
    """[8, M] poisson tapes: 4 seeds x rates 2 and 8."""
    sample = make_scenario("poisson")
    xs, arrs = [], []
    for rate in (2.0, 8.0):
        for seed in range(4):
            scn = sample(jax.random.PRNGKey(seed), M, rate)
            xs.append(np.asarray(scn.x0))
            arrs.append(np.asarray(scn.arrival_times))
    return np.stack(xs), np.stack(arrs)


def _drift(kind):
    """Per-row ``(times [8, D], values [D + 1])``: ``"mid"`` one boundary on
    the 10th arrival; ``"three"`` before the first arrival, on the 10th
    arrival and after the last departure."""
    arr = np.sort(_tapes()[1], -1)
    if kind == "mid":
        return arr[:, 9:10].copy(), np.array([0.8, 0.3])
    times = np.stack([0.5 * arr[:, 0], arr[:, 9], np.full(len(arr), 1e6)], -1)
    return times, np.array([0.8, 0.3, 0.6, 0.5])


def _jax_rule(name):
    f64 = dict(dtype=jnp.float64)
    return {
        "quantized": lambda: je.quantized_rule(jp.hesrpt, 16, **f64),
        "continuous": lambda: je.continuous_rule(jp.hesrpt, N, **f64),
        "knee": lambda: je.knee_rule(N, **f64),
        "knee-chips": lambda: je.knee_rule(N, n_chips=16, **f64),
    }[name]()


def _torch_rule(name):
    return {
        "quantized": lambda: te.quantized_rule(tp.hesrpt, 16),
        "continuous": lambda: te.continuous_rule(tp.hesrpt, N),
        "knee": lambda: te.knee_rule(N),
        "knee-chips": lambda: te.knee_rule(N, n_chips=16),
    }[name]()


def _inputs(pre_arrived):
    x, a = _tapes()
    if pre_arrived:
        x = x.copy()
        x[:, 3] = 0.0  # a zero-size job in the batch
        a = np.zeros_like(a)
    return x, a


@functools.lru_cache(maxsize=None)
def _jax_run(rule, kind, pre_arrived=False, record=False):
    x, a = _inputs(pre_arrived)
    times, values = _drift(kind)
    if pre_arrived:
        times = times * 0.01  # inside the batch's span

    def one(xv, av, tv):
        res = je.run(xv, av, P, _jax_rule(rule), pre_arrived=pre_arrived, record=record,
                     p_drift=je.PDrift(tv, jnp.asarray(values)))
        return res.completion_times, (res.trace.alloc if record else res.completion_times)

    out = jax.jit(jax.vmap(one))(jnp.asarray(x), jnp.asarray(a), jnp.asarray(times))
    return tuple(np.asarray(v) for v in out)


def _torch_drift(kind, pre_arrived=False):
    times, values = _drift(kind)
    if pre_arrived:
        times = times * 0.01
    return te.PDrift(torch.tensor(times), torch.tensor(values))


def _assert_times_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("kind", ["mid", "three"])
def test_quantized_drift_matches_jax_event_for_event(kind):
    """Chips equal at every event, unfused and fused (the plain allocate
    with a [C, 1] p); fused == unfused bit for bit."""
    x, a = (torch.tensor(v) for v in _inputs(False))
    times_j, chips_j = _jax_run("quantized", kind, record=True)
    rule = te.quantized_rule(tp.hesrpt, 16)
    drift = _torch_drift(kind)
    unfused = te.run(x, a, P, rule, record=True, p_drift=drift)
    fused = te.run(x, a, P, rule, record=True, fused=True, p_drift=drift)
    for got in (unfused, fused):
        assert got.trace.alloc.shape[1] == 2 * M + drift.times.shape[-1]
        np.testing.assert_array_equal(got.trace.alloc.numpy(), chips_j)
        _assert_times_close(got.completion_times, times_j)
    assert torch.equal(fused.trace.alloc, unfused.trace.alloc)
    assert torch.equal(fused.completion_times, unfused.completion_times)


@pytest.mark.parametrize("rule", ["continuous", "knee", "knee-chips"])
@pytest.mark.parametrize("kind", ["mid", "three"])
def test_drift_rules_match_jax(rule, kind):
    x, a = (torch.tensor(v) for v in _inputs(False))
    times_j, _ = _jax_run(rule, kind)
    got = te.run(x, a, P, _torch_rule(rule), p_drift=_torch_drift(kind))
    _assert_times_close(got.completion_times, times_j)
    if rule == "continuous":  # the fused theta pass, plain on the CPU
        fused = te.run(x, a, P, _torch_rule(rule), fused=True, p_drift=_torch_drift(kind))
        assert torch.equal(fused.completion_times, got.completion_times)


@pytest.mark.parametrize("rule", ["quantized", "continuous"])
def test_pre_arrived_drift_matches_jax(rule):
    """A batch (one zero-size job) with three boundaries inside its span:
    M + D steps; the zero-size job reports 0."""
    x, a = (torch.tensor(v) for v in _inputs(True))
    times_j, _ = _jax_run(rule, "three", pre_arrived=True)
    got = te.run(x, a, P, _torch_rule(rule), pre_arrived=True,
                 p_drift=_torch_drift("three", pre_arrived=True))
    assert torch.all(got.completion_times[:, 3] == 0)
    keep = np.arange(M) != 3
    _assert_times_close(got.completion_times[:, keep], times_j[:, keep])
    np.testing.assert_array_equal(times_j[:, 3], 0.0)


def test_constant_drift_is_no_drift():
    """Regimes that all equal p: the same trajectory as no drift (within
    RTOL: a boundary splits an epoch's advance in two) and each boundary
    one step of its own; the clock lands on the boundary that
    sits on an arrival (the JAX order there is held event for event above)."""
    x, a = (torch.tensor(v) for v in _inputs(False))
    rule = te.quantized_rule(tp.hesrpt, 16)
    times, _ = _drift("three")
    flat = te.PDrift(torch.tensor(times), torch.full((4,), 0.5, dtype=torch.float64))
    with_flat = te.run(x, a, P, rule, record=True, p_drift=flat)
    plain = te.run(x, a, P, rule, record=True)
    _assert_times_close(with_flat.completion_times, plain.completion_times)
    # Each boundary costs exactly one no-op step in the recorded trace.
    assert with_flat.trace.alloc.shape[1] == plain.trace.alloc.shape[1] + 3
    # The boundary that sits on the 10th arrival: the clock lands on it once.
    arr10 = torch.tensor(times[:, 1])
    hits = (with_flat.trace.times == arr10[:, None]).sum(-1)
    assert torch.all(hits >= 1)


def test_drift_broadcasts_over_lead_dims():
    """Times [2, 1, D] over a [2, 4, M] grid equal the flattened run."""
    x, a = (torch.tensor(v) for v in _inputs(False))
    rule = te.quantized_rule(tp.hesrpt, 16)
    t2 = torch.tensor([[[3.0]], [[0.7]]])
    grid = te.run(x.reshape(2, 4, M), a.reshape(2, 4, M), P, rule,
                  p_drift=te.PDrift(t2, torch.tensor([0.8, 0.3])))
    flat_t = t2.expand(2, 4, 1).reshape(8, 1)
    flat = te.run(x, a, P, rule, p_drift=te.PDrift(flat_t, torch.tensor([0.8, 0.3])))
    assert torch.equal(grid.completion_times.reshape(8, M), flat.completion_times)


@functools.lru_cache(maxsize=None)
def _jax_superstep(policy, pre_arrived):
    x, a = _inputs(pre_arrived)
    times, values = _drift("three")
    if pre_arrived:
        times = times * 0.01
    fn = jax.vmap(lambda xv, av, tv: jss.run_superstep(
        xv, av, P, N, policy, pre_arrived=pre_arrived,
        p_drift=je.PDrift(tv, jnp.asarray(values)),
    ).completion_times)
    return np.asarray(jax.jit(fn)(jnp.asarray(x), jnp.asarray(a), jnp.asarray(times)))


@pytest.mark.parametrize("pre_arrived", [False, True])
@pytest.mark.parametrize("policy", ["hesrpt", "equi", "srpt"])
def test_superstep_drift_matches_jax_and_generic_loop(policy, pre_arrived):
    x, a = (torch.tensor(v) for v in _inputs(pre_arrived))
    drift = _torch_drift("three", pre_arrived=pre_arrived)
    got = tss.run_superstep(x, a, P, N, policy, pre_arrived=pre_arrived, p_drift=drift)
    want = _jax_superstep(policy, pre_arrived)
    np.testing.assert_allclose(got.completion_times.numpy(), want, rtol=RTOL, atol=1e-300)
    generic = te.run(x, a, P, te.continuous_rule(tp.make_policy(policy), N),
                     pre_arrived=pre_arrived, p_drift=drift).completion_times
    g, s = generic.numpy(), got.completion_times.numpy()
    if policy == "srpt":  # tied sizes may swap places: compare sorted spectra
        g, s = np.sort(g, -1), np.sort(s, -1)
    np.testing.assert_allclose(s, g, rtol=0, atol=1e-10)
    via_run = te.run(x, a, P, te.continuous_rule(tp.make_policy(policy), N), superstep=True,
                     pre_arrived=pre_arrived, p_drift=drift)
    assert torch.equal(via_run.completion_times, got.completion_times)


def _jax_drift_tapes(spec):
    """The JAX sweep's tapes and drift times ``[R, S, 1]``, regimes ``[2]``."""
    keys = jax.random.split(jax.random.PRNGKey(spec.seed), spec.n_seeds)
    sample = make_scenario(spec.scenario, size_alpha=spec.size_alpha, p=spec.p,
                           **dict(spec.scenario_kw))
    cells = [[sample(k, spec.n_jobs, r) for k in keys] for r in spec.rates]
    x0 = np.asarray([[np.asarray(c.x0) for c in row] for row in cells])
    arr = np.asarray([[np.asarray(c.arrival_times) for c in row] for row in cells])
    times = np.asarray([[np.asarray(c.p_drift.times) for c in row] for row in cells])
    values = np.asarray(cells[0][0].p_drift.values)
    return x0, arr, te.PDrift(times, values)


@functools.lru_cache(maxsize=None)
def _jax_drift_sweep(scenario, regime):
    label = "drift-continuous" if regime == "superstep" else f"drift-{regime}"
    spec = dict(lanes.drift_lane_specs(smoke=True, scenario=scenario))[label]
    spec = spec._replace(rates=(1.0, 8.0), n_jobs=30)
    if regime == "superstep":
        spec = spec._replace(policies=("hesrpt", "equi", "srpt"), superstep=True)
    jspec = js.Sweep.create(
        spec.policies, spec.rates, scenario=spec.scenario,
        scenario_kw=dict(spec.scenario_kw), n_jobs=spec.n_jobs, n_seeds=spec.n_seeds,
        seed=spec.seed, p=spec.p, n_servers=spec.n_servers, n_chips=spec.n_chips,
        superstep=spec.superstep,
    )
    return js.run_sweep(jspec, log=False)


@pytest.mark.parametrize("regime", ["quantized", "continuous", "superstep"])
@pytest.mark.parametrize("scenario", ["drift_poisson", "drift_bursty"])
def test_drift_sweep_matches_jax_on_its_tapes(scenario, regime):
    res_j = _jax_drift_sweep(scenario, regime)
    spec = tsw.Sweep.from_spec_dict(res_j.record()["spec"])
    x0, arr, drift = _jax_drift_tapes(res_j.spec)
    specs = [spec] + ([spec._replace(fused=True)] if regime == "quantized" else [])
    outs = [tsw.simulate_cells(s, x0, arr, p_drift=drift, device="cpu") for s in specs]
    for name in spec.policies:
        want = res_j.stats[name]["mean_flowtime"]
        for got in outs:
            assert got[name]["mean_flowtime"].shape == want.shape == (2, spec.n_seeds)
            np.testing.assert_allclose(got[name]["mean_flowtime"], want, rtol=RTOL, atol=0)
    if regime == "quantized":  # fused == unfused bit for bit
        assert np.array_equal(outs[0]["hesrpt"]["mean_flowtime"],
                              outs[1]["hesrpt"]["mean_flowtime"])


def test_drift_refusals():
    x, a = (torch.tensor(v) for v in _inputs(False))
    rows = te.PDrift(torch.tensor([1.0]), torch.full((2, M), 0.5, dtype=torch.float64))
    scalar = te.PDrift(torch.tensor([1.0]), torch.tensor([0.5, 0.5], dtype=torch.float64))
    per_job = te.run(x, a, P, te.quantized_rule(tp.hesrpt, 16), p_drift=rows, record=True)
    shared = te.run(x, a, P, te.quantized_rule(tp.hesrpt, 16), p_drift=scalar, record=True)
    assert torch.equal(per_job.trace.alloc, shared.trace.alloc)
    assert torch.equal(per_job.completion_times, shared.completion_times)
    with pytest.raises(ValueError, match="scalar drift regimes"):
        te.run(x, a, P, te.continuous_rule(tp.hesrpt, N), superstep=True, p_drift=rows)
    with pytest.raises(ValueError, match="scalar drift regimes"):
        tss.run_superstep(x, a, P, N, "hesrpt", p_drift=rows)
    ok = _torch_drift("mid")
    with pytest.raises(ValueError, match="weighted_hesrpt"):
        tss.run_superstep(x, a, P, N, "weighted_hesrpt", weights=torch.ones(M), p_drift=ok)
    with pytest.raises(ValueError, match="regimes"):
        te.run(x, a, P, te.quantized_rule(tp.hesrpt, 16),
               p_drift=te.PDrift(ok.times, torch.tensor([0.8, 0.3, 0.2])))
