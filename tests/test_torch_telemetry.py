"""The port's in-loop telemetry probes against the JAX package's.

Tapes are drawn by ``repro.core.scenarios.make_scenario`` and handed to both
packages as numpy arrays, float64 throughout.  The mirror of
``tests/test_telemetry.py``, each case run on the port and, where the JAX
test reads a value, held against the JAX run of the same tape:

- neutrality: a series or stream probe never changes the trajectory
  (continuous, quantized and fused rules; completion times bit for bit,
  chips equal at every event), and record composes with it;
- the probe's series (every event's value) and stream aggregates against
  JAX's: per-event values, means and maxima within ``RTOL = 1e-12``
  relative (``1e-12`` absolute near 0), histograms within ``1e-12``
  absolute (``tests/test_streaming.py``'s bar);
- stream == series reduced by ``analysis.time_weighted_stats``, histogram
  mass == span, the structural bounds;
- ``p_hat_err`` under an estimating rule, also on a drift tape with idle
  epochs (no active job, ``dt > 0``), where the truth is the row's ``p``;
- the windowed stream probe through ``run_stream`` and
  ``run_stream_source`` against JAX's; a batch of rows equals each row
  alone;
- ``Sweep(telemetry=)``: validation, the ``tel_*`` columns beside
  unchanged metrics, the record's round trip, and the columns against
  JAX's ``run_sweep`` on its tapes (finite tape continuous, quantized and
  fused; the stream sweep with each rate's window).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as je  # noqa: E402
from repro.core import estimation as jes  # noqa: E402
from repro.core import sweeps as js  # noqa: E402
from repro.core import telemetry as jt  # noqa: E402
from repro.core.policies import make_policy as jax_make_policy  # noqa: E402
from repro.core.scenarios import make_scenario  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import estimation as tes  # noqa: E402
from repro_torch.core import policies as tp  # noqa: E402
from repro_torch.core import sweeps as tsw  # noqa: E402
from repro_torch.core import telemetry as tt  # noqa: E402
from repro_torch.core.analysis import time_weighted_stats  # noqa: E402

RTOL = 1e-12
ATOL = 1e-12
N_JOBS = 40
N_CHIPS = 64
KINDS = ("continuous", "quantized", "fused")


@functools.lru_cache(maxsize=None)
def _tape(seed=0, rate=2.0, n_jobs=N_JOBS, scenario="poisson"):
    scn = make_scenario(scenario, p=0.5)(jax.random.key(seed), n_jobs, rate)
    return np.asarray(scn.x0), np.asarray(scn.arrival_times)


def _t(v):
    return torch.as_tensor(np.array(v), dtype=torch.float64)


def _rules(kind):
    """(JAX rule, port rule, alloc unit, fused)."""
    if kind == "continuous":
        return (je.continuous_rule(jax_make_policy("hesrpt"), 1.0, dtype=jnp.float64),
                te.continuous_rule(tp.hesrpt, 1.0), 1.0, False)
    return (je.quantized_rule(jax_make_policy("hesrpt"), N_CHIPS, dtype=jnp.float64),
            te.quantized_rule(tp.hesrpt, N_CHIPS), float(N_CHIPS), kind == "fused")


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _assert_tel_match(got, want, metrics):
    """Port TelemetryResult against JAX's: series within RTOL, or stream
    means, maxima and time within RTOL and histograms within ATOL."""
    if want.series is not None:
        for k in ("t", "dt", *metrics):
            _close(got.series[k], want.series[k], k)
        return
    _close(got.aggregates["time"], want.aggregates["time"], "time")
    for m in metrics:
        for agg in ("mean", "max"):
            _close(got.aggregates[f"{m}_{agg}"], want.aggregates[f"{m}_{agg}"], f"{m}_{agg}")
        np.testing.assert_allclose(np.asarray(got.aggregates[f"{m}_hist"]),
                                   np.asarray(want.aggregates[f"{m}_hist"]), rtol=0, atol=ATOL,
                                   err_msg=f"{m}_hist")
        np.testing.assert_array_equal(np.asarray(got.hist_edges[m]),
                                      np.asarray(want.hist_edges[m]))


# ----------------------------------------------------------------- neutrality
@pytest.mark.parametrize("kind", KINDS)
def test_probe_never_changes_the_trajectory(kind):
    """With a series or a stream probe the completion times are the
    probe-free run's bit for bit, and the chips at every event too."""
    x, a = (_t(v) for v in _tape())
    _, rule, unit, fused = _rules(kind)
    base = te.run(x, a, 0.5, rule, fused=fused, record=True)
    assert base.telemetry is None
    for mode in ("series", "stream"):
        probe = tt.make_probe(tt.DEFAULT_METRICS, mode=mode, alloc_unit=unit, n_jobs=N_JOBS)
        res = te.run(x, a, 0.5, rule, fused=fused, telemetry=probe, record=True)
        assert torch.equal(res.completion_times, base.completion_times)
        assert torch.equal(res.trace.alloc, base.trace.alloc)
        assert res.telemetry is not None


def test_probe_neutral_with_record_and_batched_rows():
    """record and telemetry compose; a batch of rows equals each row alone."""
    tapes = [_tape(seed=s) for s in (3, 4, 5)]
    x = _t([t[0] for t in tapes])
    a = _t([t[1] for t in tapes])
    _, rule, unit, _ = _rules("continuous")
    probe = tt.make_probe(("efficiency", "queue"), mode="stream", alloc_unit=unit,
                          n_jobs=N_JOBS)
    res = te.run(x, a, 0.5, rule, record=True, telemetry=probe)
    base = te.run(x, a, 0.5, rule)
    assert torch.equal(res.completion_times, base.completion_times)
    assert res.trace is not None
    assert bool((res.telemetry.aggregates["queue_max"] >= 1.0).all())
    for r in range(3):
        one = te.run(x[r], a[r], 0.5, rule, telemetry=probe).telemetry
        for k, v in one.aggregates.items():
            assert torch.equal(v, res.telemetry.aggregates[k][r]), k


@pytest.mark.parametrize("mode", ["series", "stream"])
@pytest.mark.parametrize("kind", KINDS)
def test_probe_matches_jax(kind, mode):
    """Flows within 1e-12 relative, the probe's read-out as JAX's."""
    x, a = _tape(seed=1)
    jrule, rule, unit, fused = _rules(kind)
    kw = dict(mode=mode, alloc_unit=unit, n_jobs=N_JOBS)
    want = je.run(x, a, 0.5, jrule, fused=fused,
                  telemetry=jt.make_probe(jt.DEFAULT_METRICS, dtype=jnp.float64, **kw))
    got = te.run(_t(x), _t(a), 0.5, rule, fused=fused,
                 telemetry=tt.make_probe(tt.DEFAULT_METRICS, **kw))
    np.testing.assert_allclose(got.completion_times.numpy(), np.asarray(want.completion_times),
                               rtol=RTOL, atol=0)
    _assert_tel_match(got.telemetry, want.telemetry, tt.DEFAULT_METRICS)


# ------------------------------------------------------------ stream == series
@pytest.mark.parametrize("kind", ["continuous", "quantized"])
def test_stream_aggregates_match_series_reduction(kind):
    x, a = (_t(v) for v in _tape(seed=1))
    _, rule, unit, fused = _rules(kind)
    tel = {}
    for mode in ("series", "stream"):
        probe = tt.make_probe(tt.DEFAULT_METRICS, mode=mode, alloc_unit=unit, n_jobs=N_JOBS)
        tel[mode] = te.run(x, a, 0.5, rule, fused=fused, telemetry=probe).telemetry
    series = {k: v.numpy() for k, v in tel["series"].series.items()}
    agg = tel["stream"].aggregates
    for m in tt.DEFAULT_METRICS:
        ref = time_weighted_stats(series[m], series["dt"])
        assert float(agg[f"{m}_mean"]) == pytest.approx(ref["mean"], abs=1e-12)
        assert float(agg[f"{m}_max"]) == pytest.approx(ref["max"], abs=1e-12)
    assert float(agg["time"]) == pytest.approx(float(series["dt"].sum()), abs=1e-12)


def test_histogram_mass_accounts_for_the_whole_span():
    x, a = (_t(v) for v in _tape(seed=2))
    _, rule, unit, _ = _rules("continuous")
    probe = tt.make_probe(tt.DEFAULT_METRICS, mode="stream", alloc_unit=unit, n_jobs=N_JOBS,
                          hist_bins=16)
    tel = te.run(x, a, 0.5, rule, telemetry=probe).telemetry
    total = float(tel.aggregates["time"])
    for m in tt.DEFAULT_METRICS:
        hist = tel.aggregates[f"{m}_hist"].numpy()
        edges = tel.hist_edges[m].numpy()
        assert hist.shape == (16,) and edges.shape == (17,)
        assert np.all(hist >= 0)
        assert float(hist.sum()) == pytest.approx(total, rel=1e-12)
        lo, hi = tt.default_hist_ranges(N_JOBS)[m]
        assert edges[0] == pytest.approx(lo) and edges[-1] == pytest.approx(hi)


def test_series_values_respect_structural_bounds():
    x, a = (_t(v) for v in _tape(seed=4))
    probe = tt.make_probe(tt.DEFAULT_METRICS, mode="series")
    _, rule, _, _ = _rules("continuous")
    tel = te.run(x, a, 0.5, rule, telemetry=probe).telemetry
    s = {k: v.numpy() for k, v in tel.series.items()}
    live = s["dt"] > 0
    assert np.all(np.diff(s["t"]) >= 0)
    assert np.all(s["utilization"] <= 1.0 + 1e-12)
    q = s["queue"]
    assert np.all((q >= 0) & (q <= N_JOBS)) and np.all(q == np.round(q))
    cap = np.where(q > 0, np.log(np.maximum(q, 1.0)), 0.0)
    assert np.all(s["entropy"][live] <= cap[live] + 1e-12)
    assert np.all(s["efficiency"][live] <= np.sqrt(np.maximum(q[live], 1.0)) + 1e-12)


# ------------------------------------------------------------------ p_hat_err
def test_p_hat_err_probe_tracks_the_estimator():
    """A wrong prior: the first busy epoch reads |prior - p|, the fit pulls
    the error down; per-event values and the stream mean as JAX's."""
    x, a = _tape(seed=5)
    prior = 0.9
    jrule = jes.estimating_rule(jax_make_policy("hesrpt"), 1.0, prior_p=prior,
                                dtype=jnp.float64, n_jobs=N_JOBS)
    rule = tes.estimating_rule(tp.hesrpt, 1.0, prior_p=prior, n_jobs=N_JOBS, device="cpu")
    tel, jtel = {}, {}
    for mode in ("series", "stream"):
        probe = tt.make_probe(("p_hat_err", "queue"), mode=mode, n_jobs=N_JOBS,
                              p_hat_reader=tt.p_hat_error_metric(prior))
        tel[mode] = te.run(_t(x), _t(a), 0.5, rule, telemetry=probe).telemetry
        jprobe = jt.make_probe(("p_hat_err", "queue"), mode=mode, n_jobs=N_JOBS,
                               p_hat_reader=jt.p_hat_error_metric(prior), dtype=jnp.float64)
        jtel[mode] = je.run(x, a, 0.5, jrule, telemetry=jprobe).telemetry
        _assert_tel_match(tel[mode], jtel[mode], ("p_hat_err", "queue"))
    s = {k: v.numpy() for k, v in tel["series"].series.items()}
    err, busy = s["p_hat_err"], (s["dt"] > 0) & (s["queue"] > 0)
    assert np.all((err >= 0) & (err <= 1.0))
    first = err[busy][0]
    assert first == pytest.approx(abs(prior - 0.5), abs=1e-12)
    assert err[busy][-1] < first
    ref = time_weighted_stats(err, s["dt"])
    mean = float(tel["stream"].aggregates["p_hat_err_mean"])
    assert mean == pytest.approx(ref["mean"], abs=1e-12)
    assert 0.0 < mean < abs(prior - 0.5) + 0.11


def _gap_tape():
    """A drift tape with idle gaps: bursts of 4 arrivals an hour apart on
    small jobs, so the pool drains between bursts and waits with dt > 0."""
    x, _ = _tape(seed=6, n_jobs=16)
    a = np.repeat(np.arange(4) * 50.0, 4) + np.tile([0.0, 0.01, 0.02, 0.03], 4)
    return x, a


def test_p_hat_err_matches_jax_on_a_drift_tape_with_idle_epochs():
    """Under drift the port's p is a [C, 1] column; on an idle epoch the
    truth is the row's current p (JAX's scalar), so err = |0 - p| there."""
    x, a = _gap_tape()
    drift_j = je.PDrift(times=jnp.asarray([90.0]), values=jnp.asarray([0.8, 0.3]))
    drift_t = te.PDrift(torch.tensor([90.0], dtype=torch.float64),
                        torch.tensor([0.8, 0.3], dtype=torch.float64))
    prior = 0.8
    jrule = jes.estimating_rule(jax_make_policy("hesrpt"), 4.0, prior_p=prior, discount=0.9,
                                dtype=jnp.float64, n_jobs=16)
    rule = tes.estimating_rule(tp.hesrpt, 4.0, prior_p=prior, discount=0.9, n_jobs=16,
                               device="cpu")
    metrics = ("p_hat_err", "queue", "efficiency")
    for mode in ("series", "stream"):
        kw = dict(mode=mode, n_jobs=16)
        want = je.run(x, a, prior, jrule, p_drift=drift_j, telemetry=jt.make_probe(
            metrics, p_hat_reader=jt.p_hat_error_metric(prior), dtype=jnp.float64, **kw))
        got = te.run(_t(x), _t(a), prior, rule, p_drift=drift_t, telemetry=tt.make_probe(
            metrics, p_hat_reader=tt.p_hat_error_metric(prior), **kw))
        np.testing.assert_allclose(got.completion_times.numpy(),
                                   np.asarray(want.completion_times), rtol=RTOL, atol=0)
        _assert_tel_match(got.telemetry, want.telemetry, metrics)
        if mode == "series":
            s = {k: v.numpy() for k, v in got.telemetry.series.items()}
            idle = (s["dt"] > 0) & (s["queue"] == 0)
            assert idle.sum() >= 3, "the tape must have idle epochs"
            p_now = np.where(s["t"] >= 90.0, 0.3, 0.8)
            np.testing.assert_array_equal(s["p_hat_err"][idle], p_now[idle])


# ------------------------------------------------------------ stream loops
@pytest.mark.parametrize("n_slots", [N_JOBS, 12])
@pytest.mark.parametrize("kind", KINDS)
def test_windowed_stream_probe_matches_jax(kind, n_slots):
    """run_stream(telemetry=) with a windowed probe against JAX's, and a
    probe-free stream run unchanged beside it."""
    x, a = _tape(seed=7, rate=4.0)
    jrule, rule, unit, fused = _rules(kind)
    span = float(a.max())
    window = (0.1 * span, 0.9 * span)
    kw = dict(mode="stream", alloc_unit=unit, n_jobs=n_slots, window=window)
    want = je.run_stream(x, a, 0.5, jrule, n_slots=n_slots, window=window, fused=fused,
                         telemetry=jt.make_probe(jt.DEFAULT_METRICS, dtype=jnp.float64, **kw))
    got = te.run_stream(_t(x), _t(a), 0.5, rule, n_slots=n_slots, window=window, fused=fused,
                        telemetry=tt.make_probe(tt.DEFAULT_METRICS, **kw))
    plain = te.run_stream(_t(x), _t(a), 0.5, rule, n_slots=n_slots, window=window,
                          fused=fused)
    for field in plain._fields:
        if field != "telemetry" and getattr(plain, field) is not None:
            assert torch.equal(getattr(got, field), getattr(plain, field)), field
    _close(got.mean_flow, want.mean_flow, "mean_flow")
    _assert_tel_match(got.telemetry, want.telemetry, tt.DEFAULT_METRICS)
    assert float(got.telemetry.aggregates["time"]) <= 0.8 * span + 1e-9


def test_stream_source_probe_matches_jax():
    """run_stream_source(tape_source, telemetry=) against JAX's."""
    x, a = _tape(seed=8, rate=4.0)
    order = np.argsort(a, kind="stable")
    jrule, rule, unit, _ = _rules("quantized")
    kw = dict(mode="stream", alloc_unit=unit, n_jobs=8)
    want = je.run_stream_source(
        je.tape_source(jnp.asarray(x[order]), jnp.asarray(a[order])), 0.5, jrule, n_slots=8,
        n_events=2 * N_JOBS, x_scale=float(x.max()),
        telemetry=jt.make_probe(jt.DEFAULT_METRICS, dtype=jnp.float64, **kw))
    got = te.run_stream_source(
        te.tape_source(_t(x[order])[None], _t(a[order])[None]), 0.5, rule, n_slots=8,
        n_events=2 * N_JOBS, x_scale=float(x.max()),
        telemetry=tt.make_probe(tt.DEFAULT_METRICS, **kw))
    assert got.telemetry.aggregates["time"].shape == (1,)
    one = got.telemetry._replace(aggregates={k: v[0] for k, v in got.telemetry.aggregates.items()})
    _assert_tel_match(one, want.telemetry, tt.DEFAULT_METRICS)


# ------------------------------------------------------------------ validation
def test_make_probe_validation():
    with pytest.raises(ValueError, match="mode"):
        tt.make_probe(mode="rolling")
    with pytest.raises(ValueError, match="unknown telemetry metric"):
        tt.make_probe(("throughput",), mode="series")
    with pytest.raises(ValueError, match="p_hat_reader"):
        tt.make_probe(("p_hat_err",), mode="series")
    with pytest.raises(ValueError, match="n_jobs"):
        tt.make_probe(mode="stream")
    with pytest.raises(ValueError, match="stream-mode"):
        x, a = (_t(v) for v in _tape(seed=6, n_jobs=10))
        _, rule, _, _ = _rules("continuous")
        probe = tt.make_probe(("queue",), mode="series")
        tel = te.run(x, a, 0.5, rule, telemetry=probe).telemetry
        tt.scalar_values(tel, ("queue",))


def test_sweep_telemetry_validation():
    with pytest.raises(ValueError, match="unknown telemetry"):
        tsw.Sweep.create(["hesrpt"], [1.0], telemetry=("nope",))
    with pytest.raises(ValueError, match="estimator"):
        tsw.Sweep.create(["hesrpt"], [1.0], telemetry=("p_hat_err",))
    with pytest.raises(ValueError, match="superstep sweeps take no"):
        tsw.Sweep.create(["hesrpt"], [1.0], telemetry=True, superstep=True)
    assert tsw.Sweep.create(["hesrpt"], [1.0], telemetry=True).telemetry == tt.DEFAULT_METRICS


# -------------------------------------------------------------- sweep threading
def test_sweep_telemetry_columns_ride_along_without_perturbing_metrics():
    """A telemetry sweep leaves the carried-rank loop for engine.run, whose
    flows agree with it; the columns are finite, utilization in (0, 1]."""
    base = tsw.Sweep.create(["hesrpt", "srpt"], [0.5, 4.0], n_jobs=30, n_seeds=3)
    tele = base._replace(telemetry=tt.DEFAULT_METRICS)
    r0 = tsw.run_sweep(base, device="cpu")
    r1 = tsw.run_sweep(tele, device="cpu")
    for pol in ("hesrpt", "srpt"):
        for metric in base.metrics:
            np.testing.assert_allclose(r1.stats[pol][metric], r0.stats[pol][metric],
                                       rtol=RTOL, atol=0)
        for col in tt.scalar_columns(tt.DEFAULT_METRICS):
            assert r1.stats[pol][col].shape == (2, 3)
            assert np.all(np.isfinite(r1.stats[pol][col]))
        util = r1.stats[pol]["tel_utilization_max"]
        assert np.all((util > 0) & (util <= 1.0 + 1e-12))


def test_sweep_telemetry_quantized_and_estimator_arms():
    q = tsw.Sweep.create(["hesrpt"], [2.0], n_jobs=24, n_seeds=2, n_chips=64,
                         telemetry=("utilization", "queue"))
    util = tsw.run_sweep(q, device="cpu").stats["hesrpt"]["tel_utilization_max"]
    assert np.all(util <= 1.0 + 1e-12)
    est = tsw.Sweep.create(["hesrpt"], [2.0], scenario="drift_poisson",
                           scenario_kw={"p0": 0.7, "p1": 0.3}, n_jobs=30, n_seeds=2,
                           arm="estimator", telemetry=("queue", "p_hat_err"))
    err = tsw.run_sweep(est, device="cpu").stats["hesrpt"]["tel_p_hat_err_mean"]
    assert np.all((err >= 0) & (err <= 1.0))


def test_record_carries_provenance_and_round_trips():
    spec = tsw.Sweep.create(["hesrpt"], [1.0], n_jobs=16, n_seeds=2, telemetry=("queue",))
    res = tsw.run_sweep(spec, device="cpu")
    rec = res.record()
    assert rec["provenance"]["schema_version"] == tsw.SCHEMA_VERSION
    assert rec["provenance"]["torch_version"] == torch.__version__
    assert "tel_queue_mean" in rec["cells"]["hesrpt"]
    assert rec["spec"]["telemetry"] == ["queue"]
    assert tsw.Sweep.from_spec_dict(rec["spec"]) == spec
    jspec = js.Sweep.create(["hesrpt"], [1.0], n_jobs=16, n_seeds=2, telemetry=("queue",))
    jrec = js.SweepResult(jspec, {}, 0.0, 0.0, "cpu", 1, None, False).record()
    assert set(jrec["spec"]) == set(rec["spec"])
    assert tsw.Sweep.from_spec_dict(jrec["spec"]) == spec


def _jax_tapes(spec):
    keys = jax.random.split(jax.random.PRNGKey(spec.seed), spec.n_seeds)
    sample = make_scenario(spec.scenario, size_alpha=spec.size_alpha, p=spec.p)
    cells = [[sample(k, spec.n_jobs, r) for k in keys] for r in spec.rates]
    x0 = np.asarray([[np.asarray(c.x0) for c in row] for row in cells])
    arr = np.asarray([[np.asarray(c.arrival_times) for c in row] for row in cells])
    return x0, arr


_SWEEPS = {
    "continuous": dict(),
    "quantized": dict(n_chips=N_CHIPS),
    "fused": dict(n_chips=N_CHIPS, fused=True),
    "stream": dict(n_chips=N_CHIPS, stream={"n_slots": 8},
                   metrics=("stream_flow", "stream_completed")),
    "stream-continuous": dict(stream={"n_slots": 8}),
}


@pytest.mark.parametrize("regime", sorted(_SWEEPS))
def test_telemetry_sweep_matches_jax_on_its_tapes(regime):
    """Every column of a telemetry sweep (flows and tel_*) against JAX's
    run_sweep on the JAX sampler's tapes, through simulate_cells."""
    jspec = js.Sweep.create(("hesrpt",), (1.0, 8.0), n_jobs=30, n_seeds=2, p=0.5,
                            n_servers=64.0, telemetry=True, **_SWEEPS[regime])
    res_j = js.run_sweep(jspec, log=False)
    spec = tsw.Sweep.from_spec_dict(res_j.record()["spec"])
    assert spec.telemetry == tt.DEFAULT_METRICS
    x0, arr = _jax_tapes(jspec)
    got = tsw.simulate_cells(spec, x0, arr, device="cpu")["hesrpt"]
    assert set(got) == set(res_j.stats["hesrpt"]) == set(spec.out_names())
    for col in spec.out_names():
        want = np.asarray(res_j.stats["hesrpt"][col])
        assert got[col].shape == want.shape == (2, 2), col
        _close(got[col], want, col)
