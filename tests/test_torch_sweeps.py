"""repro_torch sweeps and lanes against the JAX sweep on the JAX's own tapes.

- The three canonical lanes at ``--smoke`` shape (60 jobs, 2 seeds), cut to
  2 of their 5 rates to bound the JAX compile time: the JAX sweep's tapes
  are rebuilt from ``jax.random.split(PRNGKey(seed), S)`` x rates and go
  through ``simulate_cells``; per-cell mean flow must agree with
  ``repro.core.sweeps.run_sweep`` to ``RTOL = 1e-12`` relative.  The port's
  spec is read from the JAX record (``Sweep.from_spec_dict``).
- Inside the port: the fused lane equals the unfused one bit for bit.
- The port's own samplers are held in distribution only (they cannot draw
  JAX's threefry streams): poisson, bursty and the drift scenarios.
- Seed chunking: chunked == unchunked bit for bit for every chunk size; the
  run log's records carry the JAX record's keys; ``load_sweep`` and the
  analysis helpers against JAX.
"""

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import sweeps as js  # noqa: E402
from repro.core.scenarios import make_scenario  # noqa: E402
from repro_torch import lanes  # noqa: E402
from repro_torch.core import scenarios as tsc  # noqa: E402
from repro_torch.core import sweeps as tsw  # noqa: E402

RTOL = 1e-12
RATES = (1.0, 8.0)


def _jax_tapes(spec):
    """The tapes the JAX sweep draws: one key per seed, shared by the rates."""
    keys = jax.random.split(jax.random.PRNGKey(spec.seed), spec.n_seeds)
    sample = make_scenario(spec.scenario, size_alpha=spec.size_alpha, p=spec.p)
    cells = [[sample(k, spec.n_jobs, r) for k in keys] for r in spec.rates]
    x0 = np.asarray([[np.asarray(c.x0) for c in row] for row in cells])
    arr = np.asarray([[np.asarray(c.arrival_times) for c in row] for row in cells])
    return x0, arr


@functools.lru_cache(maxsize=None)
def _jax_lane(label):
    import benchmarks.backend_lane as bl

    spec = dict(bl.lane_specs(smoke=True))[label]
    spec = spec._replace(rates=RATES)
    return js.run_sweep(spec, log=False)


@pytest.mark.parametrize("label", lanes.LABELS)
def test_lane_matches_jax_sweep_on_its_tapes(label):
    res_j = _jax_lane(label)
    spec = tsw.Sweep.from_spec_dict(res_j.record()["spec"])
    want = dict(lanes.lane_specs(smoke=True))[label]._replace(rates=RATES)
    assert spec == want  # the JAX lane spec and the port's are one spec
    x0, arr = _jax_tapes(res_j.spec)
    got = tsw.simulate_cells(spec, x0, arr, device="cpu")["hesrpt"]["mean_flowtime"]
    wanted = res_j.stats["hesrpt"]["mean_flowtime"]
    assert got.shape == wanted.shape == (len(RATES), 2)
    np.testing.assert_allclose(got, wanted, rtol=RTOL, atol=0)


def test_fused_lane_equals_unfused_lane_bit_for_bit():
    results = lanes.run_lanes(smoke=True, device="cpu")
    assert [label for label, _ in results] == list(lanes.LABELS)
    assert lanes.fused_equals_unfused(results)
    records = lanes.lane_records(results)
    assert records[-1]["kind"] == "backend_lane" and records[-1]["backend"] == "cpu"
    for rec in records[:-1]:
        assert rec["provenance"]["torch_version"] == torch.__version__
        assert rec["provenance"]["device_name"] == "cpu"
        means = rec["cells"]["hesrpt"]["mean_flowtime"]["mean"]
        assert len(means) == len(lanes.RATES_SMOKE) and all(np.isfinite(means))


def test_from_spec_dict_round_trips_and_refuses_unported_regimes():
    spec_j = js.Sweep.create(("hesrpt", "equi"), (0.5, 2.0), n_jobs=30, n_seeds=3, p=0.3,
                             n_servers=64.0, seed=4, n_chips=64, min_chips=2)
    d = js.SweepResult(spec_j, {}, 0.0, 0.0, "cpu", 1, None, False).record()["spec"]
    spec_t = tsw.Sweep.from_spec_dict(d)
    for field in tsw.Sweep._fields:
        assert getattr(spec_t, field) == getattr(spec_j, field), field
    # snap_slices: the JAX package's own refusal (it wires it only for
    # multi-class sweeps), and telemetry with classes (the reference threads
    # no probe through simulate_multiclass); a per-class noise sequence on a
    # one-class scenario is refused where it is drawn, as in JAX.
    with pytest.raises(ValueError, match="multi-class"):
        tsw.Sweep.from_spec_dict({**d, "snap_slices": True})
    with pytest.raises(ValueError, match="multi-class"):
        js.Sweep.create(("hesrpt",), (1.0,), n_chips=16, snap_slices=True)
    classes = [[0.3, 1.0], [0.7, 1.0]]
    mc = {**d, "scenario": "multiclass_poisson", "policies": ["hesrpt_pc"], "classes": classes}
    with pytest.raises(ValueError, match="single-class only for now"):
        tsw.Sweep.from_spec_dict({**mc, "telemetry": ["efficiency"]})
    assert tsw.Sweep.from_spec_dict({**mc, "n_chips": None}).classes == (
        (0.3, 1.0, 1.5, 1.0, 1.0, 4.0), (0.7, 1.0, 1.5, 1.0, 1.0, 4.0))
    noisy = tsw.Sweep.create(("hesrpt",), (1.0,), scenario="bursty", n_jobs=4, n_seeds=1,
                             scenario_kw={"sigma_size": (0.3, 0.1)})
    with pytest.raises(ValueError, match="per-class sigma needs a multi-class scenario"):
        tsw.draw_scenario(noisy, device="cpu")
    with pytest.raises(TypeError):
        tsw.Sweep.create(("hesrpt",), (1.0,), scenario="poisson", scenario_kw={"burst": 2.0})
    with pytest.raises(ValueError):
        tsw.Sweep.create(("equi",), (1.0,), n_chips=16, fused=True)


def test_port_sampler_in_distribution():
    """Seeded draws: mean gap 1/rate, Pareto(1.5) sizes with minimum 1 and
    tail P(X > t) = t^-1.5; the rate axis shares one draw of unit gaps."""
    n = 200_000
    gen = tsc.seed_generator(0, 0, device="cpu")
    scn = tsc.make_scenario("poisson")(gen, n, (0.5, 4.0))
    assert scn.x0.shape == scn.arrival_times.shape == (2, n)
    gaps = torch.diff(scn.arrival_times, dim=-1, prepend=torch.zeros(2, 1, dtype=torch.float64))
    np.testing.assert_allclose(gaps.mean(-1).numpy(), [2.0, 0.25], rtol=0.01)
    np.testing.assert_allclose((gaps[0] * 0.5).numpy(), (gaps[1] * 4.0).numpy(), rtol=1e-9)
    x = scn.x0[0]
    assert torch.equal(scn.x0[0], scn.x0[1]) and float(x.min()) >= 1.0
    for t in (2.0, 4.0):
        assert float((x > t).double().mean()) == pytest.approx(t ** -1.5, rel=0.03)
    again = tsc.make_scenario("poisson")(tsc.seed_generator(0, 0, device="cpu"), n, (0.5, 4.0))
    assert torch.equal(again.x0, scn.x0)  # seeded
    other = tsc.make_scenario("poisson")(tsc.seed_generator(0, 1, device="cpu"), n, 0.5)
    assert not torch.equal(other.x0, scn.x0[0])


def test_run_sweep_cpu_batch_and_deterministic_scenarios():
    for scenario in ("batch", "deterministic"):
        spec = tsw.Sweep.create(("hesrpt", "equi", "helrpt"), (1.0, 2.0), scenario=scenario,
                                n_jobs=12, n_seeds=2, n_servers=16.0)
        res = tsw.run_sweep(spec, device="cpu")
        for name in spec.policies:
            a = res.stats[name]["mean_flowtime"]
            assert a.shape == (2, 2) and np.all(np.isfinite(a)) and np.all(a > 0)
        if scenario == "batch":  # Thm 7: heSRPT is optimal when all jobs are present
            assert np.all(res.stats["hesrpt"]["mean_flowtime"]
                          <= res.stats["equi"]["mean_flowtime"] * (1 + 1e-12))


def _drift_fused_spec(n_seeds=5):
    spec = dict(lanes.drift_lane_specs(smoke=True))["drift-quantized-fused"]
    return spec._replace(n_seeds=n_seeds, n_jobs=40)


@functools.lru_cache(maxsize=1)
def _unchunked():
    return tsw.run_sweep(_drift_fused_spec(), device="cpu")


@pytest.mark.parametrize("chunk", [1, 2, 3, 4, 5, 9])
def test_chunked_equals_unchunked_bit_for_bit(chunk):
    """The fused drift lane in seed chunks: the same per-seed generators
    draw the same tapes, and every metric equals the one-batch run bit for
    bit; a chunk of every seed or more is recorded as None (one chunk)."""
    spec = _drift_fused_spec()._replace(metrics=("mean_flowtime", "makespan"))
    whole = tsw.run_sweep(spec, device="cpu")
    res = tsw.run_sweep(spec, chunk_seeds=chunk, device="cpu")
    assert res.chunk_seeds == (chunk if chunk < spec.n_seeds else None)
    assert res.record()["chunk_seeds"] == res.chunk_seeds
    for m in spec.metrics:
        assert np.array_equal(res.stats["hesrpt"][m], whole.stats["hesrpt"][m]), m
    assert np.array_equal(whole.stats["hesrpt"]["mean_flowtime"],
                          _unchunked().stats["hesrpt"]["mean_flowtime"])


def test_max_jobs_in_flight_bounds_the_chunk():
    spec = _drift_fused_spec()
    per_seed = spec.jobs_per_seed()
    assert tsw.resolve_chunk(spec, None, 2 * per_seed + 1) == 2
    assert tsw.resolve_chunk(spec, None, 1) == 1  # floor: one seed a chunk
    assert tsw.resolve_chunk(spec, 3, None) == 3
    assert tsw.resolve_chunk(spec, None, None) is None
    with pytest.raises(ValueError, match="not both"):
        tsw.resolve_chunk(spec, 2, 100)
    res = tsw.run_sweep(spec, max_jobs_in_flight=2 * per_seed, device="cpu")
    assert res.chunk_seeds == 2
    assert np.array_equal(res.stats["hesrpt"]["mean_flowtime"],
                          _unchunked().stats["hesrpt"]["mean_flowtime"])


def test_run_log_and_write_bench_json_round_trip(tmp_path):
    """A logged run's record has every top-level key and spec key of the JAX
    record; write_bench_json writes the JAX file's layout where it is told
    (its default is the port's own file, not BENCH_sweeps.json)."""
    assert tsw.BENCH_JSON != "BENCH_sweeps.json"
    before = len(tsw.RUN_LOG)
    spec = _drift_fused_spec(n_seeds=2)
    res = tsw.run_sweep(spec, device="cpu")
    assert len(tsw.RUN_LOG) == min(before + 1, tsw.RUN_LOG_MAX)
    assert tsw.bench_records()[-1] == res.record()
    path = tsw.write_bench_json(tmp_path / "bench.json")
    data = json.loads(open(path).read())
    assert data["schema_version"] == tsw.SCHEMA_VERSION
    rec = data["records"][-1]
    jspec = js.Sweep.create(spec.policies, spec.rates, scenario=spec.scenario,
                            scenario_kw=dict(spec.scenario_kw), n_jobs=spec.n_jobs,
                            n_seeds=spec.n_seeds, p=spec.p, n_chips=spec.n_chips, fused=True)
    jrec = js.SweepResult(jspec, {"hesrpt": {"mean_flowtime": np.zeros((2, 2))}}, 0.0, 0.0,
                          "cpu", 1, None, False).record()
    assert set(jrec) <= set(rec)
    assert set(jrec["spec"]) == set(rec["spec"])
    assert tsw.Sweep.from_spec_dict(rec["spec"]) == spec
    assert rec["cells"]["hesrpt"]["mean_flowtime"]["mean"] == res.record()["cells"][
        "hesrpt"]["mean_flowtime"]["mean"]


def test_load_sweep_is_a_spec_over_run_sweep():
    """load_sweep_raw is run_sweep's per-seed array and load_sweep its seed
    mean, in the JAX functions' shapes ({policy: [R, S]}, {rate: {policy:
    float}}); the values differ from JAX's only through the tapes (parity on
    shared tapes is held above)."""
    from repro.core.arrivals import load_sweep as jax_load_sweep
    from repro_torch.core.arrivals import load_sweep, load_sweep_raw

    kw = dict(n_jobs=20, n_seeds=3, scenario="drift_poisson", n_chips=16)
    raw = load_sweep_raw(("hesrpt", "equi"), (1.0, 4.0), chunk_seeds=2, device="cpu", **kw)
    spec = tsw.Sweep.create(("hesrpt", "equi"), (1.0, 4.0), **kw)
    ref = tsw.run_sweep(spec, device="cpu")
    for name in spec.policies:
        assert np.array_equal(raw[name], ref.stats[name]["mean_flowtime"])
    means = load_sweep(("hesrpt", "equi"), (1.0, 4.0), device="cpu", **kw)
    assert means == ref.cell_means()
    want = jax_load_sweep(("hesrpt", "equi"), (1.0, 4.0), **kw)
    assert list(means) == list(want)
    assert all(list(means[r]) == list(want[r]) for r in means)


def test_analysis_helpers_match_jax():
    """summarize, scale_free_constants and time_weighted_stats on the same
    descending batch through each package's simulate."""
    import jax.numpy as jnp

    from repro.core import analysis as ja
    from repro.core import policies as jp
    from repro.core.simulator import simulate as jax_simulate
    from repro_torch.core import analysis as tan
    from repro_torch.core import policies as tp
    from repro_torch.core.simulator import simulate

    x = np.sort(np.random.default_rng(0).pareto(1.5, 12) + 1.0)[::-1].copy()
    res_j = jax_simulate(jnp.asarray(x), 0.4, 32.0, jp.hesrpt)
    res_t = simulate(torch.tensor(x), 0.4, 32.0, tp.hesrpt, device="cpu")
    sj, st_ = ja.summarize(res_j, 0.4), tan.summarize(res_t, 0.4)
    assert list(sj) == list(st_)
    for key in sj:
        np.testing.assert_allclose(st_[key].numpy(), np.asarray(sj[key]), rtol=1e-12)
    om_j = np.asarray(ja.scale_free_constants(res_j))
    om_t = tan.scale_free_constants(res_t).numpy()
    assert np.array_equal(np.isnan(om_j), np.isnan(om_t))
    np.testing.assert_allclose(om_t[~np.isnan(om_t)], om_j[~np.isnan(om_j)], rtol=1e-9)
    # Thm 4: each active job's omega is the same at every epoch it lives.
    live = ~np.isnan(om_t)
    for j in range(1, len(x)):
        col = om_t[live[:, j], j]
        np.testing.assert_allclose(col, col[0], rtol=1e-9)
    v, dt = np.array([1.0, 3.0, 7.0, 2.0]), np.array([0.5, 0.0, 1.5, 2.0])
    assert tan.time_weighted_stats(v, dt) == ja.time_weighted_stats(v, dt)
    assert tan.time_weighted_stats(v, np.zeros(4)) == ja.time_weighted_stats(v, np.zeros(4))


@pytest.mark.parametrize("scenario", ["bursty", "drift_bursty", "drift_poisson"])
def test_bursty_and_drift_samplers_in_distribution(scenario):
    """Long-run intensity within 10% of nominal at every rate; the bursty
    gaps' lag-1 autocorrelation well above an exponential stream's ~0 (as
    tests/test_engine.py holds JAX's); drift at drift_frac x n / rate."""
    n, rates = 40_000, (0.5, 4.0)
    kw = {"p_stay": 0.97} if "bursty" in scenario else {}
    if scenario.startswith("drift"):
        kw.update(p0=0.7, p1=0.2, drift_frac=0.25)
    scn = tsc.make_scenario(scenario, **kw)(tsc.seed_generator(3, 0, device="cpu"), n, rates)
    assert scn.x0.shape == scn.arrival_times.shape == (2, n)
    arr = scn.arrival_times
    intensity = n / arr[:, -1]
    np.testing.assert_allclose(intensity.numpy(), rates, rtol=0.10)
    gaps = torch.diff(arr, dim=-1).numpy()
    assert np.all(gaps > 0)
    g = (gaps - gaps.mean(-1, keepdims=True)) / gaps.std(-1, keepdims=True)
    lag1 = np.mean(g[:, :-1] * g[:, 1:], -1)
    if "bursty" in scenario:
        assert np.all(lag1 > 0.1), lag1
    else:
        assert np.all(np.abs(lag1) < 0.03), lag1
    if scenario.startswith("drift"):
        np.testing.assert_allclose(scn.p_drift.times.numpy(), [[0.25 * n / 0.5], [0.25 * n / 4.0]])
        assert scn.p_drift.values.tolist() == [0.7, 0.2]
    else:
        assert scn.p_drift is None
