"""repro_torch sweeps and lanes against the JAX sweep on the JAX's own tapes.

- The three canonical lanes at ``--smoke`` shape (60 jobs, 2 seeds), cut to
  2 of their 5 rates to bound the JAX compile time: the JAX sweep's tapes
  are rebuilt from ``jax.random.split(PRNGKey(seed), S)`` x rates and go
  through ``simulate_cells``; per-cell mean flow must agree with
  ``repro.core.sweeps.run_sweep`` to ``RTOL = 1e-12`` relative.  The port's
  spec is read from the JAX record (``Sweep.from_spec_dict``).
- Inside the port: the fused lane equals the unfused one bit for bit.
- The port's own sampler is held in distribution only (it cannot draw
  JAX's threefry streams).
"""

import functools

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
    for regime in ({"snap_slices": True}, {"telemetry": ["efficiency"]}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tsw.Sweep.from_spec_dict({**d, **regime})
    with pytest.raises(NotImplementedError):
        tsw.Sweep.create(("hesrpt",), (1.0,), scenario="bursty")
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
