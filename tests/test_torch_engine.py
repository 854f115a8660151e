"""repro_torch's event loop against the JAX engine on shared tapes.

Tapes are drawn by ``repro.core.scenarios.make_scenario("poisson")`` and
handed to both packages as numpy arrays.  Each JAX configuration runs once,
``jit(vmap)`` over all tapes, to bound compile time.

- completion times to ``RTOL = 1e-12`` relative (the ROADMAP bar; the
  measured gap is ~1e-15, from ``pow``/``sqrt`` ulps between XLA-CPU and
  torch-CPU);
- the chips chosen at every event equal (``record=True`` traces), for the
  unfused and the fused quantized rule;
- inside the port: fused equals unfused bit for bit, and a batched
  ``[cells, M]`` run equals each cell run alone.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as je  # noqa: E402
from repro.core import policies as jp  # noqa: E402
from repro.core.scenarios import make_scenario  # noqa: E402
from repro_torch.core import arrivals as ta  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import policies as tp  # noqa: E402
from repro_torch.core import simulator as ts  # noqa: E402

RTOL = 1e-12
M = 40
P = 0.5


@functools.lru_cache(maxsize=1)
def _tapes():
    """[8, M] poisson tapes: 4 seeds x rates 2 and 8 (light and heavy load)."""
    sample = make_scenario("poisson")
    xs, arrs = [], []
    for rate in (2.0, 8.0):
        for seed in range(4):
            scn = sample(jax.random.PRNGKey(seed), M, rate)
            xs.append(np.asarray(scn.x0))
            arrs.append(np.asarray(scn.arrival_times))
    return np.stack(xs), np.stack(arrs)


def _jax_run(rule, **kw):
    x, a = _tapes()

    def one(xv, av):
        res = je.run(xv, av, P, rule, **kw)
        alloc = res.trace.alloc if res.trace is not None else None
        return res.completion_times, alloc

    return jax.jit(jax.vmap(one))(jnp.asarray(x), jnp.asarray(a))


def _assert_times_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("n_chips,min_chips", [(16, 1), (8, 2)])
def test_quantized_run_matches_jax_event_for_event(n_chips, min_chips):
    """Unfused and fused: chips equal at every event, completion times
    within RTOL; in the port fused == unfused bit for bit."""
    x, a = (torch.tensor(v) for v in _tapes())
    jrule = je.quantized_rule(jp.hesrpt, n_chips, min_chips=min_chips, dtype=jnp.float64)
    trule = te.quantized_rule(tp.hesrpt, n_chips, min_chips=min_chips)
    times_j, chips_j = _jax_run(jrule, record=True)
    unfused = te.run(x, a, P, trule, record=True)
    fused = te.run(x, a, P, trule, record=True, fused=True)
    for got in (unfused, fused):
        np.testing.assert_array_equal(got.trace.alloc.numpy(), np.asarray(chips_j))
        _assert_times_close(got.completion_times, times_j)
    assert torch.equal(fused.trace.alloc, unfused.trace.alloc)
    assert torch.equal(fused.trace.times, unfused.trace.times)
    assert torch.equal(fused.completion_times, unfused.completion_times)


def test_continuous_run_and_ranked_match_jax():
    x, a = (torch.tensor(v) for v in _tapes())
    times_j, _ = _jax_run(je.continuous_rule(jp.hesrpt, 64.0, dtype=jnp.float64))
    rule = te.continuous_rule(tp.hesrpt, 64.0)
    _assert_times_close(te.run(x, a, P, rule).completion_times, times_j)
    fused = te.run(x, a, P, rule, fused=True).completion_times
    assert torch.equal(fused, te.run(x, a, P, rule).completion_times)

    ranked_j = jax.jit(jax.vmap(
        lambda xv, av: je.run_ranked(xv, av, P, 64.0, jp.hesrpt_theta_from_ranks)
    ))(jnp.asarray(_tapes()[0]), jnp.asarray(_tapes()[1]))
    ranked_t = te.run_ranked(x, a, P, 64.0, tp.hesrpt_theta_from_ranks)
    _assert_times_close(ranked_t, ranked_j)
    _assert_times_close(ranked_t, times_j)


def test_batched_cells_equal_single_cell_runs():
    x, a = (torch.tensor(v) for v in _tapes())
    rule = te.quantized_rule(tp.hesrpt, 16)
    batched = te.run(x, a, P, rule, fused=True).completion_times
    ranked = te.run_ranked(x, a, P, 64.0, tp.hesrpt_theta_from_ranks)
    for c in range(x.shape[0]):
        assert torch.equal(te.run(x[c], a[c], P, rule, fused=True).completion_times, batched[c])
        one = te.run_ranked(x[c], a[c], P, 64.0, tp.hesrpt_theta_from_ranks)
        assert torch.equal(one, ranked[c])
    # leading dims are kept: [2, 4, M] in, [2, 4, M] out
    grid = te.run(x.reshape(2, 4, M), a.reshape(2, 4, M), P, rule, fused=True)
    assert torch.equal(grid.completion_times.reshape(8, M), batched)


def test_online_wrappers_match_engine_and_flows():
    x, a = _tapes()
    got = ta.simulate_online_quantized(x, a, P, 16, tp.hesrpt, fused=True, device="cpu")
    rule = te.quantized_rule(tp.hesrpt, 16)
    times = te.run(torch.tensor(x), torch.tensor(a), P, rule).completion_times
    assert torch.equal(got.completion_times, times)
    assert torch.equal(got.mean_flowtime, (times - torch.tensor(a)).mean(-1))
    ranked = ta.simulate_online_ranked(x, a, P, 64.0, tp.hesrpt_theta_from_ranks, device="cpu")
    generic = ta.simulate_online(x, a, P, 64.0, tp.hesrpt, device="cpu")
    np.testing.assert_allclose(
        ranked.mean_flowtime.numpy(), generic.mean_flowtime.numpy(), rtol=RTOL
    )


def test_batch_simulate_matches_theorem_8():
    """All jobs present at t=0: the simulator's total flow time equals the
    Thm-8 closed form."""
    from repro_torch.core.flowtime import hesrpt_total_flowtime

    x = torch.tensor(_tapes()[0][:3])
    res = ts.simulate(x, P, 256.0, tp.hesrpt, device="cpu")
    closed = hesrpt_total_flowtime(torch.sort(x, -1, descending=True).values, P, 256.0)
    np.testing.assert_allclose(res.total_flowtime.numpy(), closed.numpy(), rtol=1e-10)


def test_unported_engine_options_raise():
    """A per-job p on the carried-rank loop is refused (its invariants need
    one exponent; per-job rows and per-job p run in engine.run, held in
    tests/test_torch_multiclass.py); a probe on the superstep is refused in
    the JAX package's words (probes ride the per-event loop, held in
    tests/test_torch_telemetry.py); scalar drift regimes and the superstep
    are held in tests/test_torch_drift.py and tests/test_torch_superstep.py."""
    from repro_torch.core.telemetry import make_probe

    x, a = (torch.tensor(v[0]) for v in _tapes())
    rule = te.quantized_rule(tp.hesrpt, 16)
    with pytest.raises(ValueError, match="run_ranked needs a scalar p"):
        te.run_ranked(x, a, torch.full((M,), P, dtype=torch.float64), 16.0,
                      tp.hesrpt_theta_from_ranks)
    with pytest.raises(ValueError, match="telemetry probes ride the per-event scan"):
        te.run(x, a, P, te.continuous_rule(tp.hesrpt, 16.0), superstep=True,
               telemetry=make_probe(mode="series"))
    with pytest.raises(ValueError, match="fused_variant"):
        te.run(x, a, P, te.quantized_rule(tp.equi, 16), fused=True)


def test_trace_scenario_matches_jax_simulate_scenario():
    """A numpy trace through each package's trace_scenario and
    simulate_scenario (whole chips, fused in the port)."""
    from repro.core.arrivals import simulate_scenario as jax_simulate_scenario
    from repro.core.scenarios import trace_scenario as jax_trace_scenario
    from repro_torch.core.scenarios import tape_from_numpy, trace_scenario

    x, a = (v[5] for v in _tapes())
    scn = trace_scenario(a, x, device="cpu")(None, M, 1.0)
    tape = tape_from_numpy(x, a, device="cpu")
    assert torch.equal(scn.x0, tape.x0) and scn.x0.dtype == torch.float64
    got = ta.simulate_scenario(scn, P, 16.0, tp.hesrpt, n_chips=16, fused=True, device="cpu")
    want = jax_simulate_scenario(
        jax_trace_scenario(a, x)(None, M, 1.0), P, 16.0, jp.hesrpt, n_chips=16
    )
    _assert_times_close(got.completion_times, want.completion_times)
    assert float(got.mean_flowtime) == pytest.approx(float(want.mean_flowtime), rel=RTOL)
    with pytest.raises(ValueError, match="jobs"):
        trace_scenario(a, x, device="cpu")(None, M + 1, 1.0)
