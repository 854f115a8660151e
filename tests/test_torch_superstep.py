"""repro_torch's closed-form superstep path against the JAX package's and
against the port's own generic event loop.

Tapes are drawn by ``repro.core.scenarios.make_scenario`` (poisson,
deterministic, batch) and handed to both packages as numpy arrays; each
JAX configuration runs once, ``jit(vmap)`` over all tapes.

- ``run_superstep`` and ``batch_result_closed_form`` against JAX's, for
  heSRPT, EQUI, SRPT and ``weighted_hesrpt``: ``RTOL = 1e-12`` relative
  (the ROADMAP bar; ``pow`` ulps differ between XLA-CPU and torch-CPU);
- the superstep against the port's ``engine.run`` over ``continuous_rule``:
  ``1e-10`` absolute, SRPT by sorted spectra (tied sizes may swap places),
  as ``tests/test_superstep.py`` holds the JAX pair;
- the flowtime closed forms against JAX's;
- ``Sweep.create(superstep=True)`` against the plain sweep, and what the
  superstep path refuses (``p_drift`` still raises, naming ROADMAP.md).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import flowtime as jf  # noqa: E402
from repro.core import superstep as jss  # noqa: E402
from repro.core.scenarios import make_scenario  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import flowtime as tf  # noqa: E402
from repro_torch.core import policies as tp  # noqa: E402
from repro_torch.core import superstep as tss  # noqa: E402
from repro_torch.core import sweeps as tsw  # noqa: E402
from repro_torch.core.arrivals import simulate_online_superstep  # noqa: E402

RTOL = 1e-12
M = 32
P = 0.5
N = 8.0
SCENARIOS = ("poisson", "deterministic", "batch")
POLICIES = ("hesrpt", "equi", "srpt", "weighted_hesrpt")


@functools.lru_cache(maxsize=1)
def _tapes():
    """[6, M]: two seeds of each scenario, with exact size ties in row 0."""
    xs, arrs = [], []
    for name in SCENARIOS:
        for seed in range(2):
            scn = make_scenario(name)(jax.random.PRNGKey(seed), M, 1.2)
            xs.append(np.asarray(scn.x0))
            arrs.append(np.asarray(scn.arrival_times))
    x, a = np.stack(xs), np.stack(arrs)
    x[0, :4] = x[0, 4:8]
    return x, a


def _weights(pol, x):
    # Slowdown weights 1/x: non-increasing in size, where the closed form holds.
    return 1.0 / x if pol == "weighted_hesrpt" else None


@pytest.mark.parametrize("pol", POLICIES)
def test_run_superstep_matches_jax(pol):
    x, a = _tapes()
    w = _weights(pol, x)

    def one(xv, av, wv):
        return jss.run_superstep(xv, av, P, N, pol, weights=wv).completion_times

    want = jax.jit(jax.vmap(one))(jnp.asarray(x), jnp.asarray(a), jnp.asarray(1.0 / x))
    got = tss.run_superstep(
        torch.tensor(x), torch.tensor(a), P, N, pol,
        weights=None if w is None else torch.tensor(w),
    )
    assert np.all(np.isfinite(got.completion_times.numpy()))
    np.testing.assert_allclose(got.completion_times.numpy(), np.asarray(want), rtol=RTOL, atol=0)
    np.testing.assert_array_equal(got.x_final.numpy(), 0.0)


@pytest.mark.parametrize("pol", POLICIES)
@pytest.mark.parametrize("p", (0.25, 0.5, 0.9))
def test_batch_closed_form_matches_jax(pol, p):
    """The all-present batch, sizes in input order (zeros included), with
    the exact trajectory x_i(t) at times before, inside and past the run."""
    x = _tapes()[0].copy()
    x[1, 3] = 0.0
    w = 1.0 / np.where(x > 0, x, 1.0)
    ts = np.array([0.0, 0.7, 3.0, 1e3])

    def one(xv, wv):
        bc = jss.batch_result_closed_form(
            xv, p, pol, n_servers=N, weights=wv, t0=0.5, eval_times=ts
        )
        return bc.completion_times, bc.sizes_at

    want_t, want_s = jax.jit(jax.vmap(one))(jnp.asarray(x), jnp.asarray(w))
    got = tss.batch_result_closed_form(
        torch.tensor(x), p, pol, n_servers=N, weights=torch.tensor(w), t0=0.5, eval_times=ts
    )
    np.testing.assert_allclose(got.completion_times.numpy(), np.asarray(want_t), rtol=RTOL, atol=0)
    assert got.sizes_at.shape == (len(x), len(ts), M)
    np.testing.assert_allclose(got.sizes_at.numpy(), np.asarray(want_s), rtol=RTOL, atol=1e-13)


@pytest.mark.parametrize("pol", ("hesrpt", "equi", "srpt"))
@pytest.mark.parametrize("pre_arrived", (False, True))
def test_superstep_matches_port_generic_loop(pol, pre_arrived):
    """engine.run(superstep=True) dispatches to run_superstep and agrees
    with the generic loop on every tape (the batch with no step at all)."""
    x, a = (torch.tensor(v) for v in _tapes())
    rule = te.continuous_rule(tp.make_policy(pol), N)
    ss = te.run(x, a, P, rule, superstep=True, pre_arrived=pre_arrived).completion_times
    gen = te.run(x, a, P, rule, pre_arrived=pre_arrived).completion_times
    if pol == "srpt":
        ss, gen = ss.sort(-1).values, gen.sort(-1).values
    np.testing.assert_allclose(ss.numpy(), gen.numpy(), rtol=0, atol=1e-10)


def test_batch_closed_form_is_theorem_3_and_8():
    """Bit for bit the Thm-3 completion times; summed, Theorem 8."""
    x = torch.tensor(np.sort(_tapes()[0], -1)[:, ::-1].copy())
    for p in (0.25, 0.5, 0.9):
        bc = tss.batch_result_closed_form(x, p, "hesrpt", n_servers=N).completion_times
        assert torch.equal(bc, tf.hesrpt_completion_times(x, p, N))
        np.testing.assert_allclose(
            bc.sum(-1).numpy(), tf.hesrpt_total_flowtime(x, p, N).numpy(), rtol=1e-13
        )


@pytest.mark.parametrize("p", (0.25, 0.5, 0.9))
def test_flowtime_closed_forms_match_jax(p):
    x = np.sort(_tapes()[0], -1)[:, ::-1].copy()
    w = np.random.default_rng(3).uniform(0.5, 2.0, x.shape)
    xt, wt = torch.tensor(x), torch.tensor(w)
    rows = range(len(x))
    cases = (
        (tf.omega_weighted(wt, p), [jf.omega_weighted(jnp.asarray(w[i]), p) for i in rows]),
        (tf.weighted_total_flowtime(xt, wt, p, N),
         [jf.weighted_total_flowtime(jnp.asarray(x[i]), jnp.asarray(w[i]), p, N) for i in rows]),
        (tf.hesrpt_sd_mean_slowdown(xt, p, N),
         [jf.hesrpt_sd_mean_slowdown(jnp.asarray(x[i]), p, N) for i in rows]),
        (tf.optimal_makespan(xt, p, N),
         [jf.optimal_makespan(jnp.asarray(x[i]), p, N) for i in rows]),
        (tf.hesrpt_completion_times(xt, p, N),
         [jf.hesrpt_completion_times(jnp.asarray(x[i]), p, N) for i in rows]),
    )
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.stack([np.asarray(v) for v in want]),
                                   rtol=RTOL, atol=0)
    for pol in ("hesrpt", "equi"):
        got = tf.rank_bracket_powers(M, p, pol, device="cpu")
        want = jf.rank_bracket_powers(M, p, pol)
        for g, wv in zip(got, want, strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=RTOL, atol=0)
    got = tf.rank_bracket_powers(M, p, "weighted_hesrpt", weights_rank=wt, device="cpu")
    for i in rows:
        want = jf.rank_bracket_powers(M, p, "weighted_hesrpt", weights_rank=jnp.asarray(w[i]))
        for g, wv in zip(got, want, strict=True):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(wv), rtol=RTOL, atol=0)


def test_sweep_superstep_equals_plain_sweep():
    """Sweep.create(superstep=True) against the plain (carried-rank) sweep
    on the same tapes, cell by cell, as the JAX test holds its pair."""
    kw = dict(n_jobs=30, n_seeds=2, p=P, n_servers=N)
    plain = tsw.Sweep.create(("hesrpt", "equi", "srpt"), (0.8, 4.0), **kw)
    ss = tsw.Sweep.create(("hesrpt", "equi", "srpt"), (0.8, 4.0), superstep=True, **kw)
    assert ss.superstep and ss._replace(superstep=False) == plain
    x0, arr = tsw.draw_tapes(plain, device="cpu")
    want = tsw.simulate_cells(plain, x0, arr, device="cpu")
    got = tsw.simulate_cells(ss, x0, arr, device="cpu")
    for pol in plain.policies:
        np.testing.assert_allclose(got[pol]["mean_flowtime"], want[pol]["mean_flowtime"],
                                   rtol=1e-9)
    online = simulate_online_superstep(x0, arr, P, N, "hesrpt", device="cpu")
    np.testing.assert_allclose(online.mean_flowtime.numpy(), want["hesrpt"]["mean_flowtime"],
                               rtol=1e-9)


def test_sweep_superstep_envelope_and_round_trip():
    """The JAX record's spec with superstep on reads back as the port's;
    what the closed form cannot take is refused."""
    from repro.core import sweeps as js

    spec_j = js.Sweep.create(("hesrpt", "srpt"), (0.5,), n_jobs=10, n_seeds=2, superstep=True)
    d = js.SweepResult(spec_j, {}, 0.0, 0.0, "cpu", 1, None, False).record()["spec"]
    assert tsw.Sweep.from_spec_dict(d).superstep is True
    base = dict(n_jobs=10, n_seeds=2)
    with pytest.raises(ValueError, match="continuous"):
        tsw.Sweep.create(("hesrpt",), (1.0,), n_chips=16, superstep=True, **base)
    with pytest.raises(ValueError, match="heSRPT/EQUI/SRPT"):
        tsw.Sweep.create(("knee",), (1.0,), superstep=True, **base)
    with pytest.raises(ValueError):
        tsw.Sweep.create(("hesrpt",), (1.0,), n_chips=16, fused=True, superstep=True, **base)


def test_superstep_refusals():
    x, a = (torch.tensor(v[:2]) for v in _tapes())
    rule = te.continuous_rule(tp.hesrpt, N)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        te.run(x, a, P, rule, superstep=True, p_drift=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tss.run_superstep(x, a, P, N, "hesrpt", p_drift=object())
    with pytest.raises(ValueError, match="superstep_spec"):
        te.run(x, a, P, te.quantized_rule(tp.hesrpt, 16), superstep=True)
    with pytest.raises(ValueError, match="superstep_spec"):
        te.run(x, a, P, te.continuous_rule(tp.helrpt, N), superstep=True)
    with pytest.raises(ValueError, match="fused"):
        te.run(x, a, P, rule, superstep=True, fused=True)
    with pytest.raises(ValueError, match="record"):
        te.run(x, a, P, rule, superstep=True, record=True)
    with pytest.raises(ValueError, match="scalar p"):
        te.run(x, a, torch.full((M,), P, dtype=torch.float64), rule, superstep=True)
    with pytest.raises(ValueError, match="supports"):
        tss.run_superstep(x, a, P, N, "knee")
    with pytest.raises(ValueError, match="weights"):
        tss.batch_result_closed_form(x, P, "weighted_hesrpt", n_servers=N)
