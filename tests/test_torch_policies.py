"""repro_torch ranking, policies and closed forms against the JAX package.

The same numpy inputs (ties, zeros, p in {0.1, 0.5, 0.9}) go through both
packages.  Ranks must be equal.  Shares and closed forms are held to
``RTOL = 1e-12``: XLA-CPU's and torch-CPU's ``pow`` differ in the last ulps
(up to ~6e-14 relative on single Thm-7 brackets), and ``hi - lo`` can
amplify that by ``~m/c`` for the large ranks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import flowtime as jf  # noqa: E402
from repro.core import policies as jp  # noqa: E402
from repro.core import ranking as jr  # noqa: E402
from repro_torch.core import flowtime as tf  # noqa: E402
from repro_torch.core import policies as tp  # noqa: E402
from repro_torch.core import ranking as tr  # noqa: E402

RTOL = 1e-12
PS = (0.1, 0.5, 0.9)


def _sizes(seed, m=48, zero_frac=0.25):
    """Pareto sizes with exact ties and zeros (departed jobs)."""
    rng = np.random.default_rng(seed)
    x = rng.pareto(1.5, m) + 0.01
    x[rng.random(m) < zero_frac] = 0.0
    x[: m // 4] = x[m // 4 : m // 2]  # exact ties
    return x


@pytest.mark.parametrize("seed", range(4))
def test_ranks_equal_jax(seed):
    x = _sizes(seed)
    jx = jnp.asarray(x)
    ranks_j = np.asarray(jr.ranks_from_order(jr.size_order_desc(jx), jx > 0))
    tx = torch.tensor(x)
    ranks_t = tr.ranks_from_order(tr.size_order_desc(tx), tx > 0).numpy()
    np.testing.assert_array_equal(ranks_t, ranks_j)


def test_ranks_batched_rows_equal_single_rows():
    xs = torch.tensor(np.stack([_sizes(s) for s in range(5)]))
    batched = tr.ranks_from_order(tr.size_order_desc(xs), xs > 0)
    for row, x in zip(batched, xs, strict=True):
        assert torch.equal(row, tr.ranks_from_order(tr.size_order_desc(x), x > 0))


@pytest.mark.parametrize("name", ["hesrpt", "helrpt", "srpt", "equi"])
@pytest.mark.parametrize("p", PS)
def test_policy_theta_matches_jax(name, p):
    for seed in range(3):
        x = _sizes(seed)
        theta_j = np.asarray(jp.make_policy(name)(jnp.asarray(x), p))
        theta_t = tp.make_policy(name)(torch.tensor(x), p).numpy()
        np.testing.assert_allclose(theta_t, theta_j, rtol=RTOL, atol=0, err_msg=f"{name} {seed}")
        assert np.all(theta_t[x <= 0] == 0)


@pytest.mark.parametrize("name", ["hesrpt", "equi", "srpt"])
@pytest.mark.parametrize("p", PS)
def test_rank_forms_match_jax(name, p):
    x = _sizes(7)
    ranks = np.asarray(jp.size_ranks_desc(jnp.asarray(x)))
    m = int((x > 0).sum())
    form = jp.make_rank_policy(name)
    theta_j = np.asarray(form(jnp.asarray(ranks), jnp.asarray(m), p, dtype=jnp.float64))
    theta_t = tp.make_rank_policy(name)(torch.tensor(ranks), torch.tensor(m), p).numpy()
    np.testing.assert_allclose(theta_t, theta_j, rtol=RTOL, atol=0)


def test_hesrpt_ties_break_by_index():
    """Equal sizes get distinct adjacent ranks, the later index the higher
    rank (the larger share) — the reference's contract."""
    theta = tp.hesrpt(torch.tensor([1.0, 1.0]), 0.5).tolist()
    assert theta == [0.25, 0.75]


@pytest.mark.parametrize("c", [1.0, 2.0, 3.0, 2.5])
def test_bracket_pow_matches_pow(c):
    b = torch.linspace(0.0, 1.0, 101, dtype=torch.float64)
    np.testing.assert_allclose(tp.bracket_pow(b, c).numpy(), b.pow(c).numpy(), rtol=1e-15)


@pytest.mark.parametrize("p", PS)
def test_flowtime_closed_forms_match_jax(p):
    x = np.sort(_sizes(3, zero_frac=0.0))[::-1].copy()
    np.testing.assert_allclose(
        tf.omega_star(40, p, device="cpu").numpy(), np.asarray(jf.omega_star(40, p)), rtol=RTOL
    )
    for fn_t, fn_j in (
        (tf.hesrpt_total_flowtime, jf.hesrpt_total_flowtime),
        (tf.hesrpt_mean_flowtime, jf.hesrpt_mean_flowtime),
    ):
        got = float(fn_t(torch.tensor(x), p, 256.0))
        want = float(fn_j(jnp.asarray(x), p, 256.0))
        assert got == pytest.approx(want, rel=RTOL)
    k = torch.tensor([0.0, 1.0, 4.0], dtype=torch.float64)
    np.testing.assert_allclose(
        tf.speedup(k, p).numpy(), np.asarray(jf.speedup(jnp.asarray(k.numpy()), p)), rtol=RTOL
    )


def test_make_policy_identity_and_unported_names():
    """make_policy returns the module functions themselves (the engine
    attaches the fused allocate by identity); HELL, KNEE and water-filling,
    refused until they were ported, now come back as working policies that
    close over n_servers (and alpha), equal to JAX's; unknown names raise."""
    assert tp.make_policy("heSRPT") is tp.hesrpt
    assert tp.make_policy("srpt") is tp.srpt
    assert tp.POLICY_NAMES == jp.POLICY_NAMES
    x = _sizes(5)
    for name in ("hell", "knee", "waterfill"):
        for p in (0.3, 0.7):
            kw = dict(n_servers=64.0, alpha=0.05)
            theta_t = tp.make_policy(name, **kw)(torch.tensor(x), p).numpy()
            theta_j = np.asarray(jp.make_policy(name, **kw)(jnp.asarray(x), p))
            np.testing.assert_allclose(theta_t, theta_j, rtol=RTOL, atol=0, err_msg=name)
            assert theta_t.sum() == pytest.approx(1.0, rel=1e-12)
    with pytest.raises(ValueError):
        tp.make_policy("nope")


# p on both sides of 1/2 (HELL water-fills below it, is SRPT at and above it)
COMPETITOR_PS = (0.05, 0.3, 0.5, 0.7, 0.99)


@pytest.mark.parametrize("p", COMPETITOR_PS)
def test_hell_matches_jax(p):
    xs = np.stack([_sizes(s) for s in range(3)])
    got = tp.hell(torch.tensor(xs), p, 64.0).numpy()
    for row, x in zip(got, xs, strict=True):
        want = np.asarray(jp.hell(jnp.asarray(x), p, 64.0))
        np.testing.assert_allclose(row, want, rtol=RTOL, atol=0)
    # A per-row tensor p takes each row's own branch.
    p_col = torch.tensor([[0.3], [0.5], [0.7]], dtype=torch.float64)
    rows = tp.hell(torch.tensor(xs), p_col).numpy()
    for row, x, pv in zip(rows, xs, (0.3, 0.5, 0.7), strict=True):
        np.testing.assert_allclose(row, np.asarray(jp.hell(jnp.asarray(x), pv, 64.0)),
                                   rtol=RTOL, atol=0)


@pytest.mark.parametrize("p", COMPETITOR_PS)
def test_knee_matches_jax_under_and_oversubscribed(p):
    """Small alphas oversubscribe (the largest knees are cut), large ones
    undersubscribe (a proportional split); a [C, 1] alpha column is one
    alpha a row, the Fig-4 grid in one call."""
    x = _sizes(2)
    alphas = np.logspace(-6, 2, 9)
    n = 64.0
    got = tp.knee(torch.tensor(x).expand(len(alphas), -1), p, n,
                  torch.tensor(alphas)[:, None]).numpy()
    regimes = set()
    for row, a in zip(got, alphas, strict=True):
        want = np.asarray(jp.knee(jnp.asarray(x), p, n, a))
        np.testing.assert_allclose(row, want, rtol=RTOL, atol=0)
        kn = np.where(x > 0, (p * np.where(x > 0, x, 0) / a) ** (1 / (1 + p)), 0)
        regimes.add(bool(kn.sum() <= n))
    assert regimes == {True, False}


@pytest.mark.parametrize("p", COMPETITOR_PS)
def test_waterfill_and_weighted_hesrpt_match_jax(p):
    xs = np.stack([_sizes(s) for s in range(3)])
    w = np.random.default_rng(1).uniform(0.5, 2.0, xs.shape)
    got_wf = tp.waterfill(torch.tensor(xs), p, 64.0, torch.tensor(w)).numpy()
    got_wh = tp.weighted_hesrpt(torch.tensor(xs), p, torch.tensor(w)).numpy()
    for i, x in enumerate(xs):
        want_wf = np.asarray(jp.waterfill(jnp.asarray(x), p, 64.0, jnp.asarray(w[i])))
        np.testing.assert_allclose(got_wf[i], want_wf, rtol=RTOL, atol=0)
        want_wh = np.asarray(jp.weighted_hesrpt(jnp.asarray(x), p, jnp.asarray(w[i])))
        np.testing.assert_allclose(got_wh[i], want_wh, rtol=RTOL, atol=0)
    # Uniform weights are heSRPT; no active job gives no shares.
    uni = tp.weighted_hesrpt(torch.tensor(xs), p, torch.ones_like(torch.tensor(xs)))
    np.testing.assert_allclose(uni.numpy(), tp.hesrpt(torch.tensor(xs), p).numpy(), rtol=1e-12)
    none = torch.zeros(2, 5, dtype=torch.float64)
    assert not tp.waterfill(none, p, 64.0).any() and not tp.hell(none, p).any()


def _knee_tapes():
    import jax

    from repro.core.scenarios import make_scenario

    scns = [make_scenario("poisson")(jax.random.PRNGKey(s), 24, 4.0) for s in range(3)]
    x = np.stack([np.asarray(c.x0) for c in scns])
    x[:, :4] = x[:, 4:8]  # exact ties, which the masked median and KNEE's sort meet
    return x, np.stack([np.asarray(c.arrival_times) for c in scns])


@pytest.mark.parametrize("n_chips", [None, 16])
@pytest.mark.parametrize("p", (0.3, 0.5, 0.9))
def test_knee_rule_matches_jax(n_chips, p):
    """engine.knee_rule (alpha refit from the active set's median at every
    event), continuous and whole chips: the allocation on sizes with zeros
    and ties, and a whole online run, recorded event by event."""
    import jax

    from repro.core import engine as je
    from repro_torch.core import engine as te

    x = np.stack([_sizes(s, m=25) for s in range(3)])
    rule_t = te.knee_rule(16.0, n_chips=n_chips)
    rule_j = je.knee_rule(16.0, n_chips=n_chips, dtype=jnp.float64)
    alloc_t, rate_t = rule_t.allocate((), torch.tensor(x), p)
    for i, row in enumerate(x):
        alloc_j, rate_j = rule_j.allocate((), jnp.asarray(row), p)
        np.testing.assert_allclose(alloc_t[i].numpy(), np.asarray(alloc_j), rtol=RTOL, atol=0)
        np.testing.assert_allclose(rate_t[i].numpy(), np.asarray(rate_j), rtol=RTOL, atol=0)
    xt, at = _knee_tapes()
    got = te.run(torch.tensor(xt), torch.tensor(at), p, rule_t, record=True)

    def one(xv, av):
        res = je.run(xv, av, p, rule_j, record=True)
        return res.completion_times, res.trace.alloc

    want_t, want_a = jax.jit(jax.vmap(one))(jnp.asarray(xt), jnp.asarray(at))
    np.testing.assert_allclose(got.completion_times.numpy(), np.asarray(want_t),
                               rtol=RTOL, atol=0)
    if n_chips is None:
        np.testing.assert_allclose(got.trace.alloc.numpy(), np.asarray(want_a),
                                   rtol=RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got.trace.alloc.numpy(), np.asarray(want_a))


@pytest.mark.parametrize("p", PS)
def test_analysis_matches_jax(p):
    from repro.core import analysis as ja
    from repro_torch.core import analysis as tan

    x = np.stack([_sizes(s) for s in range(3)])
    theta = np.stack([np.asarray(jp.hesrpt(jnp.asarray(row), p)) for row in x])
    want = np.asarray([ja.system_efficiency(jnp.asarray(t), p) for t in theta])
    got = tan.system_efficiency(torch.tensor(theta), p).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert tan.seed_axis_stats(x) == ja.seed_axis_stats(x)
