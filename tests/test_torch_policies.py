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
    attaches the fused allocate by identity); unported names say so."""
    assert tp.make_policy("heSRPT") is tp.hesrpt
    assert tp.make_policy("srpt") is tp.srpt
    for name in ("hell", "knee", "waterfill"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tp.make_policy(name)
    with pytest.raises(ValueError):
        tp.make_policy("nope")


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
