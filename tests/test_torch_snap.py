"""Slice snapping in repro_torch against the JAX package and the NumPy oracle.

- ``engine.snap_to_slices`` over a ``[C, M]`` batch equals, row by row, the
  JAX ``snap_to_slices_jax`` and the NumPy oracle
  ``repro.sched.quantize.snap_to_slices`` (hypothesis over chips, pools and
  slice sets), with the oracle's postconditions;
- ``quantized_rule(snap_slices=True)`` traces (chips at every event)
  against the JAX engine's on shared tapes, online and under drift; fused
  (the plain allocate, then the snap) equals unfused bit for bit;
- ``knee_rule(snap_slices=True)`` against JAX's.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.core import engine as je  # noqa: E402
from repro.core import policies as jp  # noqa: E402
from repro.core.scenarios import make_scenario  # noqa: E402
from repro.sched.quantize import snap_to_slices as np_snap  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import policies as tp  # noqa: E402

M = 24
P = 0.5
N_CHIPS = 64


@st.composite
def chip_batches(draw):
    """A [C, m] batch of post-quantization allocations, the pool they came
    from (``n_chips >= every row's sum``, with slack so upgrades are
    reachable) and a slice set."""
    c = draw(st.integers(1, 5))
    m = draw(st.integers(1, 16))
    chips = np.array(draw(st.lists(st.integers(0, 300), min_size=c * m, max_size=c * m)),
                     dtype=np.int64).reshape(c, m)
    slack = draw(st.integers(0, 64))
    slices = draw(st.sampled_from([te.DEFAULT_SLICES, (1, 4, 16, 64), (2, 3, 8)]))
    return chips, max(int(chips.sum(-1).max()) + slack, 1), slices


@settings(max_examples=200, deadline=None)
@given(cb=chip_batches())
def test_snap_matches_jax_and_numpy_oracle(cb):
    chips, n_chips, slices = cb
    got = te.snap_to_slices(torch.tensor(chips), n_chips, slices=slices)
    assert got.dtype == torch.int32 and got.shape == chips.shape
    # The JAX port on the first row (an eager while_loop a call is slow;
    # tests/test_quantize.py holds it to the oracle), the oracle on each.
    jx = je.snap_to_slices_jax(jnp.asarray(chips[0]), n_chips, slices=slices)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jx))
    for row, g in zip(chips, got.numpy(), strict=True):
        want = np_snap(row, n_chips, slices=slices)
        np.testing.assert_array_equal(g, want)
        assert set(np.unique(g)) <= set(slices) | {0}
        assert g.sum() <= n_chips and np.all(g[row == 0] == 0)


def test_snap_edge_cases():
    empty = te.snap_to_slices(torch.zeros((3, 0), dtype=torch.int32), 16)
    assert empty.shape == (3, 0)
    # A pool already spent: snap down only.
    over = te.snap_to_slices(torch.tensor([[7, 9, 3]]), 10)
    np.testing.assert_array_equal(over.numpy(), np_snap(np.array([7, 9, 3]), 10)[None])
    # Leading dims are kept.
    grid = torch.tensor([[[5, 3, 0], [12, 1, 2]], [[30, 1, 1], [0, 0, 9]]])
    flat = te.snap_to_slices(grid.reshape(4, 3), 40)
    assert torch.equal(te.snap_to_slices(grid, 40), flat.reshape(2, 2, 3))


@functools.lru_cache(maxsize=1)
def _tapes():
    sample = make_scenario("poisson")
    xs, arrs = [], []
    for rate in (2.0, 8.0):
        for seed in range(3):
            scn = sample(jax.random.PRNGKey(seed), M, rate)
            xs.append(np.asarray(scn.x0))
            arrs.append(np.asarray(scn.arrival_times))
    return np.stack(xs), np.stack(arrs)


def _drift_times():
    return np.sort(_tapes()[1], -1)[:, 7:8].copy()


@functools.lru_cache(maxsize=None)
def _jax_chips(rule_name, drift):
    x, a = _tapes()
    f64 = dict(dtype=jnp.float64)
    rule = {
        "quantized": lambda: je.quantized_rule(jp.hesrpt, N_CHIPS, snap_slices=True, **f64),
        "knee": lambda: je.knee_rule(N_CHIPS, n_chips=N_CHIPS, snap_slices=True, **f64),
    }[rule_name]()

    def one(xv, av, tv):
        pd = je.PDrift(tv, jnp.asarray([0.8, 0.3])) if drift else None
        res = je.run(xv, av, P, rule, record=True, p_drift=pd)
        return res.completion_times, res.trace.alloc

    out = jax.jit(jax.vmap(one))(jnp.asarray(x), jnp.asarray(a), jnp.asarray(_drift_times()))
    return tuple(np.asarray(v) for v in out)


@pytest.mark.parametrize("drift", [False, True])
def test_snapped_quantized_rule_matches_jax_fused_equals_unfused(drift):
    x, a = (torch.tensor(v) for v in _tapes())
    pd = None
    if drift:
        pd = te.PDrift(torch.tensor(_drift_times()), torch.tensor([0.8, 0.3], dtype=torch.float64))
    times_j, chips_j = _jax_chips("quantized", drift)
    rule = te.quantized_rule(tp.hesrpt, N_CHIPS, snap_slices=True)
    unfused = te.run(x, a, P, rule, record=True, p_drift=pd)
    fused = te.run(x, a, P, rule, record=True, fused=True, p_drift=pd)
    np.testing.assert_array_equal(unfused.trace.alloc.numpy(), chips_j)
    np.testing.assert_allclose(unfused.completion_times.numpy(), times_j, rtol=1e-12, atol=0)
    assert torch.equal(fused.trace.alloc, unfused.trace.alloc)
    assert torch.equal(fused.completion_times, unfused.completion_times)
    chips = unfused.trace.alloc
    assert set(torch.unique(chips).tolist()) <= set(te.DEFAULT_SLICES) | {0}
    assert int(chips.sum(-1).max()) <= N_CHIPS


def test_snapped_knee_rule_matches_jax():
    x, a = (torch.tensor(v) for v in _tapes())
    times_j, chips_j = _jax_chips("knee", False)
    res = te.run(x, a, P, te.knee_rule(N_CHIPS, n_chips=N_CHIPS, snap_slices=True), record=True)
    np.testing.assert_array_equal(res.trace.alloc.numpy(), chips_j)
    np.testing.assert_allclose(res.completion_times.numpy(), times_j, rtol=1e-12, atol=0)
