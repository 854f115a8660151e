"""The fused allocate and the quantizer of repro_torch against the JAX
package and the NumPy oracle.

- ``engine.quantize_allocation`` and ``kernels.alloc.hesrpt_alloc_fused_ref``
  against ``repro.core.engine.quantize_allocation_jax`` and
  ``repro.kernels.alloc.hesrpt_alloc_fused`` (``impl="ref"`` and the Pallas
  kernel in ``impl="interpret"``): chips equal, theta to ``RTOL = 1e-12``
  (XLA-CPU's and torch's ``pow`` differ in the last ulps).
- Chips against the NumPy oracle ``repro.sched.quantize.quantize_allocation``.
- The three reference behaviours ROADMAP.md's Queue C records, as named cases.
- Inside the port: the fused plain version equals the unfused pipeline bit
  for bit.  The CUDA kernel against its plain version is
  ``tests/test_torch_kernels_cuda.py`` (on a card only).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as je  # noqa: E402
from repro.core import policies as jp  # noqa: E402
from repro.kernels import alloc as ja  # noqa: E402
from repro.sched.quantize import quantize_allocation as np_quantize  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import policies as tp  # noqa: E402
from repro_torch.kernels import alloc as ta  # noqa: E402

RTOL = 1e-12
# (M, n_chips, min_chips): plenty of chips, tight, floored (trims), and two
# oversubscribed pools (more active jobs than n_chips // min_chips).
COMBOS = ((6, 16, 1), (12, 64, 1), (16, 32, 3), (16, 8, 1), (9, 8, 2), (300, 256, 1))
INTERPRET_COMBOS = COMBOS[:2] + COMBOS[3:4]  # each interpret compile is slow
# Past 1024 jobs a cell, where the CUDA kernel holds 8 and 16 jobs a thread
# (up to MAX_JOBS = 4096): the plain version, which the kernel equals bit
# for bit on the card, against the TPU kernel's plain version and its
# Pallas kernel.
LARGE_COMBOS = ((1500, 256, 1), (4096, 256, 2))
LARGE_INTERPRET_COMBOS = ((1500, 64, 1),)
PS = (0.2, 0.5, 0.8)


def _sizes(rng, m, zero_frac=0.3):
    x = rng.pareto(1.5, m) + 0.01
    x[rng.random(m) < zero_frac] = 0.0
    k = m // 4
    x[:k] = x[k : 2 * k]  # exact ties
    return x


@functools.lru_cache(maxsize=None)
def _jax_quantize(n_chips, min_chips):
    fn = functools.partial(je.quantize_allocation_jax, n_chips=n_chips, min_chips=min_chips)
    return jax.jit(fn)


@pytest.mark.parametrize("combo", COMBOS)
def test_quantize_allocation_matches_jax_and_oracle(combo):
    m, n_chips, min_chips = combo
    rng = np.random.default_rng(m * 1000 + n_chips)
    for trial in range(6):
        x = _sizes(rng, m)
        theta = np.asarray(jp.hesrpt(jnp.asarray(x), PS[trial % 3]))
        if trial % 2:  # a share vector that is not rank-monotone
            theta = np.where(x > 0, rng.random(m), 0.0)
            theta /= max(theta.sum(), 1e-300)
        want_j = np.asarray(_jax_quantize(n_chips, min_chips)(jnp.asarray(theta)))
        want_np = np_quantize(theta, n_chips, min_chips=min_chips)
        got = te.quantize_allocation(torch.tensor(theta), n_chips, min_chips=min_chips).numpy()
        np.testing.assert_array_equal(got, want_j, err_msg=f"{combo} {trial}")
        np.testing.assert_array_equal(got, want_np, err_msg=f"{combo} {trial}")


@pytest.mark.parametrize("impl, combos, trials", [
    pytest.param("ref", COMBOS, 4, id="ref"),
    pytest.param("interpret", INTERPRET_COMBOS, 4, id="interpret"),
    pytest.param("ref", LARGE_COMBOS, 2, id="ref-large"),  # each trial's p compiles anew
    pytest.param("interpret", LARGE_INTERPRET_COMBOS, 2, id="interpret-large"),
])
def test_fused_ref_matches_jax_fused(impl, combos, trials):
    rng = np.random.default_rng(11)
    for m, n_chips, min_chips in combos:
        for trial in range(trials):
            x = _sizes(rng, m)
            p = PS[trial % 3]
            theta_j, chips_j = ja.hesrpt_alloc_fused(
                jnp.asarray(x), p, n_chips, min_chips=min_chips, impl=impl
            )
            theta_t, chips_t = ta.hesrpt_alloc_fused_ref(
                torch.tensor(x), p, n_chips, min_chips=min_chips
            )
            msg = f"{impl} m={m} chips={n_chips}/{min_chips} trial={trial}"
            np.testing.assert_allclose(theta_t.numpy(), np.asarray(theta_j), rtol=RTOL, err_msg=msg)
            np.testing.assert_array_equal(chips_t.numpy(), np.asarray(chips_j), err_msg=msg)


@pytest.mark.parametrize("combo", COMBOS)
def test_fused_ref_equals_unfused_pipeline_exactly(combo):
    """Inside the port: theta bit-for-bit hesrpt, chips exactly the unfused
    quantizer, for a [cells, M] batch and for each row alone."""
    m, n_chips, min_chips = combo
    rng = np.random.default_rng(5 + m)
    x = torch.tensor(np.stack([_sizes(rng, m) for _ in range(6)]))
    for p in PS:
        theta, chips = ta.hesrpt_alloc_fused(x, p, n_chips, min_chips=min_chips)
        assert torch.equal(theta, tp.hesrpt(x, p))
        unfused = te.quantize_allocation(tp.hesrpt(x, p), n_chips, min_chips=min_chips)
        assert torch.equal(chips, unfused)
        for row, c_row in zip(x, chips, strict=True):
            _, c1 = ta.hesrpt_alloc_fused_ref(row, p, n_chips, min_chips=min_chips)
            assert torch.equal(c1, c_row)


def test_theta_fused_on_cpu_is_the_policy():
    x = torch.tensor(_sizes(np.random.default_rng(2), 20))
    before = ta.LAUNCHES
    assert torch.equal(ta.hesrpt_theta_fused(x, 0.5), tp.hesrpt(x, 0.5))
    _, chips = ta.hesrpt_alloc_fused(x, 0.5, 0)
    assert torch.all(chips == 0)
    assert ta.LAUNCHES == before  # the CPU path launches nothing


def test_zero_and_degenerate_inputs():
    theta, chips = ta.hesrpt_alloc_fused(torch.zeros(8, dtype=torch.float64), 0.5, 16)
    assert torch.all(theta == 0) and torch.all(chips == 0)
    empty = te.quantize_allocation(torch.zeros((3, 0), dtype=torch.float64), 16)
    assert empty.shape == (3, 0)


@pytest.mark.parametrize("m", [1, 5, 32, 33, 257, 1000, 1025, 2048, 4096])
def test_pairwise_sum_is_the_fixed_tree(m):
    v = torch.tensor(np.random.default_rng(m).random((2, m)))
    P = ta.pad_len(m)
    assert P >= max(m, 32) and P & (P - 1) == 0
    ref = []
    for row in v.tolist():
        level = row + [0.0] * (P - m)
        while len(level) > 1:
            level = [level[2 * i] + level[2 * i + 1] for i in range(len(level) // 2)]
        ref.append(level)
    assert ta.pairwise_sum(v).tolist() == ref


# ------------------------------------------------ Queue C inputs, by name
def test_queue_c_subnormal_share_follows_numpy_oracle():
    """theta = [0 x 13, 1.0, 1.11253693e-308], n_chips = 2.  The JAX
    quantizer drops the subnormal job ([..., 2, 0]: XLA-CPU flushes the
    denormal, so it is not ``> 0``); torch on the CPU and f64 on the card
    keep it, so the port is held to the NumPy oracle ([..., 1, 1])."""
    theta = np.array([0.0] * 13 + [1.0, 1.11253693e-308])
    want = np_quantize(theta, 2)
    assert want[-2:].tolist() == [1, 1]
    got = te.quantize_allocation(torch.tensor(theta), 2).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.asarray(_jax_quantize(2, 1)(jnp.asarray(theta)))[-2:].tolist() == [2, 0]


def test_queue_c_leftover_chip_to_a_job_at_the_floor():
    """The oracle gives a leftover chip to a job at the min-chips floor
    (raw 0.994 -> 2 chips); the port copies it."""
    theta = np.array([0, 0, 0.04142012, 0.9112426, 0.04733728, 0])
    want = [0, 0, 2, 21, 1, 0]
    assert np_quantize(theta, 24).tolist() == want
    assert te.quantize_allocation(torch.tensor(theta), 24).tolist() == want
    assert np.asarray(_jax_quantize(24, 1)(jnp.asarray(theta))).tolist() == want


def test_queue_c_tied_sizes_unequal_shares():
    """x = [1, 1]: ties break by index, theta [0.25, 0.75], in the policy,
    the fused plain version and the JAX reference alike."""
    x = torch.tensor([1.0, 1.0])
    theta, chips = ta.hesrpt_alloc_fused_ref(x, 0.5, 4)
    assert theta.tolist() == [0.25, 0.75]
    assert chips.tolist() == [1, 3]
    theta_j, chips_j = ja.hesrpt_alloc_fused(jnp.asarray([1.0, 1.0]), 0.5, 4, impl="ref")
    assert np.asarray(theta_j).tolist() == [0.25, 0.75]
    assert np.asarray(chips_j).tolist() == [1, 3]


# Exponents c = 1/(1-p) of every bracket_pow mode: 1, 2, 3 by products, and
# device pow (c = 5 and 1/0.7).
MIXED_P = (0.0, 0.5, 2.0 / 3.0, 0.8, 0.3, 0.5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("combo", COMBOS)
def test_fused_ref_per_row_p_equals_scalar_p_calls(combo, dtype):
    """A [C, 1] (or [C]) p mixing every mode equals, row by row, the call
    with that row's scalar p, bit for bit (theta bitwise, chips equal);
    hesrpt and hesrpt_theta_fused take the same p."""
    m, n_chips, min_chips = combo
    rng = np.random.default_rng(11 + m)
    x = torch.tensor(np.stack([_sizes(rng, m) for _ in MIXED_P]), dtype=dtype)
    p_col = torch.tensor(MIXED_P, dtype=torch.float64)[:, None]
    theta, chips = ta.hesrpt_alloc_fused_ref(x, p_col, n_chips, min_chips=min_chips)
    theta_1d, chips_1d = ta.hesrpt_alloc_fused(x, p_col[:, 0], n_chips, min_chips=min_chips)
    assert torch.equal(theta, theta_1d) and torch.equal(chips, chips_1d)
    assert torch.equal(theta, tp.hesrpt(x, p_col))
    assert torch.equal(theta, ta.hesrpt_theta_fused(x, p_col[:, 0]))
    assert theta.dtype == dtype
    for r, p in enumerate(MIXED_P):
        theta_r, chips_r = ta.hesrpt_alloc_fused_ref(x, p, n_chips, min_chips=min_chips)
        assert torch.equal(theta[r], theta_r[r]), p
        assert torch.equal(chips[r], chips_r[r]), p


def test_bracket_pow_tensor_modes():
    """Per element: c = 1 passes b through, 2 and 3 multiply, the rest call
    pow; the mode is read from the float64 c before the cast to b's type."""
    b = torch.tensor([[0.3, 0.7, 1.0]] * 5, dtype=torch.float64)
    c = torch.tensor([1.0, 2.0, 3.0, 5.0, 1.0 / 0.7], dtype=torch.float64)[:, None]
    got = tp.bracket_pow(b, c)
    assert torch.equal(got[0], b[0])
    assert torch.equal(got[1], b[1] * b[1])
    assert torch.equal(got[2], b[2] * b[2] * b[2])
    for r in (3, 4):
        assert torch.equal(got[r], tp.bracket_pow(b, float(c[r]))[r])
        np.testing.assert_allclose(got[r].numpy(), b[r].numpy() ** float(c[r]), rtol=1e-15)
    # float32 b: the exponent is cast, the modes are not.
    b32 = b.to(torch.float32)
    got32 = tp.bracket_pow(b32, c)
    assert got32.dtype == torch.float32
    assert torch.equal(got32[1], b32[1] * b32[1])
    # A c just off 2 in float64 that rounds to 2.0 in float32 still takes pow.
    near = torch.tensor([[2.0 + 1e-12]], dtype=torch.float64)
    assert torch.equal(tp.bracket_pow(b32[:1], near), b32[:1].pow(near.to(torch.float32)))


def test_alloc_rejects_a_bad_p_shape():
    x = torch.tensor(np.stack([_sizes(np.random.default_rng(3), 8)] * 3))
    with pytest.raises(ValueError, match="cells"):
        ta.exponent_rows(torch.full((2, 1), 0.5, dtype=torch.float64), 3, x.device)
    with pytest.raises(ValueError, match="cells"):
        ta.exponent_rows(torch.full((3, 2), 0.5, dtype=torch.float64), 3, x.device)
    c = ta.exponent_rows(torch.tensor([0.5, 0.0, 0.8]), 3, x.device)
    assert c.dtype == torch.float64 and c.tolist() == [2.0, 1.0, 1.0 / (1.0 - 0.800000011920929)]
