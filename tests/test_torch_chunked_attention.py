"""The port's chunked attention and its hand-written backward against the
JAX package's ``repro.kernels.chunked.attention`` and its custom VJP, on the
CPU.

Inputs and a cotangent come from a numpy seed; the forward and
``jax.vjp`` of the JAX function are held against the port's
``torch.autograd.Function`` (forward and ``backward``), case by case: causal
and not, a window, ``q_offset``, GQA groups 1, 3 and 8, sequences that are
not multiples of the blocks and blocks small enough to make several of
them, and the reference's default blocks (512 / 1024, clamped).

Tolerances, in relative norm ``||got - want|| / ||want||`` of the output and
of each of dq, dk, dv:

- float32: ``F32_REL`` = 2e-5.  Both sides compute in float32 with the same
  blocking and differ in summation order and the ulps of ``exp``; a wrong
  mask, scale or softmax Jacobian moves them by O(1e-1).
- float64: ``F64_REL`` = 1e-12, against a float64 evaluation (autograd
  through the materialized scores in float64).  The JAX package computes
  float64 inputs in float32 (its accumulators are float32 whatever the
  input: 9.1e-8 from a float64 evaluation on these inputs), so against JAX
  float64 is held at ``F32_REL``; the port keeps float64 in float64, as its
  ``chunked.ssd`` does.

Also: autograd through the port's ``kernels.ref.attention`` (the scores
materialized) at ``F32_REL``; ``kernels.ops`` dispatch under autograd, and
``impl="cuda"`` raising on a tensor that requires grad.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import chunked as jchunked  # noqa: E402
from repro_torch.kernels import chunked, ops, ref  # noqa: E402

F32_REL = 2e-5
F64_REL = 1e-12
# b, hq, hkv, sq, sk, d, causal, window, q_offset, block_q, block_k
CASES = {
    "causal_g1_ragged": (2, 2, 2, 37, 37, 16, True, 0, 0, 16, 8),
    "causal_g3": (1, 6, 2, 64, 64, 16, True, 0, 0, 16, 16),
    "causal_g8_default_blocks": (1, 8, 1, 48, 48, 32, True, 0, 0, 512, 1024),
    "noncausal_sq_ne_sk": (2, 4, 2, 20, 45, 16, False, 0, 0, 8, 16),
    "window": (1, 4, 2, 50, 50, 16, True, 10, 0, 16, 8),
    "window_g8_ragged": (1, 8, 1, 45, 45, 8, True, 7, 0, 8, 16),
    "q_offset": (2, 6, 2, 12, 40, 16, True, 0, 28, 8, 16),
    "q_offset_window": (1, 3, 1, 20, 36, 16, True, 9, 16, 8, 8),
}

# float64 is held against JAX on these (its float32 arithmetic is the float32
# test's, case for case)
JAX_F64_CASES = ("causal_g1_ragged", "window_g8_ragged", "q_offset")


def _inputs(case, dtype, seed=0):
    b, hq, hkv, sq, sk, d = CASES[case][:6]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(dtype) for s in
            ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, hq, sq, d))]
    return arrs  # q, k, v, cotangent


def _kw(case):
    causal, window, q_offset, block_q, block_k = CASES[case][6:]
    return dict(causal=causal, window=window, q_offset=q_offset, block_q=block_q,
                block_k=block_k)


def _port(arrs, kw):
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs[:3])
    out = chunked.attention(q, k, v, **kw)
    out.backward(torch.from_numpy(arrs[3]))
    return [out.detach(), q.grad, k.grad, v.grad]


def _jax(arrs, kw):
    out, vjp = jax.vjp(lambda q, k, v: jchunked.attention(q, k, v, **kw),
                       *(jnp.asarray(a) for a in arrs[:3]))
    return [out, *vjp(jnp.asarray(arrs[3]))]


def _materialized(arrs, kw):
    """Autograd through the scores, all of them, in the inputs' dtype."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs[:3])
    g = q.shape[1] // k.shape[1]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(g, 1)) * q.shape[-1] ** -0.5
    mask = ref.attention_mask(q.shape[2], k.shape[2], causal=kw["causal"],
                              window=kw["window"], q_offset=kw["q_offset"])
    p = torch.softmax(torch.where(mask, s, ref.NEG_INF), dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.repeat_interleave(g, 1))
    out.backward(torch.from_numpy(arrs[3]))
    return [out.detach(), q.grad, k.grad, v.grad]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _assert_close(got, want, rel):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == tuple(w.shape), name
        assert _rel(g, w) <= rel, (name, _rel(g, w))


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_vjp_match_jax_in_float32(case):
    arrs = _inputs(case, np.float32)
    got = _port(arrs, _kw(case))
    assert all(t.dtype == torch.float32 for t in got)
    _assert_close(got, _jax(arrs, _kw(case)), F32_REL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_float64_matches_a_float64_evaluation_and_jax(case):
    arrs = _inputs(case, np.float64)
    got = _port(arrs, _kw(case))
    assert all(t.dtype == torch.float64 for t in got)
    _assert_close(got, _materialized(arrs, _kw(case)), F64_REL)
    if case in JAX_F64_CASES:
        # JAX's chunked attention computes in float32 whatever the input dtype.
        _assert_close(got, _jax(arrs, _kw(case)), F32_REL)


@pytest.mark.parametrize("case", ["causal_g3", "window", "q_offset", "noncausal_sq_ne_sk"])
def test_matches_autograd_through_the_ports_plain_attention(case):
    arrs = _inputs(case, np.float32)
    kw = _kw(case)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs[:3])
    want = ref.attention(q, k, v, causal=kw["causal"], window=kw["window"],
                         q_offset=kw["q_offset"])
    want.backward(torch.from_numpy(arrs[3]))
    _assert_close(_port(arrs, kw), [want.detach(), q.grad, k.grad, v.grad], F32_REL)


def test_bf16_inputs_give_bf16_gradients_near_float32():
    arrs = _inputs("causal_g3", np.float32)
    kw = _kw("causal_g3")
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in arrs[:3])
    out = chunked.attention(q, k, v, **kw)
    out.backward(torch.from_numpy(arrs[3]).to(torch.bfloat16))
    got = [out.detach(), q.grad, k.grad, v.grad]
    assert all(t.dtype == torch.bfloat16 for t in got)
    # bf16 inputs and outputs, float32 arithmetic: one bf16 rounding (2^-8) each way
    want = _port([a.astype(np.float32) for a in arrs], kw)
    for g, w in zip(got, want):
        assert _rel(g.float(), w) <= 2e-2


def test_ops_dispatch_under_autograd():
    arrs = _inputs("causal_g3", np.float32)
    q, k, v = (torch.from_numpy(a) for a in arrs[:3])
    # no grad: "auto" on a CPU tensor is the plain version; "chunked" is chunked
    torch.testing.assert_close(ops.attention(q, k, v), ref.attention(q, k, v), rtol=0, atol=0)
    torch.testing.assert_close(ops.attention(q, k, v, impl="chunked"), chunked.attention(q, k, v),
                               rtol=0, atol=0)
    qg = q.clone().requires_grad_(True)
    out = ops.attention(qg, k, v)  # autograd: "auto" takes the chunked form
    assert out.grad_fn is not None and "ChunkedAttention" in type(out.grad_fn).__name__
    with torch.no_grad():  # grad mode off: not under autograd
        torch.testing.assert_close(ops.attention(qg, k, v), ref.attention(q, k, v),
                                   rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="chunked"):
        ops.attention(qg, k, v, impl="cuda")
    # off the CPU (a meta tensor here, as a CUDA one on the card) "auto" under
    # autograd raises as "cuda" does: the kernel has no backward
    qm, km, vm = (torch.empty(t.shape, device="meta") for t in (q, k, v))
    with pytest.raises(RuntimeError, match="chunked"):
        ops.attention(qm.requires_grad_(True), km, vm)


def test_mixer_ops_refuse_the_kernel_under_autograd():
    x = torch.randn(1, 8, 2, 4, requires_grad=True)
    dt, a = torch.rand(1, 8, 2), -torch.rand(2)
    b, c, d = torch.randn(1, 8, 3), torch.randn(1, 8, 3), torch.randn(2)
    with pytest.raises(RuntimeError, match="chunked"):
        ops.ssd(x, dt, a, b, c, d, impl="cuda")
    torch.testing.assert_close(ops.ssd(x, dt, a, b, c, d), chunked.ssd(x, dt, a, b, c, d),
                               rtol=0, atol=0)
    xr = torch.randn(1, 8, 4, requires_grad=True)
    gx, ga, ap = torch.randn(1, 8, 4), torch.randn(1, 8, 4), torch.randn(4)
    with pytest.raises(RuntimeError, match="chunked"):
        ops.rglru(xr, gx, ga, ap, impl="cuda")
    torch.testing.assert_close(ops.rglru(xr, gx, ga, ap), chunked.rglru(xr, gx, ga, ap),
                               rtol=0, atol=0)
    meta = [torch.empty(t.shape, device="meta") for t in (x, dt, a, b, c, d)]
    with pytest.raises(RuntimeError, match="chunked"):
        ops.ssd(meta[0].requires_grad_(True), *meta[1:])
    meta = [torch.empty(t.shape, device="meta") for t in (xr, gx, ga, ap)]
    with pytest.raises(RuntimeError, match="chunked"):
        ops.rglru(meta[0].requires_grad_(True), *meta[1:])
