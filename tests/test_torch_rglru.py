"""The port's RG-LRU against the JAX package, on the CPU.

The port's oracle ``kernels.ref.rglru`` (gates, then the recurrence
``kernels.ref.linear_recurrence``, which is the CUDA kernel's plain
version), its log-depth scan ``kernels.chunked.rglru`` and ``ops.rglru``
(which takes the log-depth scan for a CPU tensor) are held against JAX's
``ref.rglru``, ``chunked.rglru`` and the TPU kernel ``rglru_scan`` run in
interpret mode on the same a and g, over the cases of
``tests/test_kernels.py`` plus one step and a ragged S and W, at its
tolerances: y float32 2e-5, bfloat16 5e-2; the final state within 1e-3.
The TPU kernel's state is ``y[:, -1]`` in float32, a bf16 value when y is
bf16, so in bf16 every state is held at bf16's 5e-2.  Inputs come from a
numpy seed.  Also: an initial state, the recurrence against the log-depth
scan, and the dispatch.

The CUDA kernel itself runs only on a card: ``tests/test_torch_kernels_cuda.py``.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import chunked as jchunked  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan  # noqa: E402
from repro_torch.kernels import chunked, ops, ref  # noqa: E402
from repro_torch.kernels import rglru_scan as trglru  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
STATE_TOL = {"float32": dict(rtol=1e-3, atol=1e-3), "bfloat16": TOL["bfloat16"]}
CASES = [  # b, s, w, block_t, block_w: those of tests/test_kernels.py, then more
    (2, 100, 48, 256, 512),
    (1, 256, 64, 64, 32),
    (2, 64, 128, 17, 40),
    (3, 1, 40, 256, 512),  # one step
    (2, 77, 200, 32, 128),  # ragged S and W: the kernel pads both
]


def _inputs(b, s, w, dtype, seed=42):
    """x, gate_x, gate_a in ``dtype`` and a_param float32, all standard
    normal, as numpy arrays and as jax and torch inputs."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, w), (b, s, w), (b, s, w), (w,))]
    dts = (dtype, dtype, dtype, "float32")
    jax_in = [jnp.asarray(a, dt) for a, dt in zip(arrs, dts)]
    torch_in = [torch.from_numpy(a).to(getattr(torch, dt)) for a, dt in zip(arrs, dts)]
    return jax_in, torch_in


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _jax_kernel(x, gx, ga, ap, dtype, **kw):
    """The TPU kernel in interpret mode on the gates computed as
    ``tests/test_kernels.py`` computes them, cast to x's dtype."""
    rf = jax.nn.sigmoid(ga.astype(jnp.float32))
    log_a = -8.0 * jax.nn.softplus(ap)[None, None, :] * rf
    a_t = jnp.exp(log_a).astype(dtype)
    g = (jax.nn.sigmoid(gx.astype(jnp.float32)) * x.astype(jnp.float32)
         * jnp.sqrt(-jnp.expm1(2 * log_a))).astype(dtype)
    return jax_rglru_scan(a_t, g, interpret=True, return_state=True, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,w,bt,bw", CASES)
def test_rglru_matches_jax_ref_chunked_and_kernel(dtype, b, s, w, bt, bw):
    jin, tin = _inputs(b, s, w, dtype)
    want = [
        jref.rglru(*jin, return_state=True),
        jchunked.rglru(*jin, return_state=True),
        _jax_kernel(*jin, jnp.dtype(dtype), block_t=bt, block_w=bw),
    ]
    got = [ref.rglru(*tin, return_state=True), chunked.rglru(*tin, return_state=True),
           ops.rglru(*tin, return_state=True)]
    for y, st in got:
        assert y.dtype == tin[0].dtype and y.shape == (b, s, w)
        assert st.dtype == torch.float32 and st.shape == (b, w)
        for y0, st0 in want:
            _close(y, y0, TOL[dtype])
            _close(st, st0, STATE_TOL[dtype])


def test_rglru_with_an_initial_state_matches_jax():
    """``h0`` through the recurrence (ref) and folded into step 0 (the
    log-depth scan), in both packages: the shape of
    ``tests/test_kernels.py::test_chunked_rglru_matches_ref``."""
    b, s, w = 2, 150, 48
    jin, tin = _inputs(b, s, w, "float32", seed=3)
    h0 = (np.random.default_rng(4).standard_normal((b, w)) * 0.3).astype(np.float32)
    want = [jref.rglru(*jin, h0=jnp.asarray(h0), return_state=True),
            jchunked.rglru(*jin, h0=jnp.asarray(h0), return_state=True)]
    for y, st in (ref.rglru(*tin, h0=torch.from_numpy(h0), return_state=True),
                  chunked.rglru(*tin, h0=torch.from_numpy(h0), return_state=True)):
        for y0, st0 in want:
            _close(y, y0, TOL["float32"])
            _close(st, st0, STATE_TOL["float32"])


def test_prefill_state_continues_as_decode():
    """The log-depth prefill's final state, fed step by step to the oracle
    with ``h0`` (the decode path), gives the full sequence's outputs past
    the prompt."""
    b, s, w, extra = 2, 40, 24, 6
    jin, tin = _inputs(b, s + extra, w, "float32", seed=5)
    y_full = jref.rglru(*jin)
    x, gx, ga, ap = tin
    _, st = ops.rglru(x[:, :s], gx[:, :s], ga[:, :s], ap, return_state=True)
    for t in range(s, s + extra):
        sl = slice(t, t + 1)
        y, st = ref.rglru(x[:, sl], gx[:, sl], ga[:, sl], ap, h0=st, return_state=True)
        np.testing.assert_allclose(y[:, 0].numpy(), np.asarray(y_full[:, t]), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("s,shift", [(1, 0.0), (2, 0.0), (37, 0.0), (256, 0.0), (2048, -9.0)])
def test_recurrence_matches_the_log_depth_scan(s, shift):
    """The kernel's plain version (one rounded product and sum a step)
    against the Hillis-Steele scan, S not a power of two included, and decay
    mostly within 1e-3 of 1 over 2048 steps (``shift`` moves a_param
    down)."""
    _, (x, gx, ga, ap) = _inputs(2, s, 32, "float32", seed=6)
    a, g = ref.rglru_gates(x, gx, ga, ap + shift)
    if shift:
        assert a.median().item() > 0.999
    y, h = ref.linear_recurrence(a, g, return_state=True)
    yc = chunked.linear_scan(a, g)
    torch.testing.assert_close(yc, y, **TOL["float32"])
    torch.testing.assert_close(yc[:, -1], h, **STATE_TOL["float32"])
    h0 = torch.from_numpy(np.random.default_rng(7).standard_normal((2, 32)).astype(np.float32))
    y0, h1 = ref.linear_recurrence(a, g, h0=h0, return_state=True)
    yc0 = chunked.linear_scan(a, torch.cat([(g[:, 0] + a[:, 0] * h0)[:, None], g[:, 1:]], 1))
    torch.testing.assert_close(yc0, y0, **TOL["float32"])
    torch.testing.assert_close(yc0[:, -1], h1, **STATE_TOL["float32"])


def test_recurrence_keeps_its_input_dtype_and_a_float32_carry():
    _, (x, gx, ga, ap) = _inputs(1, 30, 16, "bfloat16", seed=8)
    a, g = (t.to(torch.bfloat16) for t in ref.rglru_gates(x, gx, ga, ap))
    y, h = ref.linear_recurrence(a, g, return_state=True)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y32, h32 = ref.linear_recurrence(a.float(), g.float(), return_state=True)
    torch.testing.assert_close(h, h32, rtol=0, atol=0)
    torch.testing.assert_close(y, y32.to(torch.bfloat16), rtol=0, atol=0)


def test_rglru_dispatch_on_a_cpu_tensor(monkeypatch):
    """``auto`` takes the log-depth scan on the CPU, ``ref`` the oracle; a
    single step goes the same way as any other (no route by shape); there
    is no initial-state parameter (decode calls ``ref.rglru`` itself); the
    kernel refuses a CPU tensor (no fallback)."""
    _, tin = _inputs(1, 40, 16, "float32", seed=9)
    want = chunked.rglru(*tin)
    torch.testing.assert_close(ops.rglru(*tin), want, rtol=0, atol=0)
    torch.testing.assert_close(ops.rglru(*tin, impl="chunked"), want, rtol=0, atol=0)
    torch.testing.assert_close(ops.rglru(*tin, impl="ref"), ref.rglru(*tin), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.rglru(*tin, impl="cuda")
    a, g = ref.rglru_gates(*tin)
    with pytest.raises(ValueError, match="CUDA tensors"):
        trglru.rglru_scan(a, g)
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.rglru(*tin, impl="interpret")
    assert "h0" not in inspect.signature(ops.rglru).parameters
    one = [t[:, :1] if t.dim() > 1 else t for t in tin]
    calls = []
    real = chunked.rglru
    monkeypatch.setattr(chunked, "rglru", lambda *a, **k: calls.append(1) or real(*a, **k))
    ops.rglru(*one)
    assert calls == [1]
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.rglru(*one, impl="cuda")
    assert trglru.LAUNCHES == 0
