"""The port's SSD against the JAX package, on the CPU.

The port's recurrence ``kernels.ref.ssd`` and its chunked dual form
``kernels.chunked.ssd`` (the CUDA kernel's plain version, which
``kernels.ops.ssd`` takes for a CPU tensor) are held against JAX's
``ref.ssd``, ``chunked.ssd`` and the TPU kernel ``ssd_scan`` run in
interpret mode, over the cases of ``tests/test_kernels.py`` (ragged, a chunk
longer than the sequence) at its tolerances: y float32 2e-5, bfloat16 5e-2
(the sides round the float32 result at different places), the final state
1e-3.  Inputs come from a numpy seed.  Also: an initial state, and a
prefill's final state continuing the recurrence step by step (decode).

The CUDA kernel itself runs only on a card: ``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import chunked as jchunked  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan  # noqa: E402
from repro_torch.kernels import chunked, ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
CASES = [  # b, s, h, p, n, block: those of tests/test_kernels.py
    (1, 128, 2, 32, 16, 64),
    (2, 200, 3, 32, 16, 64),  # ragged
    (1, 64, 1, 64, 128, 32),
    (2, 96, 4, 16, 8, 128),  # block > seq
]


def _inputs(b, s, h, p, n, dtype, seed=42):
    """numpy arrays, and the same as jax and torch inputs: x, b, c (and dt)
    in ``dtype``, a and d in float32, as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    arrs = [
        rng.standard_normal((b, s, h, p)),
        rng.uniform(0.01, 0.2, (b, s, h)),
        -rng.uniform(0.5, 2.0, (h,)),
        rng.standard_normal((b, s, n)),
        rng.standard_normal((b, s, n)),
        rng.standard_normal((h,)),
    ]
    arrs = [a.astype(np.float32) for a in arrs]
    dts = (dtype, dtype, "float32", dtype, dtype, "float32")
    jax_in = [jnp.asarray(a, dt) for a, dt in zip(arrs, dts)]
    torch_in = [torch.from_numpy(a).to(getattr(torch, dt)) for a, dt in zip(arrs, dts)]
    return jax_in, torch_in


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,blk", CASES)
def test_ssd_matches_jax_ref_chunked_and_kernel(dtype, b, s, h, p, n, blk):
    jin, tin = _inputs(b, s, h, p, n, dtype)
    want = [
        jref.ssd(*jin, return_state=True),
        jchunked.ssd(*jin, block=blk, return_state=True),
        jax_ssd_scan(*jin, block_q=blk, interpret=True, return_state=True),
    ]
    got = [ref.ssd(*tin, return_state=True), chunked.ssd(*tin, block=blk, return_state=True),
           ops.ssd(*tin, return_state=True)]
    for y, st in got:
        assert y.dtype == tin[0].dtype and y.shape == tin[0].shape
        assert st.dtype == torch.float32 and st.shape == (b, h, p, n)
        for y0, st0 in want:
            _close(y, y0, TOL[dtype])
            _close(st, st0, STATE_TOL)


@pytest.mark.parametrize("blk", [16, 64, 128])
def test_ssd_with_an_initial_state_matches_jax(blk):
    b, s, h, p, n = 2, 70, 3, 16, 8
    jin, tin = _inputs(b, s, h, p, n, "float32", seed=3)
    h0 = np.random.default_rng(4).standard_normal((b, h, p, n)).astype(np.float32)
    yj, stj = jref.ssd(*jin, h0=jnp.asarray(h0), return_state=True)
    yc, stc = jchunked.ssd(*jin, h0=jnp.asarray(h0), block=blk, return_state=True)
    for y, st in (ref.ssd(*tin, h0=torch.from_numpy(h0), return_state=True),
                  chunked.ssd(*tin, h0=torch.from_numpy(h0), block=blk, return_state=True),
                  ops.ssd(*tin, h0=torch.from_numpy(h0), impl="cuda", return_state=True)):
        for y0, st0 in ((yj, stj), (yc, stc)):
            _close(y, y0, TOL["float32"])
            _close(st, st0, STATE_TOL)


def test_prefill_state_continues_as_decode():
    """The chunked prefill's final state, fed step by step to the
    recurrence (the decode path: ``ops.ssd`` with ``h0``), gives the full
    sequence's outputs past the prompt, in both packages."""
    b, s, h, p, n, extra = 1, 96, 2, 16, 8, 5
    jin, tin = _inputs(b, s + extra, h, p, n, "float32", seed=5)
    y_full_j = jref.ssd(*jin)
    x, dt, a, bm, cm, d = tin
    _, st = ops.ssd(x[:, :s], dt[:, :s], a, bm[:, :s], cm[:, :s], d, return_state=True)
    _, stj = jax_ssd_scan(jin[0][:, :s], jin[1][:, :s], jin[2], jin[3][:, :s], jin[4][:, :s],
                          jin[5], block_q=32, interpret=True, return_state=True)
    _close(st, stj, STATE_TOL)
    for t in range(s, s + extra):
        sl = slice(t, t + 1)
        y, st = ops.ssd(x[:, sl], dt[:, sl], a, bm[:, sl], cm[:, sl], d, h0=st,
                        return_state=True)
        np.testing.assert_allclose(y[:, 0].numpy(), np.asarray(y_full_j[:, t]), rtol=1e-4,
                                   atol=1e-4)


def test_chunked_lower_triangle_only():
    """Steep decay makes exp(s_t - s_u) overflow above the diagonal; the
    chunked form exponentiates only inside the lower triangle, so y stays
    finite and equal to the recurrence."""
    _, (x, dt, a, bm, cm, d) = _inputs(1, 64, 2, 16, 8, "float32", seed=6)
    dt = dt * 10.0  # a * dt down to -4 per step
    s = torch.cumsum(a * dt, dim=1)
    assert (s[:, 0] - s[:, -1]).max() > 89.0  # exp(89) overflows float32
    y, st = chunked.ssd(x, dt, a, bm, cm, d, block=64, return_state=True)
    y0, st0 = ref.ssd(x, dt, a, bm, cm, d, return_state=True)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    torch.testing.assert_close(y, y0, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(st, st0, **STATE_TOL)


def test_ssd_dispatch_on_a_cpu_tensor():
    """``auto`` takes the chunked form on the CPU, ``ref`` the recurrence;
    an initial state (the decode step) takes the recurrence under every
    impl; a single step without one does not; the kernel refuses a CPU
    tensor (no fallback)."""
    _, tin = _inputs(1, 40, 2, 16, 8, "float32", seed=7)
    want_chunked = chunked.ssd(*tin)
    torch.testing.assert_close(ops.ssd(*tin), want_chunked, rtol=0, atol=0)
    torch.testing.assert_close(ops.ssd(*tin, impl="chunked"), want_chunked, rtol=0, atol=0)
    torch.testing.assert_close(ops.ssd(*tin, impl="ref"), ref.ssd(*tin), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ssd(*tin, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tssd.ssd_scan(*tin)
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.ssd(*tin, impl="pallas")
    one = [t[:, :1] if t.dim() > 1 else t for t in tin]
    torch.testing.assert_close(ops.ssd(*one), chunked.ssd(*one), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ssd(*one, impl="cuda")
    h0 = torch.randn(1, 2, 16, 8, generator=torch.Generator().manual_seed(8))
    torch.testing.assert_close(ops.ssd(*one, h0=h0, impl="cuda"), ref.ssd(*one, h0=h0),
                               rtol=0, atol=0)
    assert tssd.LAUNCHES == 0


def _four_step_ssd(x, dt, a, b, c, d, q=64):
    """The card kernel's algorithm (``csrc/ssd_scan.cu``), step by step in
    plain torch: (1) each chunk's own state, (2) the state pass over the
    chunks, (3) each chunk's outputs from C B^T and the state entering it.
    Steps past S are zero (dt = 0).  Returns y (with the skip) and the final
    state, float32."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    nc = -(-S // q)
    pad = nc * q - S
    xf, dtf, bf, cf = (torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (x, dt, b, c))
    xq = xf.reshape(B, nc, q, H, P)
    dtq = dtf.reshape(B, nc, q, H)
    bq, cq = bf.reshape(B, nc, q, N), cf.reshape(B, nc, q, N)
    s = torch.cumsum(a * dtq, dim=2)  # [B, nc, Q, H], inclusive, per chunk
    total = s[:, :, -1]  # [B, nc, H]
    # (1) local_k = sum_u exp(s_Q - s_u) dt_u x_u b_u^T, every chunk at once
    w = torch.exp(total[:, :, None] - s) * dtq
    local = torch.einsum("bkuhp,bkun->bkhpn", xq * w[..., None], bq)
    # (2) h_k = exp(s_Q,k) h_{k-1} + local_k; keep the state entering each chunk
    h = torch.zeros((B, H, P, N))
    entering = []
    for k in range(nc):
        entering.append(h)
        h = torch.exp(total[:, k])[..., None, None] * h + local[:, k]
    h_prev = torch.stack(entering, dim=1)  # [B, nc, H, P, N]
    # (3) y_t = sum_{u<=t} (C B^T)_tu exp(s_t - s_u) dt_u x_u + exp(s_t) C_t h_{k-1}
    cb = torch.einsum("bktn,bkun->bktu", cq, bq)  # once per chunk, all heads
    lower = torch.ones(q, q, dtype=torch.bool).tril()[None, None, :, :, None]
    expo = torch.where(lower, s[:, :, :, None] - s[:, :, None, :], float("-inf"))
    scores = cb[..., None] * torch.exp(expo) * dtq[:, :, None, :, :]  # [B, nc, Q, Q, H]
    y = torch.einsum("bktuh,bkuhp->bkthp", scores, xq)
    y = y + torch.exp(s)[..., None] * torch.einsum("bktn,bkhpn->bkthp", cq, h_prev)
    y = y.reshape(B, nc * q, H, P)[:, :S] + d[None, None, :, None] * x.float()
    return y, h


@pytest.mark.parametrize("s", [1, 63, 64, 65, 200])
def test_four_step_chunk_parallel_ssd_matches_chunked_and_jax(s):
    """The chunk-parallel decomposition the card kernel implements against
    the port's chunked form at its chunk length and JAX's recurrence, on
    ragged lengths, several heads and a state narrower than 16."""
    b, h, p, n = 2, 3, 16, 8
    jin, tin = _inputs(b, s, h, p, n, "float32", seed=11)
    y, st = _four_step_ssd(*tin)
    y_c, st_c = chunked.ssd(*tin, block=tssd.CHUNK, return_state=True)
    y_j, st_j = jref.ssd(*jin, return_state=True)
    torch.testing.assert_close(y, y_c, **TOL["float32"])
    torch.testing.assert_close(st, st_c, **STATE_TOL)
    _close(y, y_j, TOL["float32"])
    _close(st, st_j, STATE_TOL)
