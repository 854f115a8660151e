"""The port's attention against the JAX package, on the CPU.

``repro_torch.kernels.ops.attention`` on a CPU tensor takes the plain
version (``kernels/ref.py``); it is held against both
``repro.kernels.ref.attention`` and the TPU kernel
``repro.kernels.flash_attention.flash_attention`` run in interpret mode, over
the cases of ``tests/test_kernels.py`` (MHA, GQA 2:1, MQA, ragged with a
query offset, a sequence shorter than a block; sliding windows; non-causal),
at its tolerances ``TOL``: float32 2e-5, bfloat16 5e-2 (one bf16 ulp of an
O(1) output is 2**-8 ~ 4e-3, and the two sides round the float32 result
once each).  Inputs come from a numpy seed.

The CUDA kernel itself runs only on a card: ``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro_torch.kernels import chunked  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=5e-2, atol=5e-2)}
CASES = [
    (1, 4, 4, 128, 128, 64),  # MHA, block-aligned
    (2, 4, 2, 256, 256, 64),  # GQA 2:1
    (1, 8, 1, 128, 128, 32),  # MQA
    (2, 4, 2, 130, 190, 64),  # ragged (padding paths), q_offset 60
    (1, 2, 2, 64, 64, 128),   # small seq < block
]


def _qkv(shape_q, shape_kv, dtype, seed=42):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (shape_q, shape_kv, shape_kv)]
    jax_in = [jnp.asarray(a, dtype) for a in arrs]
    torch_in = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jax_in, torch_in


def _check(got, jax_outs, dtype):
    got = got.float().numpy()
    for want in jax_outs:
        np.testing.assert_allclose(got, np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", CASES)
def test_causal_attention_matches_ref_and_flash_kernel(dtype, b, hq, hkv, sq, skv, d):
    (qj, kj, vj), (q, k, v) = _qkv((b, hq, sq, d), (b, hkv, skv, d), dtype)
    off = max(skv - sq, 0)
    got = ops.attention(q, k, v, causal=True, q_offset=off)
    assert got.dtype == q.dtype and got.shape == q.shape
    _check(got, [jref.attention(qj, kj, vj, causal=True, q_offset=off),
                 jax_flash(qj, kj, vj, causal=True, q_offset=off, interpret=True)], dtype)


@pytest.mark.parametrize("window", [16, 64, 100])
def test_sliding_window_matches_ref_and_flash_kernel(window):
    (qj, kj, vj), (q, k, v) = _qkv((1, 4, 256, 64), (1, 2, 256, 64), "float32")
    got = ops.attention(q, k, v, causal=True, window=window)
    _check(got, [jref.attention(qj, kj, vj, causal=True, window=window),
                 jax_flash(qj, kj, vj, causal=True, window=window, interpret=True)], "float32")


def test_non_causal_matches_ref_and_flash_kernel():
    (qj, kj, vj), (q, k, v) = _qkv((2, 2, 128, 64), (2, 2, 192, 64), "float32")
    got = ops.attention(q, k, v, causal=False)
    _check(got, [jref.attention(qj, kj, vj, causal=False),
                 jax_flash(qj, kj, vj, causal=False, interpret=True)], "float32")


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0), (True, 5, 3), (False, 7, 0),
                                                     (False, 0, 2)])
def test_attention_mask_matches_the_jax_package(causal, window, q_offset):
    got = ref.attention_mask(9, 12, causal=causal, window=window, q_offset=q_offset)
    want = jref.attention_mask(9, 12, causal=causal, window=window, q_offset=q_offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dispatch_on_a_cpu_tensor():
    """``auto`` and ``ref`` take the plain version; the kernel refuses a CPU
    tensor (no fallback); single-query decode takes the plain version under
    every impl, as the JAX package's ``ops.attention`` does."""
    _, (q, k, v) = _qkv((1, 4, 8, 16), (1, 2, 8, 16), "float32")
    want = ref.attention(q, k, v, causal=True)
    torch.testing.assert_close(ops.attention(q, k, v, impl="auto"), want, rtol=0, atol=0)
    torch.testing.assert_close(ops.attention(q, k, v, impl="ref"), want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tflash.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="impl must be one of"):
        ops.attention(q, k, v, impl="pallas")
    q1 = q[:, :, -1:]
    torch.testing.assert_close(ops.attention(q1, k, v, impl="cuda", q_offset=7),
                               ref.attention(q1, k, v, q_offset=7), rtol=0, atol=0)
    assert tflash.LAUNCHES == 0


@pytest.mark.parametrize("d", [160, 80, 200])
@pytest.mark.parametrize("window", [0, 48])
def test_head_dims_outside_the_power_of_two_instances_match_jax(d, window):
    """stablelm's D = 160 and the padded D's: the port's path on the CPU
    against JAX's reference and its TPU kernel, which take any D."""
    (qj, kj, vj), (q, k, v) = _qkv((1, 4, 100, d), (1, 2, 100, d), "float32")
    got = ops.attention(q, k, v, causal=True, window=window)
    _check(got, [jref.attention(qj, kj, vj, causal=True, window=window),
                 jax_flash(qj, kj, vj, causal=True, window=window, interpret=True)], "float32")


@pytest.mark.parametrize("d,want", [(1, 16), (16, 16), (17, 32), (80, 128), (128, 128),
                                    (129, 160), (160, 160), (161, 256), (200, 256),
                                    (256, 256)])
def test_padded_head_dim_picks_the_next_instance(d, want):
    assert tflash.padded_head_dim(d) == want
    assert want in tflash.HEAD_DIMS


def test_zero_padding_the_head_dim_keeps_attention_at_the_true_scale():
    """What the wrapper does for a D it has no instance for: q, k and v
    zero-padded along D, logits scaled by the true D, output sliced back,
    equals attention at the true D (checked here on the plain version, whose
    scale is the padded D's unless q is rescaled)."""
    _, (q, k, v) = _qkv((2, 4, 70, 80), (2, 2, 70, 80), "float32", seed=3)
    d, dk = 80, tflash.padded_head_dim(80)
    qp, kp, vp = (torch.nn.functional.pad(t, (0, dk - d)) for t in (q, k, v))
    got = ref.attention(qp * (dk / d) ** 0.5, kp, vp, causal=True, window=30)
    assert torch.equal(got[..., d:], torch.zeros_like(got[..., d:]))
    torch.testing.assert_close(got[..., :d], ref.attention(q, k, v, causal=True, window=30),
                               **TOL["float32"])
    with pytest.raises(ValueError, match="head dim at most 256"):
        tflash.padded_head_dim(257)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


_FLAT = _bf16(2 * 3 * 40 * 64 + 8)


@pytest.mark.parametrize("make,in_place", [
    pytest.param(lambda: _bf16(2, 3, 40, 64), True, id="dense"),
    # the model's transposed views of its [B, S, H, D] projections
    pytest.param(lambda: _bf16(2, 40, 3, 64).transpose(1, 2), True, id="model-view"),
    pytest.param(lambda: _FLAT[8:].view(2, 3, 40, 64), True, id="16-byte-offset"),
    pytest.param(lambda: _FLAT[1:1 - 8].view(2, 3, 40, 64), False, id="2-byte-offset"),
    pytest.param(lambda: _bf16(2, 3, 40, 65)[..., :64], False, id="row-stride-65"),
    pytest.param(lambda: _bf16(2, 3, 40, 64).transpose(-1, -2), False, id="d-not-unit-stride"),
    pytest.param(lambda: _bf16(2, 1, 40, 64).expand(2, 3, 40, 64), False, id="head-stride-0"),
    # size-1 dims are never stepped, so their strides do not matter
    pytest.param(lambda: _bf16(40 * 64).as_strided((1, 1, 40, 64), (7, 3, 64, 1)), True,
                 id="size-1-dims"),
    pytest.param(lambda: _bf16(40 * 72).as_strided((1, 1, 40, 64), (7, 3, 72, 1)), True,
                 id="row-stride-72"),
])
def test_copies_in_place_decides_which_bf16_inputs_are_copied(make, in_place):
    """The kernel's TMA copies need a 16-byte aligned start and batch, head
    and sequence strides that are positive multiples of 8 elements."""
    assert tflash.copies_in_place(make()) is in_place


def _f32(*shape):
    return torch.zeros(shape, dtype=torch.float32)


_FLAT32 = _f32(2 * 3 * 40 * 64 + 4)


@pytest.mark.parametrize("make,in_place", [
    pytest.param(lambda: _f32(2, 3, 40, 64), True, id="dense"),
    # the model's transposed views of its [B, S, H, D] projections
    pytest.param(lambda: _f32(2, 40, 3, 64).transpose(1, 2), True, id="model-view"),
    pytest.param(lambda: _FLAT32[4:].view(2, 3, 40, 64), True, id="16-byte-offset"),
    pytest.param(lambda: _FLAT32[1:1 - 4].view(2, 3, 40, 64), False, id="4-byte-offset"),
    pytest.param(lambda: _f32(2, 3, 40, 65)[..., :64], False, id="row-stride-65"),
    # 68 elements are 16 bytes a multiple: in place for float32, not for bf16
    pytest.param(lambda: _f32(2, 3, 40, 68)[..., :64], True, id="row-stride-68"),
    pytest.param(lambda: _f32(2, 3, 40, 64).transpose(-1, -2), False, id="d-not-unit-stride"),
    # cp.async reads a stride-0 head as it reads any other
    pytest.param(lambda: _f32(2, 1, 40, 64).expand(2, 3, 40, 64), True, id="head-stride-0"),
    pytest.param(lambda: _f32(40 * 64).as_strided((1, 1, 40, 64), (7, 3, 64, 1)), True,
                 id="size-1-dims"),
])
def test_f32_copies_in_place_decides_which_float32_inputs_are_copied(make, in_place):
    """The float32 kernel's 16-byte copies need a 16-byte aligned start and
    batch, head and sequence strides that are multiples of 4 elements."""
    assert tflash.f32_copies_in_place(make()) is in_place


# Summation order alone: 1e-6 where the logits are O(1) (a scale at most
# D ** -0.5).  At scale 1.0 the logits of unit normals reach ~sqrt(D) * 4,
# and the softmax turns float32's ~1e-7 relative gap in them into up to
# 1.5e-5 in the output (D = 128, measured), so there the float32 TOL holds.
SCALE_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scale", [0.1, 1.0, None])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", [
    (2, 4, 2, 130, 190, 64, True, 0), (1, 4, 2, 96, 96, 80, True, 32),
    (2, 2, 2, 64, 100, 128, False, 0),
])
def test_plain_attention_takes_the_reference_scale(scale, b, hq, hkv, sq, skv, d, causal,
                                                   window):
    """``ref.attention(scale=)`` against JAX's ``ref.attention(scale=)`` and
    the port's ``chunked.attention(scale=)``, float32, at SCALE_TOL (TOL at
    a scale above ``D ** -0.5``); ``None`` is ``D ** -0.5``, the call
    without it bit for bit."""
    (qj, kj, vj), (q, k, v) = _qkv((b, hq, sq, d), (b, hkv, skv, d), "float32", seed=d)
    kw = dict(causal=causal, window=window, q_offset=max(skv - sq, 0))
    tol = TOL["float32"] if scale is not None and scale > d ** -0.5 else SCALE_TOL
    got = ref.attention(q, k, v, scale=scale, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.attention(qj, kj, vj, scale=scale,
                                                                      **kw)), **tol)
    torch.testing.assert_close(got, chunked.attention(q, k, v, scale=scale, **kw), **tol)
    if scale is None:
        assert torch.equal(got, ref.attention(q, k, v, **kw))
    else:
        assert not torch.allclose(got, ref.attention(q, k, v, **kw), **SCALE_TOL)
