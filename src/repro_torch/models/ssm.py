"""Mamba2 block (SSD mixer): projections, causal depthwise conv, the SSD
scan, gated RMSNorm and the out projection.  Port of ``repro.models.ssm``.

Attention-free: decode carries a constant-size cache per layer, ``{"conv":
[B, K-1, d_inner + 2N], "ssm": [B, H, P, N] float32}``.  The conv cache is
the last K-1 steps of the projection's ``xBC`` part *before* the conv (left-
padded with zeros when the prompt is shorter); the SSM cache is the scan's
final state.

Layouts: ``in_proj [2 d_inner + 2N + H, d]`` and ``out_proj [d, d_inner]``
are ``[out, in]`` for ``F.linear`` (the JAX package's transposes);
``conv_w`` stays ``[K, C]`` as in the JAX package: the conv is K shifted
multiply-adds over the channel-last ``[B, S, C]`` activations, with no
transpose and no cuDNN (whose float32 convolutions default to TF32).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import rank_by_rank, split_last
from repro_torch.models.layers import rms_norm, uniform_scale_init


def ssm_init(generator: torch.Generator, cfg, dtype=torch.float32):
    d, di, n, h, k = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_conv
    conv_ch = di + 2 * n
    dev = generator.device
    dt_bias = torch.empty(h, dtype=torch.float32, device=dev).uniform_(-4.6, -2.2,
                                                                       generator=generator)
    return {
        # in_proj emits [z (di), xBC (di + 2N), dt (H)]
        "in_proj": uniform_scale_init(generator, (2 * di + 2 * n + h, d), dtype),
        # [K, C]: fan-in K, as the JAX package's init of the same layout
        "conv_w": uniform_scale_init(generator, (k, conv_ch), dtype, scale=math.sqrt(3.0 / k)),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)).to(dtype),
        "d_skip": torch.ones(h, dtype=dtype, device=dev),
        "dt_bias": dt_bias.to(dtype),  # softplus^-1 of dt in ~[0.01, 0.1]
        "gnorm": torch.ones(di, dtype=dtype, device=dev),
        "out_proj": uniform_scale_init(generator, (d, di), dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, x [B, S, C], w [K, C]: zeros on the
    left only, and no flip (cross-correlation, as ``conv_general_dilated``):
    out_t = sum_k w_k x_{t - (K-1) + k} + b."""
    k = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    w = w.to(x.dtype)
    out = xp[:, :S] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + S] * w[i]
    return out + b.to(x.dtype)


def _split_proj(p, x, cfg):
    di, n = cfg.d_inner, cfg.ssm_state
    zxbcdt = F.linear(x, p["in_proj"].to(x.dtype))
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n:]


def _ssm_inputs(p, xbc, dt, cfg):
    """Split the conv output into the scan's x, b, c; dt and a in float32."""
    di, n = cfg.d_inner, cfg.ssm_state
    x_ssm = split_last(xbc[..., :di], (cfg.n_ssm_heads, cfg.ssm_head_dim))
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    return x_ssm, dt, a, xbc[..., di:di + n], xbc[..., di + n:]


def _finish(p, y_flat, z, cfg):
    y = rms_norm(y_flat * F.silu(z.float()).to(y_flat.dtype), p["gnorm"], cfg.norm_eps)
    return F.linear(y, p["out_proj"].to(y.dtype))


def _ssd(x, dt, a, b, c, d, h0, *, impl, return_state):
    """``ops.ssd`` with ``y`` flat (``[B, S, H * P]``); under a mesh rank by
    rank (``common.rank_by_rank``), each rank its batch rows and, where they
    divide the model axis, its heads.  ``y`` is flattened on each rank:
    DTensor can neither flatten the heads with their head dim sharded nor,
    in the backward, split a gradient whose heads divide unevenly."""
    def scan(x, dt, a, b, c, d, h0):
        if return_state:
            y, state = ops.ssd(x, dt, a, b, c, d, h0=h0, impl=impl, return_state=True)
            return y.flatten(2), state
        return ops.ssd(x, dt, a, b, c, d, h0=h0, impl=impl).flatten(2)

    dims = ((0, 2), (0, 2), (None, 0), (0, None), (0, None), (None, 0), (0, 1))
    return rank_by_rank(scan, (x, dt, a, b, c, d, h0), dims,
                        ((0, 2), (0, 1)) if return_state else ((0, 2),))


def ssm_apply(p, x, *, cfg, impl="auto", cache=None, return_cache=True):
    """x [B, S, D].  The whole sequence through ``ops.ssd`` when ``cache``
    is None (prefill; training with ``return_cache=False``, which builds no
    cache and returns None for it), else one decode step (S == 1) through
    the recurrence from the cached state.  Returns ``(out [B, S, D],
    cache)``."""
    S, K = x.shape[1], cfg.ssm_conv
    z, xbc, dt = _split_proj(p, x, cfg)
    d_skip = p["d_skip"].float()

    if cache is None:
        conv_tail = xbc[:, -(K - 1):, :]
        if conv_tail.shape[1] < K - 1:
            conv_tail = F.pad(conv_tail, (0, 0, K - 1 - conv_tail.shape[1], 0))
        xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]).float()).to(x.dtype)
        x_ssm, dt, a, b_mat, c_mat = _ssm_inputs(p, xbc, dt, cfg)
        if not return_cache:
            y = _ssd(x_ssm, dt, a, b_mat, c_mat, d_skip, None, impl=impl, return_state=False)
            return _finish(p, y, z, cfg), None
        y, state = _ssd(x_ssm, dt, a, b_mat, c_mat, d_skip, None, impl=impl, return_state=True)
        return _finish(p, y, z, cfg), {"conv": conv_tail.contiguous(), "ssm": state}

    if S != 1:
        raise NotImplementedError("chunked append-prefill is not needed by the serving path")
    conv_win = torch.cat([cache["conv"], xbc], dim=1)  # [B, K, C]
    xbc_t = torch.einsum("bkc,kc->bc", conv_win, p["conv_w"].to(x.dtype))
    xbc_t = F.silu((xbc_t + p["conv_b"].to(x.dtype)).float()).to(x.dtype)[:, None, :]
    x_ssm, dt, a, b_mat, c_mat = _ssm_inputs(p, xbc_t, dt, cfg)
    y, state = _ssd(x_ssm, dt, a, b_mat, c_mat, d_skip, cache["ssm"], impl=impl,
                    return_state=True)
    return _finish(p, y, z, cfg), {"conv": conv_win[:, 1:], "ssm": state}


def ssm_cache_shape(cfg, batch: int, dtype) -> dict:
    """One layer's decode cache as meta tensors: ``conv`` in ``dtype``, the
    SSM state in float32."""
    di, n, h, pp = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads, cfg.ssm_head_dim
    return {
        "conv": torch.empty((batch, cfg.ssm_conv - 1, di + 2 * n), dtype=dtype, device="meta"),
        "ssm": torch.empty((batch, h, pp, n), dtype=torch.float32, device="meta"),
    }
