"""RecurrentGemma's recurrent block: a GeLU branch and a conv + RG-LRU
branch in parallel, merged and projected back to d_model.  Port of
``repro.models.rglru``.  The gates are per-channel (diagonal).

Decode carries a constant-size cache per layer, ``{"conv": [B, K-1, lw],
"h": [B, lw] float32}``: the last K-1 steps of the recurrent branch's input
*before* the conv (left-padded with zeros when the prompt is shorter), and
the recurrence's final state.

Layouts: ``w_rec``, ``w_gelu`` ``[lw, d]`` and ``w_out`` ``[d, lw]`` are
``[out, in]`` for ``F.linear`` (the JAX package's transposes); ``conv_w``
stays ``[K, lw]`` and goes through ``models/ssm.py``'s ``_causal_conv``, the
function the JAX block imports from its SSM module.  The GeLU is the tanh
form: ``jax.nn.gelu`` defaults to ``approximate=True``, PyTorch's to the
exact erf form, and the two differ by up to 4e-4.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models.common import rank_by_rank
from repro_torch.models.layers import uniform_scale_init
from repro_torch.models.ssm import _causal_conv

RG_CONV = 4


def rg_init(generator: torch.Generator, cfg, dtype=torch.float32):
    d, lw = cfg.d_model, cfg.lru_width or cfg.d_model
    dev = generator.device

    def const(value):
        return torch.full((lw,), value, dtype=dtype, device=dev)

    # softplus(a_param) with a_param ~ U[-2, 1]: the decay a^c spans ~(0.9, 0.999)
    a_param = torch.empty(lw, dtype=torch.float32, device=dev).uniform_(-2.0, 1.0,
                                                                        generator=generator)
    return {
        "w_rec": uniform_scale_init(generator, (lw, d), dtype),
        "w_gelu": uniform_scale_init(generator, (lw, d), dtype),
        "w_out": uniform_scale_init(generator, (d, lw), dtype),
        # [K, lw]: fan-in K, as the JAX package's init of the same layout
        "conv_w": uniform_scale_init(generator, (RG_CONV, lw), dtype,
                                     scale=math.sqrt(3.0 / RG_CONV)),
        "conv_b": const(0.0),
        "wgx": const(1.0),
        "bgx": const(0.0),
        "wga": const(1.0),
        "bga": const(0.0),
        "a_param": a_param.to(dtype),
    }


def _gates(p, rec):
    dt = rec.dtype
    gate_x = rec * p["wgx"].to(dt) + p["bgx"].to(dt)
    gate_a = rec * p["wga"].to(dt) + p["bga"].to(dt)
    return gate_x, gate_a


def _scan(rec, gate_x, gate_a, a_param, *, impl, return_state):
    """``ops.rglru``; under a mesh rank by rank (``common.rank_by_rank``),
    each rank its batch rows and, where they divide the model axis, its
    channels (DTensor lays the scan's per-step outputs out so that the next
    product cannot take them)."""
    def scan(rec, gate_x, gate_a, a_param):
        return ops.rglru(rec, gate_x, gate_a, a_param, impl=impl, return_state=return_state)

    return rank_by_rank(scan, (rec, gate_x, gate_a, a_param), ((0, 2),) * 3 + ((None, 0),),
                        ((0, 2), (0, 1)) if return_state else ((0, 2),))


def rg_apply(p, x, *, cfg, impl="auto", cache=None, return_cache=True):
    """x [B, S, D].  The whole sequence through ``ops.rglru`` when ``cache``
    is None (prefill; training with ``return_cache=False``, which builds no
    cache and returns None for it), else one decode step (S == 1) through
    the recurrence from the cached state.  Returns ``(out [B, S, D],
    cache)``."""
    B, S, _ = x.shape
    K = RG_CONV
    rec_in = F.linear(x, p["w_rec"].to(x.dtype))
    gel = F.gelu(F.linear(x, p["w_gelu"].to(x.dtype)).float(), approximate="tanh").to(x.dtype)

    if cache is None:
        conv_tail = rec_in[:, -(K - 1):, :]
        if conv_tail.shape[1] < K - 1:
            conv_tail = F.pad(conv_tail, (0, 0, K - 1 - conv_tail.shape[1], 0))
        rec = _causal_conv(rec_in, p["conv_w"], p["conv_b"])
        if not return_cache:
            h = _scan(rec, *_gates(p, rec), p["a_param"], impl=impl, return_state=False)
            return F.linear(h * gel, p["w_out"].to(x.dtype)), None
        h, h_last = _scan(rec, *_gates(p, rec), p["a_param"], impl=impl, return_state=True)
        out = F.linear(h * gel, p["w_out"].to(x.dtype))
        # clone: a view of rec_in would keep all of it alive in the cache
        return out, {"conv": conv_tail.clone(), "h": h_last}

    if S != 1:
        raise NotImplementedError("chunked append-prefill is not needed by the serving path")
    conv_win = torch.cat([cache["conv"], rec_in], dim=1)  # [B, K, lw]
    rec = torch.einsum("bkc,kc->bc", conv_win, p["conv_w"].to(x.dtype))
    rec = (rec + p["conv_b"].to(x.dtype))[:, None, :]  # [B, 1, lw]
    h, h_last = ref.rglru(rec, *_gates(p, rec), p["a_param"], h0=cache["h"], return_state=True)
    out = F.linear(h * gel, p["w_out"].to(x.dtype))
    return out, {"conv": conv_win[:, 1:], "h": h_last}


def rg_cache_shape(cfg, batch: int, dtype) -> dict:
    """One layer's decode cache as meta tensors: ``conv`` in ``dtype``, the
    state ``h`` in float32."""
    lw = cfg.lru_width or cfg.d_model
    return {
        "conv": torch.empty((batch, RG_CONV - 1, lw), dtype=dtype, device="meta"),
        "h": torch.empty((batch, lw), dtype=torch.float32, device="meta"),
    }
