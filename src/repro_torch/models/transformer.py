"""The decoder stack of the dense family: a Python loop over blocks.  Port
of ``repro.models.transformer`` for the ``("attn",)`` pattern.

A *block* is one repetition of the architecture's mixer pattern; for the
dense family that is one sublayer, attention then a SwiGLU MLP, each behind
an RMSNorm and a residual.  The JAX package stacks the blocks' parameters on
a leading ``n_blocks`` axis and runs one ``lax.scan``; here the stack is a
list of per-block dicts (``{"sub0": {...}}``, the JAX names) and the scan is
a loop.  Decode caches mirror it: ``{"blocks": [{"sub0": {"k", "v"}}, ...]}``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.attention import apply_attn, attn_init, cache_capacity
from repro_torch.models.common import ModelOptions
from repro_torch.models.layers import rms_norm, swiglu, swiglu_init


def _sublayer_init(generator: torch.Generator, cfg, dtype):
    dev = generator.device
    return {
        "norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
        "mix": attn_init(generator, cfg, dtype),
        "mlp_norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
        "mlp": swiglu_init(generator, cfg.d_model, cfg.d_ff, dtype),
    }


def stack_init(generator: torch.Generator, cfg, dtype=torch.float32):
    return {"blocks": [{"sub0": _sublayer_init(generator, cfg, dtype)}
                       for _ in range(cfg.n_layers)]}


def _apply_sublayer(sp, x, *, cfg, opts: ModelOptions, mode, positions, cache,
                    cache_length, prefill_capacity=None):
    """One attention + MLP sublayer.  Returns ``(x, new_cache)``."""
    h = rms_norm(x, sp["norm"], cfg.norm_eps)
    out, new_cache = apply_attn(
        sp["mix"], h, cfg=cfg, positions=positions, window=cfg.window,
        impl=opts.attn_impl, cache=cache, cache_length=cache_length,
    )
    if mode == "prefill":
        new_cache = resize_kv_cache(new_cache, h.shape[1], prefill_capacity or h.shape[1],
                                    cfg, cfg.window)
    x = x + out
    h2 = rms_norm(x, sp["mlp_norm"], cfg.norm_eps)
    return x + swiglu(sp["mlp"], h2), new_cache


def resize_kv_cache(cache, used: int, target_len: int, cfg, window: int):
    """Fit a freshly prefilled KV cache (``used`` positions) to the capacity
    a ``target_len``-token conversation needs: ring-fold when the window is
    smaller, zero-pad headroom when larger."""
    C = cache_capacity(cfg, max(target_len, used), window)
    S = cache["k"].shape[2]
    if C < S:  # ring fold: slot j holds absolute position used-1-((used-1-j)%C)
        j = torch.arange(C, device=cache["k"].device)
        pos = used - 1 - torch.remainder(used - 1 - j, C)
        return {"k": cache["k"].index_select(2, pos), "v": cache["v"].index_select(2, pos)}
    if C > S:  # headroom for later ring inserts at slot (t mod C)
        return {"k": F.pad(cache["k"], (0, 0, 0, C - S)), "v": F.pad(cache["v"], (0, 0, 0, C - S))}
    return cache


def _block_apply(bp, x, *, cfg, opts, mode, positions, caches, cache_length,
                 prefill_capacity=None):
    """The sublayers of one block in order.  Returns ``(x, new_caches)``."""
    new_caches = {}
    for name, sp in bp.items():
        c = caches[name] if caches is not None else None
        x, new_caches[name] = _apply_sublayer(
            sp, x, cfg=cfg, opts=opts, mode=mode, positions=positions, cache=c,
            cache_length=cache_length, prefill_capacity=prefill_capacity,
        )
    return x, new_caches


def stack_apply(
    params,
    x: torch.Tensor,  # [B, S, D] embedded inputs
    *,
    cfg,
    opts: ModelOptions,
    mode: str,  # prefill | decode
    positions: torch.Tensor,
    caches=None,  # {"blocks": [...]} (decode), or None
    cache_length: int | None = None,  # decode: tokens already in the caches
    prefill_capacity: int | None = None,  # total conversation length to hold
):
    """Returns ``(x, new_caches)``."""
    if mode not in ("prefill", "decode"):
        raise ValueError(f"mode must be prefill or decode, got {mode!r} (training comes later)")
    new_blocks = []
    for i, bp in enumerate(params["blocks"]):
        bc = caches["blocks"][i] if mode == "decode" else None
        x, nc = _block_apply(
            bp, x, cfg=cfg, opts=opts, mode=mode, positions=positions, caches=bc,
            cache_length=cache_length, prefill_capacity=prefill_capacity,
        )
        new_blocks.append(nc)
    return x, {"blocks": new_blocks}
