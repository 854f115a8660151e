"""The decoder stack of the dense and ssm families: a Python loop over
blocks.  Port of ``repro.models.transformer`` for the ``("attn",)`` and
``("ssm",)`` patterns.

A *block* is one repetition of the architecture's mixer pattern; for both
families that is one sublayer: the mixer (attention, or the Mamba2 SSD
block) behind an RMSNorm and a residual, then, where ``d_ff > 0``, a SwiGLU
MLP behind its own RMSNorm and residual (mamba2 has none).  The JAX package
stacks the blocks' parameters on a leading ``n_blocks`` axis and runs one
``lax.scan``; here the stack is a list of per-block dicts (``{"sub0":
{...}}``, the JAX names) and the scan is a loop.  Decode caches mirror it:
``{"blocks": [{"sub0": cache}, ...]}`` with ``{"k", "v"}`` for attention and
``{"conv", "ssm"}`` for the SSD block (constant size: no resize).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.attention import apply_attn, attn_init, cache_capacity
from repro_torch.models.common import ModelOptions
from repro_torch.models.layers import rms_norm, swiglu, swiglu_init
from repro_torch.models.ssm import ssm_apply, ssm_init


def pattern_of(cfg) -> tuple:
    return ("ssm",) if cfg.family == "ssm" else ("attn",)


def _has_mlp(cfg) -> bool:
    return cfg.d_ff > 0


def _sublayer_init(generator: torch.Generator, cfg, kind, dtype):
    dev = generator.device
    p = {"norm": torch.ones(cfg.d_model, dtype=dtype, device=dev)}
    p["mix"] = attn_init(generator, cfg, dtype) if kind == "attn" else ssm_init(generator, cfg,
                                                                               dtype)
    if _has_mlp(cfg):
        p["mlp_norm"] = torch.ones(cfg.d_model, dtype=dtype, device=dev)
        p["mlp"] = swiglu_init(generator, cfg.d_model, cfg.d_ff, dtype)
    return p


def stack_init(generator: torch.Generator, cfg, dtype=torch.float32):
    return {"blocks": [{f"sub{i}": _sublayer_init(generator, cfg, kind, dtype)
                        for i, kind in enumerate(pattern_of(cfg))} for _ in range(cfg.n_layers)]}


def _apply_sublayer(sp, x, kind, *, cfg, opts: ModelOptions, mode, positions, cache,
                    cache_length, prefill_capacity=None):
    """One mixer (+ MLP) sublayer.  Returns ``(x, new_cache)``."""
    h = rms_norm(x, sp["norm"], cfg.norm_eps)
    if kind == "ssm":
        out, new_cache = ssm_apply(sp["mix"], h, cfg=cfg, impl=opts.mixer_impl, cache=cache)
    else:
        out, new_cache = apply_attn(
            sp["mix"], h, cfg=cfg, positions=positions, window=cfg.window,
            impl=opts.attn_impl, cache=cache, cache_length=cache_length,
        )
        if mode == "prefill":
            new_cache = resize_kv_cache(new_cache, h.shape[1], prefill_capacity or h.shape[1],
                                        cfg, cfg.window)
    x = x + out
    if _has_mlp(cfg):
        x = x + swiglu(sp["mlp"], rms_norm(x, sp["mlp_norm"], cfg.norm_eps))
    return x, new_cache


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
    for i, kind in enumerate(pattern_of(cfg)):
        name = f"sub{i}"
        c = caches[name] if caches is not None else None
        x, new_caches[name] = _apply_sublayer(
            bp[name], x, kind, cfg=cfg, opts=opts, mode=mode, positions=positions, cache=c,
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
