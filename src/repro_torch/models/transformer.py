"""The decoder stack of the dense, moe, ssm, hybrid and vlm families: a
Python loop over blocks.  Port of ``repro.models.transformer``.

A *block* is one repetition of the architecture's mixer pattern:
``("attn",)`` for dense, moe and vlm, ``("ssm",)`` for ssm,
``cfg.layer_pattern`` (e.g. ``("rglru", "rglru", "attn")``) for hybrid.
Each of its sublayers is the mixer (attention, the Mamba2 SSD block or the
RG-LRU block) behind an RMSNorm and a residual, then, where ``d_ff > 0``, an
MLP behind its own RMSNorm and residual (mamba2 has none): SwiGLU, or where
``cfg.n_experts`` is set the MoE layer (``models/moe.py``), whose
load-balance losses the stack sums.  Layer counts not divisible by
the pattern get unstacked tail layers that repeat the pattern's prefix.  The
JAX package stacks the blocks' parameters on a leading ``n_blocks`` axis and
runs one ``lax.scan``; here the stack is ``{"blocks": [{"sub0": {...},
...}, ...], "tail": {"sub0": {...}, ...}}`` (the JAX names; ``"tail"`` only
where there are tail layers) and the scan is a loop.  Decode caches mirror
it, with ``{"k", "v"}`` for attention (the window's ring buffer for a
hybrid's local attention), ``{"conv", "ssm"}`` for the SSD block and
``{"conv", "h"}`` for the RG-LRU block (constant size: no resize).
Training builds no cache, and with ``remat="full"`` recomputes each
block's activations in the backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import apply_attn, attn_init, cache_capacity
from repro_torch.models.common import ModelOptions, constrain_batch, constrain_seq
from repro_torch.models.layers import rms_norm, swiglu, swiglu_init
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.rglru import rg_apply, rg_cache_shape, rg_init
from repro_torch.models.ssm import ssm_apply, ssm_cache_shape, ssm_init

_MIXER_INIT = {"attn": attn_init, "ssm": ssm_init, "rglru": rg_init}


def block_counts(cfg) -> tuple:
    """(n_blocks, tail_kinds): ``cfg.layer_kinds()`` as whole repeats of the
    block pattern, then the tail layers."""
    kinds, per_block = cfg.layer_kinds(), len(cfg.block_pattern)
    n_blocks = len(kinds) // per_block
    return n_blocks, kinds[n_blocks * per_block:]


def _has_mlp(cfg) -> bool:
    return cfg.d_ff > 0


def _sublayer_init(generator: torch.Generator, cfg, kind, dtype):
    dev = generator.device
    p = {"norm": torch.ones(cfg.d_model, dtype=dtype, device=dev),
         "mix": _MIXER_INIT[kind](generator, cfg, dtype)}
    if _has_mlp(cfg):
        p["mlp_norm"] = torch.ones(cfg.d_model, dtype=dtype, device=dev)
        p["mlp"] = (moe_init(generator, cfg, dtype) if cfg.n_experts
                    else swiglu_init(generator, cfg.d_model, cfg.d_ff, dtype))
    return p


def _block_init(generator: torch.Generator, cfg, kinds, dtype):
    return {f"sub{i}": _sublayer_init(generator, cfg, kind, dtype) for i, kind in enumerate(kinds)}


def stack_init(generator: torch.Generator, cfg, dtype=torch.float32):
    n_blocks, tail = block_counts(cfg)
    params = {"blocks": [_block_init(generator, cfg, cfg.block_pattern, dtype)
                         for _ in range(n_blocks)]}
    if tail:
        params["tail"] = _block_init(generator, cfg, tail, dtype)
    return params


def _apply_sublayer(sp, x, kind, *, cfg, opts: ModelOptions, mode, positions, cache,
                    cache_length, prefill_capacity=None):
    """One mixer (+ MLP) sublayer.  Returns ``(x, new_cache, aux)``: the
    cache is None in training, ``aux`` the MoE layer's load-balance loss
    (None without one)."""
    h = rms_norm(x, sp["norm"], cfg.norm_eps)
    return_cache = mode != "train"
    if kind == "ssm":
        out, new_cache = ssm_apply(sp["mix"], h, cfg=cfg, impl=opts.mixer_impl, cache=cache,
                                   return_cache=return_cache)
    elif kind == "rglru":
        out, new_cache = rg_apply(sp["mix"], h, cfg=cfg, impl=opts.mixer_impl, cache=cache,
                                  return_cache=return_cache)
    else:
        out, new_cache = apply_attn(
            sp["mix"], h, cfg=cfg, positions=positions, window=cfg.window,
            impl=opts.attn_impl, cache=cache, cache_length=cache_length,
            return_cache=return_cache,
        )
        if mode == "prefill":
            new_cache = resize_kv_cache(new_cache, h.shape[1], prefill_capacity or h.shape[1],
                                        cfg, cfg.window)
    x = x + out
    aux = None
    if _has_mlp(cfg):
        # Under a mesh the mixer's output projection leaves a partial sum over
        # the model axis; summed here, so the MLP's products start from the
        # batch-sharded layout GSPMD would pick (DTensor cannot flatten a
        # partial [B, S, D] into the MLP's products on the production mesh).
        x = constrain_batch(x, opts.parallel)
        h = rms_norm(x, sp["mlp_norm"], cfg.norm_eps)
        if cfg.n_experts:
            out, aux = moe_apply(sp["mlp"], h, cfg, impl=opts.moe_impl, parallel=opts.parallel)
        else:
            out = swiglu(sp["mlp"], h)
        x = x + out
    return x, new_cache, aux


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


def _block_apply(bp, x, kinds, *, cfg, opts, mode, positions, caches, cache_length,
                 prefill_capacity=None):
    """The sublayers of one block in order.  Returns ``(x, new_caches,
    aux)``, ``aux`` the sum of their load-balance losses, float32."""
    new_caches = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if opts.seq_shard and mode == "train":
        # Block inputs are what remat saves: sharding them over the model
        # axis (sequence parallelism) divides saved-activation memory by TP.
        x = constrain_seq(x, opts.parallel)
    else:
        x = constrain_batch(x, opts.parallel)
    for i, kind in enumerate(kinds):
        name = f"sub{i}"
        c = caches[name] if caches is not None else None
        x, new_caches[name], aux_i = _apply_sublayer(
            bp[name], x, kind, cfg=cfg, opts=opts, mode=mode, positions=positions, cache=c,
            cache_length=cache_length, prefill_capacity=prefill_capacity,
        )
        x = constrain_batch(x, opts.parallel)
        if aux_i is not None:
            aux = aux + aux_i
    return x, new_caches, aux


def stack_apply(
    params,
    x: torch.Tensor,  # [B, S, D] embedded inputs
    *,
    cfg,
    opts: ModelOptions,
    mode: str,  # train | prefill | decode
    positions: torch.Tensor,
    caches=None,  # {"blocks": [...], "tail": {...}} (decode), or None
    cache_length: int | None = None,  # decode: tokens already in the caches
    prefill_capacity: int | None = None,  # total conversation length to hold
):
    """Returns ``(x, new_caches, aux)``: ``new_caches`` is None in training,
    and ``aux`` is the sum of the layers' load-balance losses in float32
    (zero without MoE layers), as the reference's scan carries it.  In
    training with ``opts.remat == "full"`` each block, and the tail, runs
    under activation checkpointing (non-reentrant: its activations are
    recomputed in the backward), as ``jax.checkpoint`` wraps the JAX
    package's scanned block; the block returns its ``aux`` beside ``x``, so
    the loss differentiates through it."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")
    pat = cfg.block_pattern
    _, tail = block_counts(cfg)
    kw = dict(cfg=cfg, opts=opts, mode=mode, positions=positions, cache_length=cache_length,
              prefill_capacity=prefill_capacity)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mode == "train":
        def block(bp, kinds, x):
            x, _, aux_i = _block_apply(bp, x, kinds, caches=None, **kw)
            return x, aux_i

        stages = [(bp, pat) for bp in params["blocks"]]
        if tail:
            stages.append((params["tail"], tail))
        for bp, kinds in stages:
            if opts.remat == "full":
                x, aux_i = checkpoint(block, bp, kinds, x, use_reentrant=False)
            else:
                x, aux_i = block(bp, kinds, x)
            aux = aux + aux_i
        return x, None, aux
    new_caches = {"blocks": []}
    for i, bp in enumerate(params["blocks"]):
        bc = caches["blocks"][i] if mode == "decode" else None
        x, nc, aux_i = _block_apply(bp, x, pat, caches=bc, **kw)
        new_caches["blocks"].append(nc)
        aux = aux + aux_i
    if tail:
        tc = caches["tail"] if mode == "decode" else None
        x, new_caches["tail"], aux_i = _block_apply(params["tail"], x, tail, caches=tc, **kw)
        aux = aux + aux_i
    return x, new_caches, aux


def _sublayer_cache_spec(cfg, kind, batch: int, seq_len: int, dtype) -> dict:
    if kind == "attn":
        shape = (batch, cfg.n_kv_heads, cache_capacity(cfg, seq_len, cfg.window), cfg.head_dim)
        return {"k": torch.empty(shape, dtype=dtype, device="meta"),
                "v": torch.empty(shape, dtype=dtype, device="meta")}
    if kind == "ssm":
        return ssm_cache_shape(cfg, batch, dtype)
    if kind == "rglru":
        return rg_cache_shape(cfg, batch, dtype)
    raise ValueError(kind)


def stack_cache_specs(cfg, batch: int, seq_len: int, dtype) -> dict:
    """Meta tensors in the layout of ``stack_apply``'s caches (a list of
    blocks, then the tail), each cache sized for a ``seq_len``-token
    conversation."""
    n_blocks, tail = block_counts(cfg)

    def block(kinds):
        return {f"sub{i}": _sublayer_cache_spec(cfg, k, batch, seq_len, dtype)
                for i, k in enumerate(kinds)}

    specs = {"blocks": [block(cfg.block_pattern) for _ in range(n_blocks)]}
    if tail:
        specs["tail"] = block(tail)
    return specs
