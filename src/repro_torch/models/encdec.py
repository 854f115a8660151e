"""Whisper-style encoder-decoder backbone.  Port of ``repro.models.encdec``.

The audio frontend (mel filterbank and conv downsampling) is a stub, as in
the reference: the encoder takes frame embeddings ``[B, encoder_seq,
d_model]``.  Everything downstream is real: sinusoidal positions, a
LayerNorm / GeLU transformer encoder with non-causal self-attention, and a
decoder of causal self-attention, cross attention to the encoder states and
a GeLU MLP, with logits from the tied embedding.  Neither stack ropes.
Every norm is a LayerNorm at ``eps=1e-5`` (not ``cfg.norm_eps``).

Parameters: ``{"embed", "enc_blocks": [...], "enc_final": {"w", "b"},
"dec_blocks": [...], "dec_final": {"w", "b"}}``, an encoder block ``{"norm",
"attn", "mlp_norm", "mlp"}`` and a decoder block ``{"norm", "self_attn",
"cross_norm", "cross_attn", "mlp_norm", "mlp"}``; the JAX package stacks
the blocks on a leading axis and scans them, the port keeps lists and loops.
Decode caches are ``{"blocks": [{"self": {"k", "v"}, "cross": {"k",
"v"}}, ...]}``: the self-attention cache sized for the conversation, the
cross one the encoder states' K/V, projected once at the prefill.

In training the decoder blocks run under activation checkpointing with
``opts.remat == "full"``; the encoder never does (the reference scans it
without ``jax.checkpoint``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import apply_attn, attn_init
from repro_torch.models.common import constrain_batch
from repro_torch.models.layers import (
    embed_init,
    embed_lookup,
    gelu_mlp,
    gelu_mlp_init,
    layer_norm,
    sinusoidal_at,
    sinusoidal_positions,
)
from repro_torch.models.transformer import resize_kv_cache


def _ln_init(d, dtype, device):
    return {"w": torch.ones(d, dtype=dtype, device=device),
            "b": torch.zeros(d, dtype=dtype, device=device)}


def _ln(x, p):
    return layer_norm(x, p["w"], p["b"])


def _enc_block_init(generator, cfg, dtype):
    d, dev = cfg.d_model, generator.device
    return {
        "norm": _ln_init(d, dtype, dev),
        "attn": attn_init(generator, cfg, dtype),
        "mlp_norm": _ln_init(d, dtype, dev),
        "mlp": gelu_mlp_init(generator, d, cfg.d_ff, dtype),
    }


def _dec_block_init(generator, cfg, dtype):
    d, dev = cfg.d_model, generator.device
    return {
        "norm": _ln_init(d, dtype, dev),
        "self_attn": attn_init(generator, cfg, dtype),
        "cross_norm": _ln_init(d, dtype, dev),
        "cross_attn": attn_init(generator, cfg, dtype, cross=True),
        "mlp_norm": _ln_init(d, dtype, dev),
        "mlp": gelu_mlp_init(generator, d, cfg.d_ff, dtype),
    }


def encdec_init(generator: torch.Generator, cfg, dtype=torch.float32):
    dev = generator.device
    return {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype),
        "enc_blocks": [_enc_block_init(generator, cfg, dtype)
                       for _ in range(cfg.encoder_layers)],
        "enc_final": _ln_init(cfg.d_model, dtype, dev),
        "dec_blocks": [_dec_block_init(generator, cfg, dtype) for _ in range(cfg.n_layers)],
        "dec_final": _ln_init(cfg.d_model, dtype, dev),
    }


def encode(params, frames: torch.Tensor, *, cfg, opts) -> torch.Tensor:
    """frames ``[B, Se, D]`` (the stub frontend's output) -> encoder states
    ``[B, Se, D]`` in frames' dtype."""
    x = frames + sinusoidal_positions(frames.shape[1], cfg.d_model,
                                      device=frames.device).to(frames.dtype)
    zero_pos = torch.zeros(frames.shape[1], dtype=torch.int32, device=frames.device)
    for bp in params["enc_blocks"]:
        x = constrain_batch(x, opts.parallel)
        out, _ = apply_attn(bp["attn"], _ln(x, bp["norm"]), cfg=cfg, positions=zero_pos,
                            causal=False, use_rope=False, impl=opts.attn_impl,
                            return_cache=False)
        # as stack_apply's, after each sublayer
        x = constrain_batch(x + out, opts.parallel)
        x = constrain_batch(x + gelu_mlp(bp["mlp"], _ln(x, bp["mlp_norm"])), opts.parallel)
    return _ln(x, params["enc_final"])


def _dec_block(bp, x, *, cfg, opts, mode, positions, enc_out, cache, cache_length,
               prefill_capacity=None):
    """One decoder block.  Returns ``(x, {"self", "cross"})``, the caches
    None in training."""
    want = mode != "train"
    x = constrain_batch(x, opts.parallel)
    out, sc = apply_attn(
        bp["self_attn"], _ln(x, bp["norm"]), cfg=cfg, positions=positions, use_rope=False,
        impl=opts.attn_impl, cache=None if cache is None else cache["self"],
        cache_length=cache_length, return_cache=want,
    )
    x = constrain_batch(x + out, opts.parallel)
    if mode == "prefill":
        sc = resize_kv_cache(sc, x.shape[1], prefill_capacity or x.shape[1], cfg, 0)
    out, cc = apply_attn(
        bp["cross_attn"], _ln(x, bp["cross_norm"]), cfg=cfg, positions=positions, cross=True,
        kv_source=enc_out, impl=opts.attn_impl, cache=None if cache is None else cache["cross"],
        return_cache=want,
    )
    # as stack_apply's, after each sublayer
    x = constrain_batch(x + out, opts.parallel)
    x = constrain_batch(x + gelu_mlp(bp["mlp"], _ln(x, bp["mlp_norm"])), opts.parallel)
    return x, ({"self": sc, "cross": cc} if want else None)


def decode_stack(params, tokens: torch.Tensor, *, cfg, opts, mode, enc_out=None, caches=None,
                 cache_length: int | None = None, prefill_capacity: int | None = None):
    """tokens ``[B, S]`` -> ``(hidden [B, S, D], new_caches)``.  ``enc_out``
    is required for training and prefill; decode reads the cached cross K/V
    and adds the position ``cache_length``'s sinusoid."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be train, prefill or decode, got {mode!r}")
    if mode == "decode":
        dtype = caches["blocks"][0]["self"]["k"].dtype
    else:
        dtype = enc_out.dtype
    x = embed_lookup(params["embed"], tokens, dtype)
    dev = x.device
    if mode == "decode":  # filled on the device: no host-to-device copy, no sync
        positions = torch.full((1,), cache_length, dtype=torch.int32, device=dev)
        x = x + sinusoidal_at(positions[0], cfg.d_model).to(dtype)
    else:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=dev)
        x = x + sinusoidal_positions(tokens.shape[1], cfg.d_model, device=dev).to(dtype)
    kw = dict(cfg=cfg, opts=opts, mode=mode, positions=positions, cache_length=cache_length,
              prefill_capacity=prefill_capacity)

    if mode == "train":
        def block(bp, x, enc_out):
            return _dec_block(bp, x, enc_out=enc_out, cache=None, **kw)[0]

        for bp in params["dec_blocks"]:
            if opts.remat == "full":
                x = checkpoint(block, bp, x, enc_out, use_reentrant=False)
            else:
                x = block(bp, x, enc_out)
        return _ln(x, params["dec_final"]), None
    new_caches = {"blocks": []}
    for i, bp in enumerate(params["dec_blocks"]):
        bc = caches["blocks"][i] if mode == "decode" else None
        x, nc = _dec_block(bp, x, enc_out=enc_out, cache=bc, **kw)
        new_caches["blocks"].append(nc)
    return _ln(x, params["dec_final"]), new_caches


def encdec_cache_specs(cfg, batch: int, seq_len: int, dtype) -> dict:
    """The decode caches of a ``seq_len``-token conversation as meta
    tensors, in the layout ``decode_stack`` returns: a ``{"self", "cross"}``
    pair a decoder block, the cross pair over the encoder's states."""
    def kv(capacity):
        shape = (batch, cfg.n_kv_heads, capacity, cfg.head_dim)
        return {"k": torch.empty(shape, dtype=dtype, device="meta"),
                "v": torch.empty(shape, dtype=dtype, device="meta")}

    return {"blocks": [{"self": kv(seq_len), "cross": kv(cfg.encoder_seq)}
                       for _ in range(cfg.n_layers)]}
