"""Serving steps: prefill and single-token decode.  Port of
``repro.train.serve_step`` (the factories of ``repro.train.train_step``).

PyTorch runs eagerly, so where the JAX package hands these to ``jax.jit``,
the port calls them as they are.
"""

from __future__ import annotations


def make_prefill_step(model):
    """``(params, batch, max_len=None) -> (last_logits [B, V], caches)``;
    ``max_len`` sizes the caches for the whole conversation."""

    def prefill_step(params, batch, max_len=None):
        return model.prefill_fn(params, batch, max_len=max_len)

    return prefill_step


def make_decode_step(model):
    """One new token per row against caches holding ``cache_length`` tokens."""

    def decode_step(params, tokens, caches, cache_length):
        return model.decode_fn(params, tokens, caches, cache_length)

    return decode_step
