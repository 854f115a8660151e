"""GQA attention block: full sequence (training and prefill) through
``kernels.ops.attention``, single-token decode against a (possibly
ring-buffered) KV cache, and encoder-decoder cross attention.  Port of
``repro.models.attention``.

KV caches are dicts ``{"k": [B, Hkv, C, hd], "v": [B, Hkv, C, hd]}`` where
``C`` is the capacity.  For sliding-window archs ``C = window`` and the cache
is a ring buffer.  RoPE is applied to K at insert time (absolute positions),
so ring slots never need re-rotation.  A cross-attention cache holds the
encoder states' K/V, projected once at the prefill and read by every decode
step.  Unlike the JAX package's functional
update, :func:`_ring_insert` writes the new step into the cache in place: a
decode step then touches one slot instead of copying the cache.

Under a mesh (q, k and v DTensors) the attention runs in a ``local_map``
(:func:`_attend`): each rank attends its own rows of the batch (over the
data axes) and its own heads (over the model axis, where both head counts
divide), so the chunked attention's blocks, its hand-written backward and
the CUDA kernel run on local tensors.  DTensor's sharding search for each of
the blockwise einsums is what this saves (on a three-dim mesh it does not
finish in minutes).
"""

from __future__ import annotations


import torch
import torch.nn.functional as F

from repro_torch.device import is_dtensor
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.common import rank_by_rank, split_last
from repro_torch.models.layers import rope, uniform_scale_init


def attn_init(generator: torch.Generator, cfg, dtype=torch.float32, cross: bool = False):
    """The projections (and, for self-attention with ``cfg.qkv_bias``, the
    Q/K/V biases; cross attention has none)."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": uniform_scale_init(generator, (hq * hd, d), dtype),
        "wk": uniform_scale_init(generator, (hkv * hd, d), dtype),
        "wv": uniform_scale_init(generator, (hkv * hd, d), dtype),
        "wo": uniform_scale_init(generator, (d, hq * hd), dtype),
    }
    if cfg.qkv_bias and not cross:
        dev = generator.device
        p["bq"] = torch.zeros(hq * hd, dtype=dtype, device=dev)
        p["bk"] = torch.zeros(hkv * hd, dtype=dtype, device=dev)
        p["bv"] = torch.zeros(hkv * hd, dtype=dtype, device=dev)
    return p


def cache_capacity(cfg, seq_len: int, window: int) -> int:
    return min(seq_len, window) if window > 0 else seq_len


def init_cache(cfg, batch: int, capacity: int, dtype, device):
    shape = (batch, cfg.n_kv_heads, capacity, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _slot_positions(capacity: int, length: int, device) -> torch.Tensor:
    """Absolute position held by each ring slot after ``length`` inserts.
    Slots not yet written get -1 (masked)."""
    j = torch.arange(capacity, device=device)
    if length <= capacity:
        pos = j
    else:
        pos = length - 1 - torch.remainder(length - 1 - j, capacity)
    return torch.where(j < min(length, capacity), pos, -1)


def _attend(q, k, v, **kw):
    """``ops.attention``; on DTensors ``[B, H, S, hd]`` rank by rank, the
    batch and the heads split where they divide (``common.rank_by_rank``)."""
    return rank_by_rank(lambda q, k, v: ops.attention(q, k, v, **kw), (q, k, v),
                        ((0, 1),) * 3, ((0, 1),))


def _project(p, x, name, heads, hd):
    b = p.get("b" + name)
    out = F.linear(x, p["w" + name].to(x.dtype), None if b is None else b.to(x.dtype))
    return split_last(out, (heads, hd))


def apply_attn(
    p,
    x: torch.Tensor,  # [B, S, D]
    *,
    cfg,
    positions: torch.Tensor,  # [S] absolute positions of the query tokens
    window: int = 0,
    causal: bool = True,
    use_rope: bool = True,
    impl: str = "auto",
    cache: dict | None = None,
    cache_length: int | None = None,  # tokens already in the cache
    return_cache: bool = True,
    cross: bool = False,
    kv_source: torch.Tensor | None = None,  # [B, Se, D] encoder states for cross attention
):
    """Self-attention (RoPE unless ``use_rope=False``, causal unless
    ``causal=False``), or with ``cross=True`` attention from ``x`` to
    ``kv_source`` (never causal, no RoPE).  Returns ``(out [B, S, D],
    cache)``.

    - train: ``cache`` None and ``return_cache=False``; the cache is None;
    - prefill: ``cache`` None; the returned cache holds this call's K/V
      (for cross attention, ``kv_source``'s);
    - decode: ``cache`` given, ``S == 1``, ``cache_length`` tokens already
      stored; the new step is inserted in place (cross attention reads its
      cache as it is).
    """
    B, S, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rope_on = use_rope and not cross

    q = _project(p, x, "q", hq, hd)
    if rope_on:
        q = rope(q, positions, cfg.rope_theta)
    q = q.transpose(1, 2)  # [B, Hq, S, hd]

    if cross:
        if cache is None:
            cache = {"k": _project(p, kv_source, "k", hkv, hd).transpose(1, 2),
                     "v": _project(p, kv_source, "v", hkv, hd).transpose(1, 2)}
        out = _attend(q, cache["k"], cache["v"], causal=False, impl=impl)
        if not return_cache:
            cache = None
    else:
        k = _project(p, x, "k", hkv, hd)
        if rope_on:
            k = rope(k, positions, cfg.rope_theta)
        k = k.transpose(1, 2)
        v = _project(p, x, "v", hkv, hd).transpose(1, 2)  # [B, Hkv, S, hd]
        if cache is None:
            out = _attend(q, k, v, causal=causal, window=window, impl=impl)
            cache = {"k": k, "v": v} if return_cache else None
        elif S == 1:
            _ring_insert(cache, k, v, cache_length)
            out = _decode_attend(q, cache, cache_length + 1, window=window)
        else:
            raise NotImplementedError("chunked append-prefill is not needed by the serving path")

    out = out.transpose(1, 2).reshape(B, S, hq * hd)
    return F.linear(out, p["wo"].to(x.dtype)), cache


def _ring_insert(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor, t: int) -> None:
    """Write one timestep at slot ``t mod C``, in place.  k_new/v_new
    ``[B, Hkv, 1, hd]``."""
    idx = t % cache["k"].shape[2]
    cache["k"][:, :, idx] = k_new[:, :, 0].to(cache["k"].dtype)
    cache["v"][:, :, idx] = v_new[:, :, 0].to(cache["v"].dtype)


def _decode_attend(q, cache, t: int, *, window: int):
    """Single-query attention over a ring cache holding ``t`` tokens.
    q ``[B, Hq, 1, hd]``.  On DTensors rank by rank, as :func:`_attend`."""
    if is_dtensor(q):
        return rank_by_rank(lambda q, k, v: _decode_attend(q, {"k": k, "v": v}, t,
                                                           window=window),
                            (q, cache["k"], cache["v"]), ((0, 1),) * 3, ((0, 1),))
    B, Hq, _, hd = q.shape
    Hkv, C = cache["k"].shape[1], cache["k"].shape[2]
    group = Hq // Hkv

    pos = _slot_positions(C, t, q.device)
    q_pos = t - 1
    valid = (pos >= 0) & (pos <= q_pos)
    if window > 0:
        valid &= pos > q_pos - window

    qf = (q.float() * hd ** -0.5).reshape(B, Hkv, group, hd)
    logits = torch.einsum("bhgd,bhcd->bhgc", qf, cache["k"].float())
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgc,bhcd->bhgd", probs, cache["v"].float())
    return out.reshape(B, Hq, 1, hd).to(q.dtype)
