"""Shared neural-net primitives: initialisers, RMSNorm, LayerNorm, RoPE,
sinusoidal positions, the SwiGLU and GeLU MLPs, embedding and logits.  Port
of ``repro.models.layers``.

Plain functions over parameter dicts of tensors.  Linear weights are stored
as PyTorch's ``nn.Linear`` does, ``[out, in]``, and applied with
``F.linear``; the JAX package stores ``[in, out]`` and computes ``x @ w``
(``models/convert.py`` transposes).  Embedding tables are ``[vocab, d]`` in
both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import is_dtensor


# ---------------------------------------------------------------- init utils
def uniform_scale_init(
    generator: torch.Generator, shape, dtype=torch.float32, scale: float | None = None
) -> torch.Tensor:
    """LeCun-ish uniform init ``U(-1, 1) * sqrt(3 / fan_in)``, on the
    generator's device.  ``fan_in = shape[-1]`` in the ``[out, in]`` layout
    (the JAX package's ``shape[-2]`` of ``[in, out]``: the same number)."""
    fan_in = shape[-1]
    scale = (3.0 / max(fan_in, 1)) ** 0.5 if scale is None else scale
    t = torch.empty(shape, dtype=dtype, device=generator.device)
    return t.uniform_(-1.0, 1.0, generator=generator).mul_(scale)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype=torch.float32):
    return uniform_scale_init(generator, (vocab, d), dtype, scale=0.02)


# --------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm reduced in float32, scaled by ``w`` (not ``1 + w``)."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5
               ) -> torch.Tensor:
    """LayerNorm reduced in float32 (mean and biased variance), scaled by
    ``w`` and shifted by ``b``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()).to(x.dtype)


# ---------------------------------------------------------------------- RoPE
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding in float32, split-halves convention (not
    interleaved).  x ``[..., S, H, D]`` (D even), positions ``[..., S]``."""
    d = x.shape[-1]
    freqs = torch.pow(theta, -torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angles = positions.float()[..., None] * freqs  # [..., S, D/2]
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, D/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings ``[n, d]`` in float32: the
    sines of every position times ``exp(-i log(10000) / max(d/2 - 1, 1))``
    in the first half, their cosines in the second (not interleaved)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)
    return sinusoidal_at(pos, d)


def sinusoidal_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """:func:`sinusoidal_positions` at the float32 positions ``pos``
    (``[...]``) -> ``[..., d]``."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)
    # the reference's float32 log, filled on the device: no host-to-device copy
    log_base = torch.full((), 10000.0, dtype=torch.float32, device=pos.device).log()
    rate = log_base / max(d // 2 - 1, 1)
    inv = torch.exp(-dim * rate)
    ang = pos.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------- MLPs
def swiglu_init(generator: torch.Generator, d: int, f: int, dtype=torch.float32):
    return {
        "gate": uniform_scale_init(generator, (f, d), dtype),
        "up": uniform_scale_init(generator, (f, d), dtype),
        "down": uniform_scale_init(generator, (d, f), dtype),
    }


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    g = F.linear(x, p["gate"].to(x.dtype))
    u = F.linear(x, p["up"].to(x.dtype))
    h = F.silu(g.float()).to(x.dtype) * u
    return F.linear(h, p["down"].to(x.dtype))


def gelu_mlp_init(generator: torch.Generator, d: int, f: int, dtype=torch.float32):
    dev = generator.device
    return {
        "w1": uniform_scale_init(generator, (f, d), dtype),
        "b1": torch.zeros(f, dtype=dtype, device=dev),
        "w2": uniform_scale_init(generator, (d, f), dtype),
        "b2": torch.zeros(d, dtype=dtype, device=dev),
    }


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """The two-matrix MLP with biases and the tanh GeLU in float32 (the
    reference's ``jax.nn.gelu``, whose default is the tanh form)."""
    h = F.linear(x, p["w1"].to(x.dtype), p["b1"].to(x.dtype))
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return F.linear(h, p["w2"].to(x.dtype), p["b2"].to(x.dtype))


# ----------------------------------------------------------- embedding/logits
def replicated(t: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole onto every rank of its mesh (its gradient
    goes back to the shards); any other tensor as it is."""
    from torch.distributed.tensor import Replicate

    if is_dtensor(t) and any(not p.is_replicate() for p in t.placements):
        return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)
    return t


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The rows of ``table`` at ``tokens``.  A sharded DTensor table is
    gathered whole first: DTensor's vocab-sharded gather fails on a table
    sharded over two mesh dims with the tokens over the data axes."""
    return F.embedding(tokens, replicated(table)).to(dtype)


def logits_from_embed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ table.T``: logits over the vocabulary.  A sharded DTensor table
    is gathered whole first, so the logits keep x's placements with the
    vocabulary whole (DTensor's gather for the cross entropy fails on
    vocab-sharded logits)."""
    return F.linear(x, replicated(table).to(x.dtype))
