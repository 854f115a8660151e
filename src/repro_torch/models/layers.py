"""Shared neural-net primitives: initialisers, RMSNorm, RoPE, SwiGLU,
embedding and logits.  Port of ``repro.models.layers``.

Plain functions over parameter dicts of tensors.  Linear weights are stored
as PyTorch's ``nn.Linear`` does, ``[out, in]``, and applied with
``F.linear``; the JAX package stores ``[in, out]`` and computes ``x @ w``
(``models/convert.py`` transposes).  Embedding tables are ``[vocab, d]`` in
both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


# ----------------------------------------------------------- embedding/logits
def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return F.embedding(tokens, table).to(dtype)


def logits_from_embed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x @ table.T``: logits over the vocabulary."""
    return F.linear(x, table.to(x.dtype))
