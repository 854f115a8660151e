"""Plain PyTorch versions of the port's attention kernel.

Port of ``repro.kernels.ref`` (attention part): slow, simple and obviously
right.  ``attention`` is the plain version of ``csrc/flash_attention.cu``:
the CPU tests hold it against the JAX package, ``kernels.ops.attention``
takes it for a CPU tensor, and ``chip_smoke.py`` holds the kernel against it
on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free


def attention_mask(
    q_len: int, kv_len: int, *, causal: bool, window: int, q_offset: int = 0,
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """``[q_len, kv_len]`` boolean mask.  ``q_offset`` is the absolute
    position of query row 0; ``window > 0`` lets position t attend to
    ``[t - window + 1, t]``."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    return mask


def attention(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Skv, D]
    v: torch.Tensor,  # [B, Hkv, Skv, D]
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA scaled-dot-product attention (logits scaled by ``D ** -0.5``):
    float32 softmax arithmetic, output in q's dtype.  Query head ``h`` reads
    KV head ``h // (Hq // Hkv)``."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} are not a multiple of KV heads {Hkv}")
    group = Hq // Hkv

    qf = q.float() * D ** -0.5
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    mask = attention_mask(Sq, k.shape[2], causal=causal, window=window, q_offset=q_offset,
                          device=q.device)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vf).to(q.dtype)
