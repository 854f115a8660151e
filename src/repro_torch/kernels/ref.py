"""Plain PyTorch oracles: slow, simple and obviously right.

Port of ``repro.kernels.ref`` (attention and SSD):

- ``attention`` is the plain version of ``csrc/flash_attention.cu``: the CPU
  tests hold it against the JAX package, ``kernels.ops.attention`` takes it
  for a CPU tensor, and ``chip_smoke.py`` holds the kernel against it on the
  card;
- ``ssd`` is the exact sequential recurrence of Mamba2's SSD: the oracle the
  chunked form (``kernels/chunked.py``) and the kernel
  (``csrc/ssd_scan.cu``) are held against, and the single decode step
  (``kernels.ops.ssd`` takes it whenever an initial state is given).
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


def ssd(
    x: torch.Tensor,  # [B, S, H, P]  inputs per SSM head
    dt: torch.Tensor,  # [B, S, H]    softplus'd timestep (positive)
    a: torch.Tensor,  # [H]           negative decay rate (A = -exp(a_log))
    b: torch.Tensor,  # [B, S, N]     input matrix (one group)
    c: torch.Tensor,  # [B, S, N]     output matrix
    d: torch.Tensor,  # [H]           skip connection
    *,
    h0: torch.Tensor | None = None,  # [B, H, P, N] initial state
    return_state: bool = False,
):
    """Mamba2 SSD as the sequential recurrence

        h_t = exp(a * dt_t) * h_{t-1} + dt_t * (x_t b_t^T)
        y_t = h_t c_t + d * x_t

    float32 state arithmetic, y in x's dtype; with ``return_state`` also the
    final state ``[B, H, P, N]`` in float32."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    af = a.float()
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    ys = []
    for t in range(S):
        decay = torch.exp(af[None, :] * dtf[:, t])  # [B, H]
        upd = torch.einsum("bhp,bn->bhpn", xf[:, t] * dtf[:, t, :, None], bf[:, t])
        h = decay[..., None, None] * h + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h, cf[:, t]))
    y = (torch.stack(ys, dim=1) + d.float()[None, None, :, None] * xf).to(x.dtype)
    return (y, h) if return_state else y
