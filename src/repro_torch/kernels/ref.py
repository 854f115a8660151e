"""Plain PyTorch oracles: slow, simple and obviously right.

Port of ``repro.kernels.ref`` (attention, SSD and the RG-LRU):

- ``attention`` is the plain version of ``csrc/flash_attention.cu``: the CPU
  tests hold it against the JAX package, ``kernels.ops.attention`` takes it
  for a CPU tensor, and ``chip_smoke.py`` holds the kernel against it on the
  card;
- ``ssd`` is the exact sequential recurrence of Mamba2's SSD: the oracle the
  chunked form (``kernels/chunked.py``) and the kernel
  (``csrc/ssd_scan.cu``) are held against, and the single decode step
  (``kernels.ops.ssd`` takes it whenever an initial state is given);
- ``rglru`` is the RG-LRU oracle: its gates (``rglru_gates``, which
  ``kernels.ops.rglru`` and ``kernels/chunked.py`` share) and the
  first-order recurrence ``linear_recurrence``, which is the plain version of
  ``csrc/rglru_scan.cu`` (the same steps in the same order) and, with an
  initial state, the recurrent layers' decode step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
    scale: float | None = None,
) -> torch.Tensor:
    """GQA scaled-dot-product attention (logits scaled by ``scale``, default
    ``D ** -0.5``): float32 softmax arithmetic, output in q's dtype.  Query
    head ``h`` reads KV head ``h // (Hq // Hkv)``."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"query heads {Hq} are not a multiple of KV heads {Hkv}")
    group = Hq // Hkv

    qf = q.float() * (D ** -0.5 if scale is None else scale)
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


def rglru_gates(
    x: torch.Tensor,  # [B, S, W]  gated input
    gate_x: torch.Tensor,  # [B, S, W]  input-gate pre-activation
    gate_a: torch.Tensor,  # [B, S, W]  recurrence-gate pre-activation
    a_param: torch.Tensor,  # [W]        learnable Lambda (pre-softplus)
    *,
    c: float = 8.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU's per-step decay and input of ``h_t = a_t h_{t-1} + g_t``,
    in float32:

        r_t = sigmoid(gate_a_t),  i_t = sigmoid(gate_x_t)
        log_a_t = -c * softplus(a_param) * r_t,  a_t = exp(log_a_t)
        g_t = sqrt(1 - a_t^2) * i_t * x_t

    with ``1 - a_t^2`` as ``-expm1(2 log_a_t)`` (exact near a_t = 1)."""
    r = torch.sigmoid(gate_a.float())
    i = torch.sigmoid(gate_x.float())
    log_a = -c * F.softplus(a_param.float())[None, None, :] * r
    return torch.exp(log_a), i * x.float() * torch.sqrt(-torch.expm1(2.0 * log_a))


def linear_recurrence(
    a: torch.Tensor,  # [B, S, W] per-step decay
    g: torch.Tensor,  # [B, S, W] per-step input
    *,
    h0: torch.Tensor | None = None,  # [B, W]
    return_state: bool = False,
):
    """``h_t = a_t * h_{t-1} + g_t`` step by step, float32 carry (a product
    then a sum, each rounded, as ``csrc/rglru_scan.cu`` computes it); y in
    a's dtype, and with ``return_state`` the final carry ``[B, W]`` in
    float32."""
    B, S, W = a.shape
    h = (torch.zeros((B, W), dtype=torch.float32, device=a.device) if h0 is None
         else h0.float())
    ys = []
    for t in range(S):
        h = a[:, t].float() * h + g[:, t].float()
        ys.append(h)
    y = torch.stack(ys, dim=1).to(a.dtype)
    return (y, h) if return_state else y


def rglru(
    x: torch.Tensor,  # [B, S, W]
    gate_x: torch.Tensor,  # [B, S, W]
    gate_a: torch.Tensor,  # [B, S, W]
    a_param: torch.Tensor,  # [W]
    *,
    h0: torch.Tensor | None = None,  # [B, W]
    return_state: bool = False,
    c: float = 8.0,
):
    """RG-LRU oracle (RecurrentGemma): the gates of :func:`rglru_gates`,
    then the recurrence from ``h0`` (zeros when None).  float32 state
    arithmetic, y in x's dtype; with ``return_state`` also the final state
    ``[B, W]`` in float32."""
    a, g = rglru_gates(x, gate_x, gate_a, a_param, c=c)
    y, h = linear_recurrence(a, g, h0=h0, return_state=True)
    y = y.to(x.dtype)
    return (y, h) if return_state else y
