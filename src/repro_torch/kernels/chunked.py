"""Log-depth forms of the recurrent mixers, in plain PyTorch.  Port of
``repro.kernels.chunked.ssd`` and ``.rglru``.

- ``ssd``: Mamba2's SSD in its chunked dual form.  It is the algorithm the
  CUDA kernel (``csrc/ssd_scan.cu``) computes, and the kernel's plain
  version: ``kernels.ops.ssd`` takes it for a CPU tensor (and under
  ``impl="chunked"``), the CPU tests hold it against the JAX package, and
  ``chip_smoke.py`` holds the kernel against it on the card.
- ``rglru``: the RG-LRU with its recurrence as a scan of log2(S) passes.
  ``kernels.ops.rglru`` takes it for a CPU tensor (and under
  ``impl="chunked"``), as the JAX package's ``auto`` takes its
  ``associative_scan`` off the TPU; ``chip_smoke.py`` also holds
  ``csrc/rglru_scan.cu`` against it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import rglru_gates


def ssd(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H]
    a: torch.Tensor,  # [H]
    b: torch.Tensor,  # [B, S, N]
    c: torch.Tensor,  # [B, S, N]
    d: torch.Tensor,  # [H]
    *,
    h0: torch.Tensor | None = None,  # [B, H, P, N]
    block: int = 128,
    return_state: bool = False,
):
    """Chunked SSD: within a chunk of ``block`` steps, with
    s = inclusive cumsum(a * dt),

        y_t = sum_{u <= t} (c_t . b_u) exp(s_t - s_u) dt_u x_u + exp(s_t) c_t h_prev
        h   = exp(s_Q) h_prev + sum_u exp(s_Q - s_u) dt_u x_u b_u^T

    and only the state passes from chunk to chunk.  The sequence is padded
    to whole chunks with zeros (dt = 0: no output, no state change).  The
    decay is exponentiated only inside the lower triangle (above it the
    exponent is positive and may overflow).  float32 throughout (float64
    for float64 inputs: ``chip_smoke.py`` measures the kernel's error
    against that); y in x's dtype, the final state in float32 (float64)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    block = min(block, S)
    pad = -S % block
    work = torch.promote_types(x.dtype, torch.float32)
    xf = F.pad(x.to(work), (0, 0, 0, 0, 0, pad))
    dtf = F.pad(dt.to(work), (0, 0, 0, pad))
    bf = F.pad(b.to(work), (0, 0, 0, pad))
    cf = F.pad(c.to(work), (0, 0, 0, pad))
    af = a.to(work)
    h = torch.zeros((B, H, P, N), dtype=work, device=x.device) if h0 is None else h0.to(work)
    ar = torch.arange(block, device=x.device)
    lower = (ar[:, None] >= ar[None, :])[None, :, :, None]  # [1, Q, Q, 1]

    ys = []
    for start in range(0, S + pad, block):
        sl = slice(start, start + block)
        xq, dtq, bq, cq = xf[:, sl], dtf[:, sl], bf[:, sl], cf[:, sl]
        s = torch.cumsum(af * dtq, dim=1)  # [B, Q, H], inclusive
        # intra-chunk dual form
        cb = torch.einsum("bqn,bkn->bqk", cq, bq)  # [B, Q, Q]
        expo = torch.where(lower, s[:, :, None, :] - s[:, None, :, :], float("-inf"))
        scores = cb[..., None] * torch.exp(expo) * dtq[:, None, :, :]  # [B, Q, Q, H]
        y = torch.einsum("bqkh,bkhp->bqhp", scores, xq)
        # inter-chunk
        y = y + torch.exp(s)[..., None] * torch.einsum("bqn,bhpn->bqhp", cq, h)
        # state update
        total = s[:, -1, :]  # [B, H]
        w = torch.exp(total[:, None, :] - s) * dtq  # [B, Q, H]
        h = torch.exp(total)[..., None, None] * h + torch.einsum(
            "bqhp,bqn->bhpn", xq * w[..., None], bq
        )
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :S]
    y = (y + d.to(work)[None, None, :, None] * x.to(work)).to(x.dtype)
    return (y, h) if return_state else y


def linear_scan(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """All h_t of ``h_t = a_t h_{t-1} + g_t`` (h_{-1} = 0) along dim 1, as
    a Hillis-Steele scan: pass k combines each step with the one 2^k before
    it, ``(a1, g1) then (a2, g2) -> (a1 a2, g1 a2 + g2)``; log2(S) passes of
    out-of-place elementwise work."""
    S = a.shape[1]
    shift = 1
    while shift < S:
        a_hi, g_hi = a[:, shift:], g[:, shift:]
        g = torch.cat([g[:, :shift], torch.addcmul(g_hi, g[:, :-shift], a_hi)], dim=1)
        a = torch.cat([a[:, :shift], a_hi * a[:, :-shift]], dim=1)
        shift *= 2
    return g


def rglru(
    x: torch.Tensor,  # [B, S, W]
    gate_x: torch.Tensor,
    gate_a: torch.Tensor,
    a_param: torch.Tensor,  # [W]
    *,
    h0: torch.Tensor | None = None,  # [B, W]
    return_state: bool = False,
    c: float = 8.0,
):
    """RG-LRU by a log-depth scan (``kernels.ref.rglru`` computes the same
    steps one by one).  An initial state is folded into step 0:
    ``g_0' = a_0 h0 + g_0``.  float32 state arithmetic, y in x's dtype; with
    ``return_state`` the last h ``[B, W]`` in float32, in memory of its own
    (a view would keep all of h alive in a decode cache)."""
    a, g = rglru_gates(x, gate_x, gate_a, a_param, c=c)
    if h0 is not None:
        g = torch.cat([(g[:, 0] + a[:, 0] * h0.float())[:, None], g[:, 1:]], dim=1)
    h = linear_scan(a, g)
    out = h.to(x.dtype)
    return (out, h[:, -1].clone()) if return_state else out
