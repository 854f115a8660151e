"""Mamba2's SSD in its chunked dual form, in plain PyTorch.  Port of
``repro.kernels.chunked.ssd``.

It is the algorithm the CUDA kernel (``csrc/ssd_scan.cu``) computes, and
the kernel's plain version: ``kernels.ops.ssd`` takes it for a CPU tensor
(and under ``impl="chunked"``), the CPU tests hold it against the JAX
package, and ``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
