"""Chunked and log-depth forms of attention and the recurrent mixers, in
plain PyTorch.  Port of ``repro.kernels.chunked``.

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
- ``attention``: blockwise attention with a hand-written backward (a
  ``torch.autograd.Function``: the forward saves the log-sum-exp of each
  query row, the backward recomputes the probabilities block by block), so
  neither pass holds the ``[Sq, Sk]`` score matrix.  It is the training
  path's attention: ``kernels.ops.attention`` takes it under
  ``impl="chunked"``, and under autograd with ``"auto"`` for a CPU tensor
  (the flash kernel has no backward, nor has the JAX package's Pallas
  kernel).  Port of ``_attention_fwd_impl``,
  ``_mask_block``, ``_attention_bwd_impl`` and the custom VJP.

The SSD and RG-LRU forms are differentiated by autograd, as the JAX
package differentiates its ``chunked.ssd`` and ``chunked.rglru``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import NEG_INF, rglru_gates


def _mask_block(q_pos, k_pos, Sk: int, causal: bool, window: int) -> torch.Tensor:
    """``[bq, bk]``: key j of the block is real (``< Sk``), not after query
    i (causal) and inside its window."""
    mask = (k_pos < Sk)[None, :].expand(q_pos.shape[0], -1)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return mask


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zeros after the sequence axis (dim 2) of ``[B, H, S, D]``."""
    return F.pad(t, (0, 0, 0, pad)) if pad else t


def _attention_fwd(q, k, v, *, causal, window, q_offset, scale, block_q, block_k):
    """Blockwise online-softmax attention: ``(out in q's dtype, lse)``.

    Query blocks of ``block_q`` rows against key blocks of ``block_k``;
    the query heads are viewed as ``[B, Hkv, g, ...]`` so that each group
    reads its KV head without a copy of K or V.  The running max ``m``, sum
    ``l`` and accumulator are float32 (float64 for float64 inputs); ``lse
    = m + log(l)`` per query row, ``[B, Hq, Sq]``, in the same type."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    g = Hq // Hkv
    work = torch.promote_types(q.dtype, torch.float32)
    pq, pk = -Sq % block_q, -Sk % block_k
    nq, nk = (Sq + pq) // block_q, (Sk + pk) // block_k
    q5 = (_pad_seq(q, pq).reshape(B, Hkv, g, nq, block_q, D) * scale).to(work)
    k5 = _pad_seq(k, pk).reshape(B, Hkv, nk, block_k, D)
    v5 = _pad_seq(v, pk).reshape(B, Hkv, nk, block_k, D)
    dev = q.device
    k_pos_base = torch.arange(block_k, device=dev)
    outs, lses = [], []
    for iq in range(nq):
        qb = q5[:, :, :, iq]  # [B, Hkv, g, bq, D]
        q_pos = torch.arange(block_q, device=dev) + q_offset + iq * block_q
        shape = (B, Hkv, g, block_q)
        m = torch.full(shape, NEG_INF, dtype=work, device=dev)
        lsum = torch.zeros(shape, dtype=work, device=dev)
        acc = torch.zeros(shape + (D,), dtype=work, device=dev)
        for jk in range(nk):
            logits = torch.einsum("bhgqd,bhkd->bhgqk", qb, k5[:, :, jk].to(work))
            mask = _mask_block(q_pos, k_pos_base + jk * block_k, Sk, causal, window)
            logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = corr * lsum + p.sum(dim=-1)
            acc = corr[..., None] * acc + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                                       v5[:, :, jk].to(work))
            m = m_new
        denom = torch.clamp_min(lsum, 1e-30)
        outs.append((acc / denom[..., None]).to(q.dtype))
        lses.append(m + torch.log(denom))
    out = torch.stack(outs, dim=3).reshape(B, Hq, Sq + pq, D)[:, :, :Sq]
    lse = torch.stack(lses, dim=3).reshape(B, Hq, Sq + pq)[:, :, :Sq]
    return out, lse


def _attention_bwd(q, k, v, out, lse, do, *, causal, window, q_offset, scale, block_q,
                   block_k):
    """Flash-style backward: the probabilities are recomputed block by block
    from the saved log-sum-exp, never the whole score matrix:

        p    = exp(q k^T * scale - lse)
        dv   = p^T do
        dp   = do v^T
        ds   = p * (dp - rowsum(do * out))          [softmax jacobian]
        dq   = ds k * scale ;  dk = ds^T q * scale

    Key blocks outside, query blocks inside, as the reference's ``lax.map``
    over key blocks of a ``scan`` over query blocks; dq sums the key
    blocks' parts in their order.  Returns ``(dq, dk, dv)`` in the inputs'
    dtypes."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    g = Hq // Hkv
    work = lse.dtype
    pq, pk = -Sq % block_q, -Sk % block_k
    nq, nk = (Sq + pq) // block_q, (Sk + pk) // block_k

    def q_view(t):
        return _pad_seq(t, pq).to(work).reshape(B, Hkv, g, nq, block_q, D)

    qf, dof, outf = q_view(q), q_view(do), q_view(out)
    lsef = F.pad(lse, (0, pq)).reshape(B, Hkv, g, nq, block_q)
    kf = _pad_seq(k, pk).to(work).reshape(B, Hkv, nk, block_k, D)
    vf = _pad_seq(v, pk).to(work).reshape(B, Hkv, nk, block_k, D)
    delta = (dof * outf).sum(dim=-1)  # [B, Hkv, g, nq, bq]
    dev = q.device
    q_pos_all = torch.arange(Sq + pq, device=dev).reshape(nq, block_q) + q_offset
    k_pos_all = torch.arange(Sk + pk, device=dev).reshape(nk, block_k)

    dq = [None] * nq
    dks, dvs = [], []
    for jk in range(nk):
        kb, vb = kf[:, :, jk], vf[:, :, jk]  # [B, Hkv, bk, D]
        dk_acc = torch.zeros((B, Hkv, block_k, D), dtype=work, device=dev)
        dv_acc = torch.zeros_like(dk_acc)
        for iq in range(nq):
            qb, dob = qf[:, :, :, iq], dof[:, :, :, iq]  # [B, Hkv, g, bq, D]
            logits = torch.einsum("bhgqd,bhkd->bhgqk", qb * scale, kb)
            mask = _mask_block(q_pos_all[iq], k_pos_all[jk], Sk, causal, window)
            p = torch.where(mask, torch.exp(logits - lsef[:, :, :, iq][..., None]), 0.0)
            dv_acc = dv_acc + torch.einsum("bhgqk,bhgqd->bhkd", p, dob)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", dob, vb)
            ds = p * (dp - delta[:, :, :, iq][..., None])
            dq_b = torch.einsum("bhgqk,bhkd->bhgqd", ds, kb) * scale
            dk_acc = dk_acc + torch.einsum("bhgqk,bhgqd->bhkd", ds, qb) * scale
            dq[iq] = dq_b if dq[iq] is None else dq[iq] + dq_b
        dks.append(dk_acc)
        dvs.append(dv_acc)
    dq = torch.stack(dq, dim=3).reshape(B, Hq, Sq + pq, D)[:, :, :Sq]
    dk = torch.stack(dks, dim=2).reshape(B, Hkv, Sk + pk, D)[:, :, :Sk]
    dv = torch.stack(dvs, dim=2).reshape(B, Hkv, Sk + pk, D)[:, :, :Sk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _ChunkedAttention(torch.autograd.Function):
    """``_attention_fwd`` with ``_attention_bwd`` as its gradient: forward
    saves ``(q, k, v, out, lse)``, backward recomputes P from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale, block_q, block_k):
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset, scale=scale,
                        block_q=block_q, block_k=block_k)
        out, lse = _attention_fwd(q, k, v, **ctx.opts)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _attention_bwd(q, k, v, out, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def attention(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Sk, D]
    v: torch.Tensor,  # [B, Hkv, Sk, D]
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    scale: float | None = None,
    block_q: int = 512,
    block_k: int = 1024,
) -> torch.Tensor:
    """Differentiable blockwise attention: the online-softmax forward and
    the recomputing backward, neither of which holds the score matrix.
    Logits scaled by ``D ** -0.5`` unless ``scale`` is given; query head h
    reads KV head ``h // (Hq // Hkv)``; ``q_offset`` is query row 0's
    absolute position and ``window > 0`` lets position t attend to ``[t -
    window + 1, t]``.  The blocks are clamped to the sequences and the
    sequences padded to whole blocks (padded keys are masked, padded query
    rows cut off).  Arithmetic in float32 (float64 for float64 inputs,
    where the JAX package stays in float32), the output in q's dtype."""
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"query heads {q.shape[1]} are not a multiple of KV heads "
                         f"{k.shape[1]}")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    return _ChunkedAttention.apply(q, k, v, causal, window, q_offset, scale,
                                   min(block_q, q.shape[2]), min(block_k, k.shape[2]))


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
