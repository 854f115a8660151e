"""Gradient compression for the data-parallel all-reduce, with error
feedback.  Port of ``repro.train.compression``.

Two schemes, each keeping a per-rank ERROR FEEDBACK state: the residual of
the compression is added back into the next step's gradient, which keeps
SGD / Adam convergence intact (Karimireddy et al., 2019).

- ``int8``: per-leaf symmetric quantization, ``scale = max(max|g|, 1e-12)
  / 127`` and ``q = clip(round(g / scale), -127, 127)`` as int8
  (``torch.round`` rounds half to even, as ``jnp.round`` does).  The
  payloads are summed as int32, the scales in float32, and the reduced
  gradient is ``(sum q) * mean(scale) / n``: the reference's mean-scale
  reduction, not ``sum(q scale) / n`` (ROADMAP.md Queue C).
- ``topk``: keep the entries of each leaf whose magnitude is at least its
  ``k``-th largest, ``k = max(1, int(numel * k_frac))`` (ties at the
  threshold are all kept), and sum the masked dense leaf.

The reference's ``psum`` over a ``shard_map`` axis is a
``torch.distributed.all_reduce`` over ``group``; ``group=None`` is one
device, with no collective.  Used by the elastic data-parallel trainer
(``sched/elastic.py``).

The arithmetic is the reference's as it runs, under ``jit`` (its trainer
and its tests jit every reducer), where XLA rewrites two things that eager
JAX computes as written: a division by a constant becomes a product with
its float32 reciprocal (``/ 127`` and ``/ n``: :func:`recip32`), and the
int8 residual ``g - q * scale`` is one fused multiply-add, rounded once
(:func:`_residual_int8`, exact in float32 on every backend).  So the port
equals the jitted reference bit for bit on the CPU, and the card the CPU
(ROADMAP.md Queue C).

The reducers own their inputs, as the step that calls them does: each
float32 gradient leaf is overwritten with its mean and each error leaf with
the new error (a gradient of another dtype is reduced in a float32 copy).
At full width that keeps one gradient tree and one error tree in device
memory, not two of each.  A caller that still needs its inputs passes
clones.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.train.tree import leaves, tree_map


def init_error_state(params):
    """float32 zeros shaped like each leaf of ``params``, on its device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def recip32(n) -> float:
    """``1 / n`` rounded to float32: jitted XLA computes ``x / n`` for a
    constant ``n`` as ``x * (1 / n)``.  Exact, so ``x / n``, for a power of
    two."""
    return float(np.float32(1.0) / np.float32(n))


def _quant_int8(g: torch.Tensor):
    """``(q, scale)``: the int8 payload of float32 ``g`` and its 0-d scale."""
    scale = torch.clamp_min(torch.amax(torch.abs(g)), 1e-12) * recip32(127)
    q = torch.div(g, scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _residual_int8(out: torch.Tensor, g: torch.Tensor, q: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """``out = g - q * scale`` rounded once, as a fused multiply-add gives
    it, whether or not the backend fuses.  ``scale`` splits into a high part
    of 12 significant bits and an exact low rest, so that each product with
    the 7-bit ``q`` is exact in float32; ``g - q * high`` is exact too
    (``g`` lies within ``scale / 2`` of ``q * scale``: Sterbenz), which
    leaves one rounding, the last."""
    high = (scale.view(torch.int32) & -4096).view(torch.float32)
    torch.addcmul(g, q, high, value=-1, out=out)
    return out.addcmul_(q, scale - high, value=-1)


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks, in place (``t`` itself without one)."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _with_error(g: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """``float32(g) + e``, written into ``g`` where ``g`` is float32."""
    if g.dtype == torch.float32:
        return g.add_(e)
    return g.to(torch.float32) + e


def _per_leaf(leaf, grads, err) -> tuple:
    """``leaf(g, e) -> (mean, new_e)`` over the trees' leaves, in flattening
    order; returns ``(mean_grads, new_err)`` shaped like ``grads``."""
    pairs = [leaf(g, e) for g, e in zip(leaves(grads), leaves(err), strict=True)]
    means, errs = iter([m for m, _ in pairs]), iter([e for _, e in pairs])
    return tree_map(lambda _: next(means), grads), tree_map(lambda _: next(errs), grads)


def compress_psum_int8(grads, err, group=None):
    """Per-leaf int8 quantize (+ error feedback) -> all_reduce of the int32
    payloads and of the scales -> dequantize with the mean scale.  Returns
    ``(mean_grads, new_err)``."""
    inv_n = recip32(_size(group))

    def leaf(g, e):
        g = _with_error(g, e)
        q, scale = _quant_int8(g)
        new_e = _residual_int8(e, g, q, scale)
        tot = _sum(q.to(torch.int32), group)
        del q
        # every rank has its own scale; the payloads are scaled by their mean
        mean_scale = _sum(scale, group) * inv_n
        return g.copy_(tot).mul_(mean_scale).mul_(inv_n), new_e

    return _per_leaf(leaf, grads, err)


def compress_psum_topk(grads, err, group=None, k_frac: float = 0.1):
    """Magnitude top-k sparsification (+ error feedback) -> all_reduce of the
    masked dense leaves.  Returns ``(mean_grads, new_err)``.  Traffic model:
    only ``k_frac`` of the values need cross the link; numerically the
    masked tree is summed, as the reference does."""
    inv_n = recip32(_size(group))

    def leaf(g, e):
        g = _with_error(g, e)
        k = max(1, int(g.numel() * k_frac))
        thresh = torch.topk(torch.abs(g).reshape(-1), k).values[-1]
        keep = torch.abs(g) >= thresh
        new_e = e.copy_(g)
        kept = g.mul_(keep)
        del keep
        new_e.sub_(kept)
        return _sum(kept, group).mul_(inv_n), new_e

    return _per_leaf(leaf, grads, err)


def plain_psum(grads, group=None):
    """Each leaf's mean over ``group``'s ranks, written into the leaf."""
    inv_n = recip32(_size(group))
    return tree_map(lambda g: _sum(g, group).mul_(inv_n), grads)


def make_grad_reducer(scheme: str | None, group=None, k_frac: float = 0.1):
    """Returns ``reduce(grads, err) -> (mean_grads, new_err)`` over ``group``
    (``None``: one device).  An unknown scheme raises ``ValueError``."""
    if scheme is None or scheme == "none":
        return lambda g, e: (plain_psum(g, group), e)
    if scheme == "int8":
        return lambda g, e: compress_psum_int8(g, e, group)
    if scheme == "topk":
        return lambda g, e: compress_psum_topk(g, e, group, k_frac)
    raise ValueError(f"unknown compression scheme {scheme!r}")
