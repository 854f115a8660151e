"""AdamW with a warmup-cosine schedule and global-norm clipping.  Port of
``repro.train.optimizer``: written on tensors in the reference's order of
operations (not ``torch.optim.AdamW``, whose arithmetic differs).

Parameters are float32 masters (model code casts them to the activation
dtype where it uses them, so gradients arrive in float32).  The moments are
float32 and shaped like the parameters.  The state is a dict ``{"m", "v",
"step"}`` (and ``"master"`` with ``keep_master``), ``step`` a 0-d int32
tensor on the parameters' device.

On a mesh the leaves are DTensors and the same code runs on them: each
leaf's sum of squares is over the whole tensor (DTensor reduces its
shards), so :func:`global_norm` is the whole tree's norm, and the in-place
update writes each rank's shards, keeping every leaf's placements.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.train.tree import leaves, tree_map


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(step: torch.Tensor, cfg: OptimizerConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac * lr``; float32."""
    step = step.to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init_opt_state(params, *, keep_master: bool = False):
    """Zero moments and step.  ``keep_master=True`` is the mixed-precision
    layout: the parameters may be stored in bf16 and their float32 master
    copy lives here, updated by AdamW and cast to the parameters' dtype
    every step."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    first = leaves(params)[0]
    out = {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
           "step": torch.zeros((), dtype=torch.int32, device=first.device)}
    if keep_master:
        out["master"] = tree_map(lambda p: p.to(torch.float32, copy=True), params)
    return out


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in float32."""
    total = 0
    for g in leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads * min(1, max_norm / norm), norm)``."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def _adamw_(master, g, m, v, lr, bc1, bc2, cfg: OptimizerConfig) -> None:
    """One leaf's AdamW step, written into its float32 ``master``, ``m`` and
    ``v``, with at most two temporaries of the leaf's size at a time (an
    expert leaf of qwen3-moe is 3.2 GB)."""
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_(((1 - cfg.b2) * g).mul_(g))
    delta = m / bc1
    delta.div_((v / bc2).sqrt_().add_(cfg.eps))
    delta.add_(cfg.weight_decay * master)
    master.sub_(delta.mul_(lr))


def apply_updates(params, grads, opt_state, cfg: OptimizerConfig, *, inplace: bool = False):
    """One AdamW step: ``(params, opt_state, {"grad_norm", "lr"})``.

    Decoupled weight decay on the float32 master; bias correction from the
    float32 step.  Returns new trees and leaves its inputs alone, unless
    ``inplace``: then the float32 ``grads`` are clipped in place and
    ``params``, ``m``, ``v`` (and ``master``) are overwritten with the same
    values and returned.  Only a caller that never reads its inputs again may
    ask for that (a training loop that drops the old state every step, as
    ``jax.jit``'s donated buffers): at full width it keeps one state, not
    two, in device memory."""
    flat_g = [g.to(torch.float32) for g in leaves(grads)]
    gnorm = global_norm(flat_g)
    if cfg.clip_norm > 0:
        scale = _clip_scale(gnorm, cfg.clip_norm)
        flat_g = [g.mul_(scale) if inplace else g * scale for g in flat_g]

    step = opt_state["step"] + 1
    lr = schedule(step, cfg)
    bc1 = 1.0 - torch.pow(cfg.b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(cfg.b2, step.to(torch.float32))

    masters = opt_state.get("master")
    flat_p = leaves(params)
    flat_pm = leaves(masters) if masters is not None else [None] * len(flat_p)
    flat_m, flat_v = leaves(opt_state["m"]), leaves(opt_state["v"])
    if not len(flat_p) == len(flat_pm) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and optimizer state differ in structure")
    new = []
    for p, pm, g, m, v in zip(flat_p, flat_pm, flat_g, flat_m, flat_v):
        src = pm if pm is not None else p
        if not inplace:
            m, v = m.clone(), v.clone()
        # The step runs on a float32 master: the leaf itself where it is
        # float32 and updated in place, else a float32 copy (a bf16 leaf
        # with no master is updated in float32 and rounded once).
        master = src if inplace and src.dtype == torch.float32 else src.to(
            torch.float32, copy=True)
        _adamw_(master, g, m, v, lr, bc1, bc2, cfg)
        if inplace:
            if master is not p:
                p.copy_(master)
            new.append((p, m, v, pm))
        else:
            new.append((master.to(p.dtype), m, v, master))

    def rebuild(tree, k):
        it = iter(o[k] for o in new)
        return tree_map(lambda _: next(it), tree)

    new_params = rebuild(params, 0)
    new_opt = {"m": rebuild(opt_state["m"], 1), "v": rebuild(opt_state["v"], 2), "step": step}
    if masters is not None:
        new_opt["master"] = rebuild(masters, 3)
    return new_params, new_opt, {"grad_norm": gnorm, "lr": lr}
