"""The training step and its init.  Port of ``repro.train.train_step``.

``make_train_step(model, tc)`` returns ``(params, opt_state, batch) ->
(params, opt_state, metrics)``.  PyTorch runs eagerly, so where the JAX
package hands the step to ``jax.jit``, the port calls it as it is; the
gradient is ``torch.autograd.grad`` of ``model.loss_fn`` with respect to a
detached alias of every parameter.  With ``tc.microbatches > 1`` the batch
is split along its first axis and the microbatches run one after another,
so one microbatch's activations are live at a time (the reference's
``lax.scan``): their gradients are summed in float32 and divided by their
count, and the loss returned is their mean.  The step's two halves run
under program spans (``repro_torch/spans.py``), ``train_step.loss_and_grad``
and ``train_step.apply_updates``, which a profiler trace reads (a flag read
when no profiler runs).

Under a mesh the parameters, optimizer state and batch are DTensors
(``launch/sharding.py::distribute``).  The step then runs under
``implicit_replication()`` (the tensors the model builds itself join as
replicated), each gradient is redistributed to its parameter's placements
(a partial sum becomes the parameter's shards), so the moments and the
in-place AdamW keep every leaf's placements, and the metrics come back as
plain tensors, whole on every rank.
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass, field

import torch

from repro_torch.device import is_dtensor
from repro_torch.spans import span
from repro_torch.train.optimizer import OptimizerConfig, apply_updates, init_opt_state
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.tree import leaves, tree_map

__all__ = ["TrainConfig", "make_decode_step", "make_init_fn", "make_prefill_step",
           "make_train_step"]


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    # Cast float32 parameters of rank >= 2 to bf16 before use, inside the
    # differentiated function: the gradient flows through the cast, so the
    # masters and moments stay float32.
    cast_params_bf16: bool = False


def _split_micro(batch: dict, n: int) -> list[dict]:
    """``n`` microbatches of ``batch``, each ``1/n`` of its first axis.  A
    DTensor is gathered, split, and each microbatch placed as the batch was
    (DTensor cannot split a dim sharded over more ranks than the split's
    outer size)."""
    def r(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"global batch {b} not divisible by {n} microbatches")
        if is_dtensor(x):
            from torch.distributed.tensor import Replicate

            whole = x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
            parts = whole.reshape(n, b // n, *x.shape[1:])
            return [parts[i].redistribute(x.device_mesh, x.placements) for i in range(n)]
        return x.reshape(n, b // n, *x.shape[1:])

    split = {k: r(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _on_mesh(tree) -> bool:
    """Whether ``tree``'s leaves are DTensors."""
    return any(is_dtensor(t) for t in leaves(tree))


def _plain(t):
    """A DTensor's whole value as a plain tensor (a collective); else ``t``."""
    return t.full_tensor() if is_dtensor(t) else t


def _like_param(g, p):
    """The gradient ``g`` placed as its parameter ``p``."""
    if is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(model, tc: TrainConfig, *, donate: bool = False):
    """``(params, opt_state, batch) -> (params, opt_state, {"loss", ...,
    "grad_norm", "lr"})``; the batch's arrays go to the model's device.
    ``donate=True`` hands the step its inputs, as ``jax.jit``'s donated
    buffers: the optimizer then updates the parameters and moments in place
    (``apply_updates(inplace=True)``), and the caller must not read the
    trees it passed in again."""
    n_micro = tc.microbatches

    def loss_with_cast(params, mb):
        if tc.cast_params_bf16:
            params = tree_map(lambda x: x.to(torch.bfloat16)
                              if x.dtype == torch.float32 and x.dim() >= 2 else x, params)
        return model.loss_fn(params, mb)

    def value_and_grad(params, mb):
        alias = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, metrics = loss_with_cast(alias, mb)
        flat = leaves(alias)
        grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
        it = iter(_like_param(g, p) for g, p in zip(grads, flat))
        return loss.detach(), metrics, tree_map(lambda _: next(it), alias)

    def loss_and_grad(params, batch):
        if n_micro == 1:
            loss, metrics, grads = value_and_grad(params, batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            grads, loss = None, torch.zeros((), dtype=torch.float32, device=model.device)
            for mb in _split_micro(batch, n_micro):
                mb_loss, _, g = value_and_grad(params, mb)
                g = tree_map(lambda t: t.to(torch.float32), g)
                grads = g if grads is None else tree_map(lambda a, b: a + b, grads, g)
                loss = loss + mb_loss
                del g
            grads = tree_map(lambda g: g / n_micro, grads)
            loss = loss / n_micro
            metrics = {}
        return loss, metrics, grads

    def train_step(params, opt_state, batch):
        batch = {k: v if is_dtensor(v) else torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        mesh = _on_mesh(params)
        if mesh:
            from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication() if mesh else nullcontext():
            with span("train_step.loss_and_grad"):
                loss, metrics, grads = loss_and_grad(params, batch)
            with span("train_step.apply_updates"):
                params, opt_state, opt_metrics = apply_updates(params, grads, opt_state,
                                                               tc.optimizer, inplace=donate)
        metrics = {"loss": loss, **metrics, **opt_metrics}
        return params, opt_state, {k: _plain(v) for k, v in metrics.items()}

    return train_step


def make_init_fn(model, tc: TrainConfig):
    """``(generator) -> (params, opt_state)``."""

    def init_fn(generator: torch.Generator):
        params = model.init(generator)
        return params, init_opt_state(params)

    return init_fn
