"""How to execute a model, orthogonal to what the model is (``cfg``), and
the parallelism handle models receive.  Port of ``repro.models.common``.

Under a mesh the parameters, optimizer state and batch are DTensors
(``launch/sharding.py::distribute``) and the model's functions run on them
as they are: DTensor propagates each op's sharding, as GSPMD does for the
reference's ``jit``, except where a ``local_map`` runs the attention, the
SSD and RG-LRU scans and the MoE dispatches rank by rank and the embedding
table is gathered whole (:func:`rank_by_rank`, ``moe``,
``layers.replicated``).
:func:`constrain_batch` and :func:`constrain_seq` are
the reference's ``with_sharding_constraint`` calls, ``redistribute``s of a
DTensor activation with the same divisibility fallbacks; on a plain tensor,
or with ``parallel`` None, they are the identity.  Tensors the model builds
itself inside a step (positions, RoPE's tables, masks, the MoE one-hots,
``aux`` zeros) stay plain tensors: ``train/train_step.py`` runs the loss and
its gradient under ``torch.distributed.tensor.experimental
.implicit_replication()``, which takes them as replicated.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.device import is_dtensor
from repro_torch.launch.mesh import axis_names, axis_sizes, data_axes_of, model_axis_of
from repro_torch.models import moe


@dataclass(frozen=True)
class ParallelConfig:
    """Mesh handle threaded into model code that needs explicit collectives
    (the mesh MoE dispatches).  ``data_axes`` may span ("pod", "data") on the
    multi-pod mesh; ``model_axis`` is the tensor-parallel axis."""

    mesh: Any  # torch.distributed.device_mesh.DeviceMesh
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"

    def size(self, axes) -> int:
        """The number of ranks over ``axes`` (a name or a tuple of names)."""
        sizes = axis_sizes(self.mesh)
        n = 1
        for a in (axes,) if isinstance(axes, str) else axes:
            n *= sizes[a]
        return n

    def placements(self, data=None, model=None) -> tuple:
        """One placement a mesh dimension: ``data`` on the data axes,
        ``model`` on the model axis, ``Replicate()`` for a None."""
        from torch.distributed.tensor import Replicate

        out = []
        for name in axis_names(self.mesh):
            p = data if name in self.data_axes else model if name == self.model_axis else None
            out.append(Replicate() if p is None else p)
        return tuple(out)


@dataclass(frozen=True)
class ModelOptions:
    # kernels.ops impls, attention and mixers alike: auto | ref | chunked | cuda
    # (the kernels have no backward: training on the card asks for "chunked";
    # under autograd "auto" takes it on the CPU and raises on the card)
    attn_impl: str = "auto"
    mixer_impl: str = "auto"
    # dense | ragged_local on one device; ragged | dense_ep need ``parallel``
    moe_impl: str = "dense"
    remat: str = "full"  # full | none: activation checkpointing per block in training
    activation_dtype: str = "bfloat16"
    parallel: ParallelConfig | None = None
    # Sequence parallelism at block boundaries: activations (and hence the
    # per-layer tensors remat saves for backward) are sharded over the model
    # axis on the seq dim.  Cuts saved-activation memory by the TP degree at
    # the cost of boundary all-gathers where attention needs the full seq.
    seq_shard: bool = False

    def __post_init__(self):
        if self.remat not in ("full", "none"):
            raise ValueError(f"remat must be 'full' or 'none', got {self.remat!r}")
        if self.moe_impl not in moe.IMPLS + moe.MESH_IMPLS:
            raise ValueError(f"unknown moe_impl {self.moe_impl!r}")

    @property
    def dtype(self) -> torch.dtype:
        """``activation_dtype`` as a torch dtype."""
        return getattr(torch, self.activation_dtype)


def constrain_seq(x, parallel: ParallelConfig | None):
    """Shard [B, S, ...] activations: batch over data axes, seq over model."""
    if parallel is None or x.ndim < 2 or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard

    b, s = x.shape[0], x.shape[1]
    nb, nm = parallel.size(parallel.data_axes), parallel.size(parallel.model_axis)
    batch = Shard(0) if (nb > 1 and b % nb == 0) else None
    seq = Shard(1) if (nm > 1 and s % nm == 0) else None
    return x.redistribute(parallel.mesh, parallel.placements(batch, seq))


def constrain_batch(x, parallel: ParallelConfig | None):
    """Pin an activation's leading (batch) dim to the data axes, replicated
    over the model axis (the reference's constraint names the batch dim
    alone)."""
    if parallel is None or not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard

    n = parallel.size(parallel.data_axes)
    if n <= 1 or x.shape[0] % n:
        return x
    return x.redistribute(parallel.mesh, parallel.placements(Shard(0)))


def split_last(x: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Reshape the last dim of ``x`` into ``shape`` (``[..., H * P]`` ->
    ``[..., H, P]``).  A DTensor whose last dim is sharded over a mesh axis
    that does not divide ``shape[0]`` is gathered on that axis first:
    DTensor cannot split a dim sharded unevenly (24 heads over a 16-wide
    model axis), where GSPMD reshards on its own."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        sizes = x.device_mesh.shape
        pl = [Replicate() if p.is_shard(x.ndim - 1) and shape[0] % sizes[i] else p
              for i, p in enumerate(x.placements)]
        if pl != list(x.placements):
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(*x.shape[:-1], *shape)


class _SumGrad(torch.autograd.Function):
    """The identity, whose backward sums the gradient over ``groups``: an
    arg that :func:`rank_by_rank` hands whole to ranks that each work on a
    part (their batch rows, their heads) gets from each only that part's
    share of its gradient."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed import _functional_collectives as fc

        for group in ctx.groups:
            grad = fc.all_reduce(grad, "sum", group)
        return grad, None


class _DenseGrad(torch.autograd.Function):
    """The identity on a DTensor, whose backward hands the gradient on with
    its local tensor and its global strides both contiguous.  The backward
    of ``local_map``'s input redistribution (an all-gather) gives a
    contiguous local gradient the strides of the forward's input, a
    transposed view; a later view that merges the heads back (``reshape``
    after ``split_last``) is then allowed by the global strides and refused
    by the local ones (whisper-base's K and V, held whole over the model
    axis, on a mesh whose model axis divides its heads)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor

        local = grad.to_local()
        if grad.is_contiguous() and local.is_contiguous():
            return grad
        return DTensor.from_local(local.contiguous(), grad.device_mesh, grad.placements,
                                  run_check=False, shape=grad.shape,
                                  stride=torch.empty(grad.shape, device="meta").stride())


def rank_by_rank(fn, args: tuple, dims: tuple, out_dims: tuple):
    """``fn(*args)``, on DTensors as a ``local_map`` rank by rank.  ``dims``
    gives each arg's ``(batch_dim, head_dim)`` and ``out_dims`` each
    output's (either may be None; a None arg passes as it is): the batch
    dims over the mesh's data axes where they divide, the head dims over its
    model axis where every one divides, every other dim whole on every rank.
    An arg whole over an axis that splits the work has its gradient summed
    over that axis, and comes back with contiguous strides (:class:`_DenseGrad`).
    On plain tensors ``fn(*args)``."""
    lead = next(a for a in args if a is not None)
    if not is_dtensor(lead):
        return fn(*args)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = lead.device_mesh
    sizes, data_axes, model_axis = axis_sizes(mesh), data_axes_of(mesh), model_axis_of(mesh)
    n_data = math.prod(sizes[a] for a in data_axes)
    n_model = sizes.get(model_axis, 1)
    given = [(a, d) for a, d in zip(args, dims, strict=True) if a is not None]
    rows = all(a.shape[b] % n_data == 0 for a, (b, _) in given if b is not None)
    heads = all(a.shape[h] % n_model == 0 for a, (_, h) in given if h is not None)
    split = {name for name in axis_names(mesh)
             if sizes[name] > 1 and ((rows and name in data_axes)
                                     or (heads and name == model_axis))}

    def place(batch_dim, head_dim):
        return tuple(
            Shard(batch_dim) if rows and batch_dim is not None and name in data_axes
            else Shard(head_dim) if heads and head_dim is not None and name == model_axis
            else Replicate() for name in axis_names(mesh))

    in_pl = tuple(None if a is None else place(*d) for a, d in zip(args, dims, strict=True))
    sums = tuple(() if pl is None else
                 tuple(mesh.get_group(name) for name, p in zip(axis_names(mesh), pl, strict=True)
                       if name in split and not p.is_shard())
                 for pl in in_pl)

    def local(*local_args):
        return fn(*(_SumGrad.apply(a, g) if g and a.requires_grad else a
                    for a, g in zip(local_args, sums, strict=True)))

    out_pl = tuple(place(*d) for d in out_dims)
    args = tuple(_DenseGrad.apply(a) if a is not None and a.requires_grad else a for a in args)
    return local_map(local, out_placements=out_pl if len(out_pl) > 1 else list(out_pl[0]),
                     in_placements=in_pl, device_mesh=mesh, redistribute_inputs=True)(*args)
