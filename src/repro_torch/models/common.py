"""How to execute a model, orthogonal to what the model is (``cfg``), and
the parallelism handle models receive.  Port of ``repro.models.common``.

Under a mesh the parameters, optimizer state and batch are DTensors
(``launch/sharding.py::distribute``) and the model's functions run on them
as they are: DTensor propagates each op's sharding, as GSPMD does for the
reference's ``jit``, except where a ``local_map`` runs the attention and
the MoE dispatches rank by rank and the embedding table is gathered whole
(``attention._attend``, ``moe``, ``layers.replicated``).
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

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.device import is_dtensor
from repro_torch.launch.mesh import axis_names, axis_sizes
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
