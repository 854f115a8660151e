"""How to execute a model, orthogonal to what the model is (``cfg``).

Port of ``repro.models.common.ModelOptions``.  The port runs on one device,
so there is no mesh, no ``ParallelConfig``, no ``constrain_*`` and no
sequence sharding.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models import moe


@dataclass(frozen=True)
class ModelOptions:
    # kernels.ops impls, attention and mixers alike: auto | ref | chunked | cuda
    # (the kernels have no backward: training on the card asks for "chunked";
    # under autograd "auto" takes it on the CPU and raises on the card)
    attn_impl: str = "auto"
    mixer_impl: str = "auto"
    moe_impl: str = "dense"  # dense | ragged_local (models/moe.py; ragged, dense_ep need a mesh)
    remat: str = "full"  # full | none: activation checkpointing per block in training
    activation_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.remat not in ("full", "none"):
            raise ValueError(f"remat must be 'full' or 'none', got {self.remat!r}")
        if self.moe_impl not in moe.IMPLS + moe.MESH_IMPLS:
            raise ValueError(f"unknown moe_impl {self.moe_impl!r}")

    @property
    def dtype(self) -> torch.dtype:
        """``activation_dtype`` as a torch dtype."""
        return getattr(torch, self.activation_dtype)
