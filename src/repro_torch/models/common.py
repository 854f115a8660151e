"""How to execute a model, orthogonal to what the model is (``cfg``).

Port of ``repro.models.common.ModelOptions``.  The port runs on one device,
so there is no mesh, no ``ParallelConfig`` and no ``constrain_*``; it has no
remat option either (the serving path keeps no activations for a backward).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ModelOptions:
    attn_impl: str = "auto"  # kernels.ops.attention impl: auto | ref | cuda
    # kernels.ops.ssd and kernels.ops.rglru impl: auto | ref | chunked | cuda
    mixer_impl: str = "auto"
    activation_dtype: str = "bfloat16"

    @property
    def dtype(self) -> torch.dtype:
        """``activation_dtype`` as a torch dtype."""
        return getattr(torch, self.activation_dtype)
