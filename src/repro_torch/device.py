"""Device resolution and the scheduler's dtype.

The port runs on the card unless the caller asks for the CPU: an entry
point called without ``device=`` on a host with no CUDA raises, it never
falls back quietly (a CPU number must not pass for a card number).
"""

from __future__ import annotations

import torch

#: The scheduler path runs in float64, as the JAX reference does under
#: ``jax_enable_x64`` (torch's own default dtype is float32).
DTYPE = torch.float64


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default, but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain-PyTorch path"
        )
    return dev


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor: a tensor placed on a device mesh."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def as_tensor(a, device: torch.device, dtype: torch.dtype = DTYPE) -> torch.Tensor:
    """``a`` (array-like or tensor) as a ``dtype`` tensor on ``device``."""
    return torch.as_tensor(a, dtype=dtype, device=device)
