"""heSRPT scheduling in PyTorch, with the fused allocate as a CUDA kernel.

The PyTorch/CUDA port of the JAX package ``repro``: the heSRPT sweep path
(scenario tape -> Thm-3 event loop -> Thm-7 shares -> whole chips -> mean
flow time) over a leading ``[cells, M]`` batch.  Layout mirrors
``src/repro/``: ``core/`` holds the scheduler, ``kernels/alloc.py`` the
fused allocate and its plain PyTorch version, ``lanes.py`` the three
canonical sweep lanes.

Every entry point takes ``device=`` and defaults to ``"cuda"``; without a
card it raises instead of falling back (pass ``device="cpu"`` for the
plain-PyTorch path).  The scheduler runs in float64 throughout.
"""

from repro_torch.device import DTYPE, resolve_device

__all__ = ["DTYPE", "resolve_device"]
