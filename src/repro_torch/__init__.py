"""heSRPT scheduling and the dense decoder in PyTorch, with CUDA kernels.

The PyTorch/CUDA port of the JAX package ``repro``, two paths so far:

- the heSRPT sweep path (scenario tape -> Thm-3 event loop -> Thm-7 shares
  -> whole chips -> mean flow time) over a leading ``[cells, M]`` batch,
  in float64: ``core/``, ``lanes.py``, the fused allocate ``kernels/alloc.py``;
- serving the dense decoder family (batched prefill, greedy decode over KV
  caches): ``configs/``, ``models/``, ``train/serve_step.py``,
  ``launch/serve.py``, with attention prefill as the flash kernel
  ``kernels/flash_attention.py``.

Layout mirrors ``src/repro/``.  Every entry point takes ``device=`` and
defaults to ``"cuda"``; without a card it raises instead of falling back
(pass ``device="cpu"`` for the plain-PyTorch path).
"""

from repro_torch.device import DTYPE, resolve_device

__all__ = ["DTYPE", "resolve_device"]
