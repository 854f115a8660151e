"""Attention with kernel | plain-version dispatch.  Port of the attention
part of ``repro.kernels.ops``.

``impl``:
- ``"auto"`` — the CUDA kernel for a CUDA tensor, the plain version
  (``kernels/ref.py``) for a CPU tensor;
- ``"ref"`` — the plain version wherever the tensor lies (for checks);
- ``"cuda"`` — the kernel (a CPU tensor raises).

Single-query decode (``Sq == 1``) takes the plain version under every impl,
as the JAX package does: it is a matrix-vector product, where the flash
tiling buys nothing.  There is no other route: on a CUDA tensor ``"auto"``
and ``"cuda"`` launch the kernel or raise.
"""

from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention

IMPLS = ("auto", "ref", "cuda")


def attention(q, k, v, *, causal=True, window=0, q_offset=0, impl="auto"):
    """GQA attention; q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D] -> [B,Hq,Sq,D]."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "ref" or q.shape[2] == 1 or (impl == "auto" and q.device.type == "cpu"):
        return ref.attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
