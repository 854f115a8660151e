"""Attention, SSD and the RG-LRU with kernel | plain-version dispatch.  Port
of ``repro.kernels.ops``.

``impl`` of :func:`attention`:
- ``"auto"`` — the CUDA kernel for a CUDA tensor, the plain version
  (``kernels/ref.py``) for a CPU tensor;
- ``"ref"`` — the plain version wherever the tensor lies (for checks);
- ``"cuda"`` — the kernel (a CPU tensor raises).

``impl`` of :func:`ssd` and :func:`rglru`:
- ``"auto"`` — the CUDA kernel for a CUDA tensor, the chunked or log-depth
  plain version (``kernels/chunked.py``) for a CPU tensor, as the JAX
  package's ``auto`` takes ``chunked`` off the TPU;
- ``"ref"`` — the sequential recurrence (``kernels/ref.py``);
- ``"chunked"`` — the chunked plain version wherever the tensor lies;
- ``"cuda"`` — the kernel (a CPU tensor raises).

:func:`rglru` computes the gates in PyTorch and hands the kernel only the
recurrence on ``(a, g)``, cast to x's dtype, as the JAX package's
``ops.rglru`` does; it has no initial state (the recurrent layers' decode
step calls ``kernels.ref.rglru`` itself, as the JAX model does).

Single-query decode (``Sq == 1``) attention takes the plain version under
every impl, as the JAX package does: it is a matrix-vector product, where
the flash tiling buys nothing.  Likewise SSD with an initial state ``h0``
(the decode step) takes the recurrence, as the JAX package's decode does.
There is no other route: on a CUDA tensor ``"auto"`` and ``"cuda"`` launch
the kernel or raise.
"""

from __future__ import annotations

from repro_torch.kernels import chunked, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.ssd_scan import ssd_scan

IMPLS = ("auto", "ref", "cuda")
MIXER_IMPLS = ("auto", "ref", "chunked", "cuda")


def attention(q, k, v, *, causal=True, window=0, q_offset=0, impl="auto"):
    """GQA attention; q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D] -> [B,Hq,Sq,D]."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "ref" or q.shape[2] == 1 or (impl == "auto" and q.device.type == "cpu"):
        return ref.attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


def ssd(x, dt, a, b, c, d, *, h0=None, impl="auto", return_state=False):
    """Mamba2 SSD; x [B,S,H,P], dt [B,S,H], a [H], b/c [B,S,N], d [H] ->
    y [B,S,H,P] (and the final state [B,H,P,N] with ``return_state``)."""
    if impl not in MIXER_IMPLS:
        raise ValueError(f"impl must be one of {MIXER_IMPLS}, got {impl!r}")
    if impl == "ref" or h0 is not None:
        return ref.ssd(x, dt, a, b, c, d, h0=h0, return_state=return_state)
    if impl == "chunked" or (impl == "auto" and x.device.type == "cpu"):
        return chunked.ssd(x, dt, a, b, c, d, return_state=return_state)
    return ssd_scan(x, dt, a, b, c, d, return_state=return_state)


def rglru(x, gate_x, gate_a, a_param, *, impl="auto", return_state=False, c=8.0):
    """RG-LRU; x, gate_x, gate_a [B,S,W], a_param [W] -> y [B,S,W] in x's
    dtype (and the final state [B,W] in float32 with ``return_state``)."""
    if impl not in MIXER_IMPLS:
        raise ValueError(f"impl must be one of {MIXER_IMPLS}, got {impl!r}")
    if impl == "ref":
        return ref.rglru(x, gate_x, gate_a, a_param, return_state=return_state, c=c)
    if impl == "chunked" or (impl == "auto" and x.device.type == "cpu"):
        return chunked.rglru(x, gate_x, gate_a, a_param, return_state=return_state, c=c)
    a, g = ref.rglru_gates(x, gate_x, gate_a, a_param, c=c)
    return rglru_scan(a.to(x.dtype), g.to(x.dtype), return_state=return_state)
