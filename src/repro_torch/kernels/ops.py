"""Attention, SSD and the RG-LRU with kernel | plain-version dispatch.  Port
of ``repro.kernels.ops``.

``impl`` of :func:`attention`:
- ``"auto"`` — the CUDA kernel for a CUDA tensor, the plain version
  (``kernels/ref.py``) for a CPU tensor;
- ``"ref"`` — the plain version wherever the tensor lies (for checks);
- ``"chunked"`` — the blockwise attention with its hand-written backward
  (``kernels/chunked.py``) wherever the tensor lies;
- ``"cuda"`` — the kernel (a CPU tensor raises).

``impl`` of :func:`ssd` and :func:`rglru`:
- ``"auto"`` — the CUDA kernel for a CUDA tensor, the chunked or log-depth
  plain version (``kernels/chunked.py``) for a CPU tensor, as the JAX
  package's ``auto`` takes ``chunked`` off the TPU;
- ``"ref"`` — the sequential recurrence (``kernels/ref.py``);
- ``"chunked"`` — the chunked plain version wherever the tensor lies;
- ``"cuda"`` — the kernel (a CPU tensor raises).

Under autograd (grad mode on and an input that requires grad) neither the
port's kernels nor the JAX package's Pallas kernels have a backward, and the
JAX package trains through its ``chunked`` paths.  So there ``"auto"`` takes
the chunked forms of all three for a CPU tensor, where it takes a plain
version anyway; for a CUDA tensor ``"auto"`` and ``"cuda"`` raise, naming
``"chunked"``: a caller that trains on the card asks for ``"chunked"``.

:func:`rglru` computes the gates in PyTorch and hands the kernel only the
recurrence on ``(a, g)``, cast to x's dtype, as the JAX package's
``ops.rglru`` does; it has no initial state (the recurrent layers' decode
step calls ``kernels.ref.rglru`` itself, as the JAX model does).

Single-query decode (``Sq == 1``) attention takes the plain version under
every impl, as the JAX package does: it is a matrix-vector product, where
the flash tiling buys nothing.  Likewise SSD with an initial state ``h0``
(the decode step) takes the recurrence, as the JAX package's decode does.
There is no other route: on a CUDA tensor without autograd ``"auto"`` and
``"cuda"`` launch the kernel or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import chunked, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.ssd_scan import ssd_scan

IMPLS = ("auto", "ref", "chunked", "cuda")


def _resolve(impl: str, cpu_impl: str, *tensors) -> str:
    """``impl`` with ``"auto"`` made concrete: for a CPU tensor ``"chunked"``
    under autograd, else ``cpu_impl``; for a CUDA tensor ``"cuda"``.  The
    kernel under autograd raises."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    if impl == "auto":
        if tensors[0].device.type == "cpu":
            return "chunked" if grad else cpu_impl
        impl = "cuda"
    if impl == "cuda" and grad:
        raise RuntimeError('the CUDA kernels have no backward: differentiate through '
                           'impl="chunked"')
    return impl


def attention(q, k, v, *, causal=True, window=0, q_offset=0, impl="auto"):
    """GQA attention; q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D] -> [B,Hq,Sq,D]."""
    impl = _resolve(impl, "ref", q, k, v)
    if impl == "ref" or q.shape[2] == 1:
        return ref.attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if impl == "chunked":
        return chunked.attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)


def ssd(x, dt, a, b, c, d, *, h0=None, impl="auto", return_state=False):
    """Mamba2 SSD; x [B,S,H,P], dt [B,S,H], a [H], b/c [B,S,N], d [H] ->
    y [B,S,H,P] (and the final state [B,H,P,N] with ``return_state``)."""
    impl = _resolve(impl, "chunked", x, dt, a, b, c, d)
    if impl == "ref" or h0 is not None:
        return ref.ssd(x, dt, a, b, c, d, h0=h0, return_state=return_state)
    if impl == "chunked":
        return chunked.ssd(x, dt, a, b, c, d, return_state=return_state)
    return ssd_scan(x, dt, a, b, c, d, return_state=return_state)


def rglru(x, gate_x, gate_a, a_param, *, impl="auto", return_state=False, c=8.0):
    """RG-LRU; x, gate_x, gate_a [B,S,W], a_param [W] -> y [B,S,W] in x's
    dtype (and the final state [B,W] in float32 with ``return_state``)."""
    impl = _resolve(impl, "chunked", x, gate_x, gate_a, a_param)
    if impl == "ref":
        return ref.rglru(x, gate_x, gate_a, a_param, return_state=return_state, c=c)
    if impl == "chunked":
        return chunked.rglru(x, gate_x, gate_a, a_param, return_state=return_state, c=c)
    a, g = ref.rglru_gates(x, gate_x, gate_a, a_param, c=c)
    return rglru_scan(a.to(x.dtype), g.to(x.dtype), return_state=return_state)
