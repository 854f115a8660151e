"""Mamba2's SSD chunked scan as a hand-written CUDA kernel for Hopper.

The kernel (``csrc/ssd_scan.cu``) replaces the TPU kernel
``repro/kernels/ssd_scan.py::_ssd_kernel``: the chunked dual form over
chunks of 64 steps.  Where the TPU kernel carries the float32 ``[P, N]``
state from chunk to chunk, the card runs four passes, three of them
parallel over chunks: each chunk's ``C B^T`` (once for all heads), each
chunk's own state, then the state recurrence over the chunks, then each
chunk's outputs from the state entering it, ``C B^T`` and x.  Its plain
version is ``kernels.chunked.ssd``;
``kernels.ops.ssd`` picks between the two by where the tensor lies.

:func:`ssd_scan` takes CUDA tensors only: x, b and c float32 or bfloat16 (all
three alike), dt and a float32 (the model's), head dim P a multiple of 16,
state size N at most 128.  x, b and c may be strided views whose last dim
is unit-stride (the model hands it slices of one projection), dt any view.
It raises on anything else; it never falls back to the plain version.  The
kernel is compiled at first use (``kernels/build.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary

#: Calls that launched the CUDA kernel since the last reset, one per
#: :func:`ssd_scan` call (each call is four CUDA launches, one per pass;
#: ``chip_smoke.py`` zeroes it before the main path and reads it after).
LAUNCHES = 0

#: Steps per chunk in the kernel (``csrc/ssd_scan.cu``'s ``Q``).
CHUNK = 64
MAX_STATE = 128

#: Seconds the last build took (0.0 when the library was already built).
BUILD_SECONDS = 0.0

_SRC = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
_LIBRARY = KernelLibrary(_SRC, {
    name: [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_void_p]
    for name in ("ssd_scan_f32", "ssd_scan_bf16")
})


def load_library() -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    global BUILD_SECONDS
    lib = _LIBRARY.load()
    BUILD_SECONDS = _LIBRARY.build_seconds
    return lib


def _check(x, dt, a, b, c, d):
    tensors = (("x", x, 4), ("dt", dt, 3), ("a", a, 1), ("b", b, 3), ("c", c, 3), ("d", d, 1))
    for name, t, rank in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"the SSD kernel takes CUDA tensors, got {name} on {t.device}")
        if t.dim() != rank:
            raise ValueError(f"the SSD kernel takes a rank-{rank} {name}, got {tuple(t.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16) or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"the SSD kernel takes x, b, c in float32 or bfloat16 alike, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"the SSD kernel takes dt and a in float32, got {dt.dtype}, {a.dtype}")
    B, S, H, P = x.shape
    N = b.shape[-1]
    if dt.shape != (B, S, H) or a.shape != (H,) or d.shape != (H,) or b.shape != (B, S, N) \
            or c.shape != b.shape:
        raise ValueError(f"shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}, c {tuple(c.shape)}, d {tuple(d.shape)} do not fit")
    if S < 1 or P % 16 or not 1 <= N <= MAX_STATE:
        raise ValueError(f"the SSD kernel takes S >= 1, P a multiple of 16 and N <= "
                         f"{MAX_STATE}, got S={S}, P={P}, N={N}")


def ssd_scan(
    x: torch.Tensor,  # [B, S, H, P]
    dt: torch.Tensor,  # [B, S, H]
    a: torch.Tensor,  # [H]
    b: torch.Tensor,  # [B, S, N]
    c: torch.Tensor,  # [B, S, N]
    d: torch.Tensor,  # [H]
    *,
    return_state: bool = False,
):
    """SSD by the CUDA kernel, then the skip ``y += d * x`` in x's dtype (as
    the TPU wrapper adds it).  Returns y ``[B, S, H, P]`` in x's dtype and,
    with ``return_state``, the final state ``[B, H, P, N]`` in float32."""
    global LAUNCHES
    _check(x, dt, a, b, c, d)
    B, S, H, P = x.shape
    N = b.shape[-1]
    x, b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, b, c))
    a = a.contiguous()
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    # Scratch of the passes: each chunk's state, laid out [N, P]; exp(s_Q)
    # of each chunk; each chunk's C B^T, transposed.
    n_chunks = -(-S // CHUNK)
    chunk_states = torch.empty((B, n_chunks, H, N, P), dtype=torch.float32, device=x.device)
    decay = torch.empty((B, n_chunks, H), dtype=torch.float32, device=x.device)
    cb = torch.empty((B, n_chunks, CHUNK, CHUNK), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 10)(*x.stride()[:3], *dt.stride(), *b.stride()[:2],
                                       *c.stride()[:2])
    lib = load_library()
    fn = lib.ssd_scan_f32 if x.dtype == torch.float32 else lib.ssd_scan_bf16
    with torch.cuda.device(x.device):
        LAUNCHES += 1
        err = fn(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            y.data_ptr(), state.data_ptr(), chunk_states.data_ptr(), decay.data_ptr(),
            cb.data_ptr(), B, S, H, P, N, strides,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"SSD kernel launch failed: cudaError {err}")
    y.addcmul_(d.to(x.dtype)[None, None, :, None], x)
    return (y, state) if return_state else y
