"""The RG-LRU's linear recurrence as a hand-written CUDA kernel for Hopper.

The kernel (``csrc/rglru_scan.cu``) replaces the TPU kernel
``repro/kernels/rglru_scan.py::_rglru_kernel``: ``h_t = a_t h_{t-1} + g_t``
elementwise over the width, in one pass over a and g with a float32 carry.
Its plain PyTorch version is ``kernels.ref.linear_recurrence`` (the same
steps, bit for bit); ``kernels.ops.rglru`` computes the gates and picks
between the kernel and ``kernels.chunked.rglru`` by where the tensor lies.

:func:`rglru_scan` takes contiguous CUDA tensors a and g of one shape
``[B, S, W]`` and one type, float32 or bfloat16.  It raises on anything
else; it never falls back to the plain version.  The kernel is compiled at
first use (``kernels/build.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary

#: Launches of the CUDA kernel since the last reset (``chip_smoke.py``
#: zeroes it before the main path and reads it after).
LAUNCHES = 0

#: Seconds the last build took (0.0 when the library was already built).
BUILD_SECONDS = 0.0

_SRC = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"
_LIBRARY = KernelLibrary(_SRC, {
    name: [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    for name in ("rglru_scan_f32", "rglru_scan_bf16")
})


def load_library() -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    global BUILD_SECONDS
    lib = _LIBRARY.load()
    BUILD_SECONDS = _LIBRARY.build_seconds
    return lib


def _check(a: torch.Tensor, g: torch.Tensor) -> None:
    for name, t in (("a", a), ("g", g)):
        if t.device.type != "cuda":
            raise ValueError(f"the RG-LRU kernel takes CUDA tensors, got {name} on {t.device}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"the RG-LRU kernel takes a contiguous [B, S, W] {name}, got "
                             f"shape {tuple(t.shape)}, strides {t.stride()}")
    if a.dtype not in (torch.float32, torch.bfloat16) or g.dtype != a.dtype:
        raise TypeError(f"the RG-LRU kernel takes a and g in float32 or bfloat16 alike, got "
                        f"{a.dtype}, {g.dtype}")
    if g.shape != a.shape or min(a.shape) < 1 or a.shape[0] > 65535:
        raise ValueError(f"shapes a {tuple(a.shape)}, g {tuple(g.shape)} do not fit (B, S, W "
                         "alike, each at least 1, B at most 65535)")


def rglru_scan(a: torch.Tensor, g: torch.Tensor, *, return_state: bool = False):
    """``h_t = a_t h_{t-1} + g_t`` from ``h = 0`` by the CUDA kernel.  Returns y
    ``[B, S, W]`` in a's dtype and, with ``return_state``, ``y[:, -1]`` in
    float32 (as the TPU wrapper returns it), in memory of its own."""
    global LAUNCHES
    _check(a, g)
    B, S, W = a.shape
    y = torch.empty_like(a)
    lib = load_library()
    fn = lib.rglru_scan_f32 if a.dtype == torch.float32 else lib.rglru_scan_bf16
    with torch.cuda.device(a.device):
        LAUNCHES += 1
        err = fn(a.data_ptr(), g.data_ptr(), y.data_ptr(), B, S, W,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"RG-LRU kernel launch failed: cudaError {err}")
    # A copy: a view of y's last step would keep all of y alive in a cache.
    return (y, y[:, -1].to(torch.float32, copy=True)) if return_state else y
