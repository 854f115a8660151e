"""Fused heSRPT allocate: ranks -> Thm-7 brackets -> whole chips, one pass.

Port of ``repro.kernels.alloc``.  Two versions of one function over a
``[cells, M]`` batch (or a single ``[M]`` row):

- ``hesrpt_alloc_fused_ref`` — plain PyTorch: one stable argsort for the
  ranks, the Thm-7 brackets, then ``_quantize_from_ranks`` (the unfused
  quantizer with its oversubscription sort replaced by rank arithmetic,
  and one stable argsort for the trim/leftover pass).
- the CUDA kernel in ``csrc/alloc.cu`` — replaces the TPU kernel
  ``repro/kernels/alloc.py::_alloc_kernel``.  One CTA per cell of at most
  256 threads, each holding several jobs; ranks and sort positions from two
  bitonic sorts of (key, index) pairs in registers, warp shuffles and
  shared memory; see the source for what bounds it and why.

``hesrpt_alloc_fused`` / ``hesrpt_theta_fused`` dispatch on where the tensor
lies: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel or raises.  The kernel equals the plain version bit for bit on the
card (theta bitwise, chips equal): the one floating-point sum, the
oversubscription renormalizer, is a fixed pairwise tree
(:func:`pairwise_sum`) on both sides, the kernel's arithmetic uses
intrinsics nvcc never contracts into a multiply-add, and
``policies.bracket_pow`` spells out the power on both sides.  ``p`` is one
float for the launch or, under a drifting ``p``, one exponent a cell that
the kernel reads from device memory.

The kernel is compiled by ``nvcc`` at first use (and again when its source
changes) into ``build/repro_torch/`` at the repo root and loaded with
``ctypes`` (``kernels/build.py``); nothing is built when this module is
imported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core.policies import hesrpt, hesrpt_theta_from_ranks
from repro_torch.core.ranking import inv_rank, ranks_from_order, size_order_desc
# NVCC_FLAGS is read from here by chip_smoke.py and tools/alloc_fmad_check.py.
from repro_torch.kernels.build import NVCC_FLAGS, KernelLibrary  # noqa: F401

#: Launches of the CUDA kernel since the last reset (``chip_smoke.py``
#: zeroes it before the main path and reads it after).
LAUNCHES = 0

#: Largest job count one CTA takes (256 threads of 16 jobs).
MAX_JOBS = 4096

_SRC = Path(__file__).resolve().parent / "csrc" / "alloc.cu"
#: Seconds the last build took (0.0 when the library was already built).
BUILD_SECONDS = 0.0


def pad_len(M: int) -> int:
    """Padded row length for ``M`` jobs: the next power of two >= max(M, 32).

    The renormalizer's pairwise tree runs over this many entries on both
    sides (zeros past ``M`` change no partial sum), and the kernel sorts
    this many (key, index) pairs a cell.
    """
    return max(32, 1 << max(M - 1, 0).bit_length())


def pairwise_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum of the last dim as the kernel's fixed tree: pad with zeros to
    :func:`pad_len`, then repeatedly add adjacent pairs.  Returns
    ``[..., 1]``."""
    P = pad_len(v.shape[-1])
    v = torch.nn.functional.pad(v, (0, P - v.shape[-1]))
    while v.shape[-1] > 1:
        v = v[..., 0::2] + v[..., 1::2]
    return v


def stable_positions(key: torch.Tensor) -> torch.Tensor:
    """Stable-argsort position of every entry of each row of ``key``."""
    return inv_rank(torch.argsort(key, dim=-1, stable=True))


# ------------------------------------------------------------ plain version
def round_chips(theta, servable, n_chips: int, min_chips: int):
    """Whole chips from shares ``theta`` once the oversubscription cut has
    chosen the ``servable`` jobs: the tail ``engine.quantize_allocation``
    and :func:`_quantize_from_ranks` share (they differ only in how they
    find ``servable``).  Returns int32 chips."""
    inf = torch.tensor(torch.inf, dtype=theta.dtype, device=theta.device)
    n_active = (theta > 0).sum(-1, keepdim=True)
    over = n_active * min_chips > n_chips
    sub = torch.where(servable, theta, 0.0)
    tot = pairwise_sum(sub)
    theta_eff = torch.where(over, torch.where(tot > 0, sub / tot, 0.0), theta)
    active = theta_eff > 0

    raw = theta_eff * n_chips
    fl = torch.floor(raw)
    frac = raw - fl
    base = torch.where(active, torch.clamp(fl, min=min_chips), 0.0).to(torch.int64)

    K = torch.clamp(base.sum(-1, keepdim=True) - n_chips, min=0)
    capj = torch.where(base > min_chips, base - min_chips, 0)
    lo = torch.zeros_like(K)
    hi = torch.full_like(K, n_chips)
    for _ in range((n_chips + 1).bit_length()):
        mid = (lo + hi) // 2
        ge = torch.minimum(capj, mid).sum(-1, keepdim=True) >= K
        lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
    r_star = lo
    full = torch.minimum(capj, torch.clamp(r_star - 1, min=0))
    extra_needed = K - full.sum(-1, keepdim=True)
    elig = capj >= torch.clamp(r_star, min=1)
    key = torch.where(
        K > 0, torch.where(elig, frac, inf), torch.where(active, -frac, inf)
    )
    pos = stable_positions(key)
    base = base - full - (elig & (pos < extra_needed)).to(base.dtype)
    remainder = n_chips - base.sum(-1, keepdim=True)
    base = base + (active & (pos < remainder)).to(base.dtype)
    return base.to(torch.int32)


def _quantize_from_ranks(theta, ranks, m, n_chips: int, *, min_chips: int = 1):
    """``engine.quantize_allocation`` given the policy's ranks: the
    oversubscription cut is rank arithmetic (theta rises strictly with rank,
    so the ``cap`` largest shares are the ``cap`` highest ranks) instead of
    a sort."""
    if n_chips <= 0 or min_chips <= 0 or theta.shape[-1] == 0:
        return torch.zeros(theta.shape, dtype=torch.int32, device=theta.device)
    servable = (theta > 0) & (ranks > m - n_chips // min_chips)
    return round_chips(theta, servable, n_chips, min_chips)


def hesrpt_alloc_fused_ref(x: torch.Tensor, p, n_chips: int, *, min_chips: int = 1):
    """Fused heSRPT theta + chips in plain PyTorch, one shared sorted order.

    Returns ``(theta, chips)``: theta is ``policies.hesrpt(x, p)`` bit for
    bit (the same ops), chips equal ``engine.quantize_allocation(theta,
    n_chips, min_chips=min_chips)``.  ``p`` is a float or one exponent a row
    (``[cells]`` or ``[cells, 1]``).
    """
    if isinstance(p, torch.Tensor) and p.ndim == 1:
        p = p[:, None]
    active = x > 0
    ranks = ranks_from_order(size_order_desc(x), active)
    m = active.sum(-1, keepdim=True)
    theta = hesrpt_theta_from_ranks(ranks, m, p, dtype=x.dtype)
    chips = _quantize_from_ranks(theta, ranks, m, n_chips, min_chips=min_chips)
    return theta, chips


# -------------------------------------------------------------- CUDA kernel
#: C signature of ``hesrpt_alloc_f64`` / ``hesrpt_alloc_f32``: x, theta,
#: chips, cells, M, P, c, c_rows (null or one float64 c a cell), n_chips,
#: min_chips, stream (also read by the tools that rebuild the source).
ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]

_LIBRARY = KernelLibrary(_SRC, {
    **{name: ARGTYPES for name in ("hesrpt_alloc_f64", "hesrpt_alloc_f32")},
    "hesrpt_alloc_occupancy": [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ],
})


def load_library() -> ctypes.CDLL:
    """The kernel's shared library, built on first use, with its C
    signatures declared."""
    global BUILD_SECONDS
    lib = _LIBRARY.load()
    BUILD_SECONDS = _LIBRARY.build_seconds
    return lib


def occupancy(M: int, dtype: torch.dtype) -> tuple[int, int]:
    """(registers a thread, resident CTAs an SM) of the kernel instance that
    takes ``M`` jobs of ``dtype`` on the current card."""
    if dtype not in (torch.float64, torch.float32) or not 0 < M <= MAX_JOBS:
        raise ValueError(f"no alloc kernel instance for M={M} {dtype}")
    registers, ctas = ctypes.c_int(0), ctypes.c_int(0)
    err = load_library().hesrpt_alloc_occupancy(
        pad_len(M), int(dtype == torch.float64), ctypes.byref(registers), ctypes.byref(ctas))
    if err != 0:
        raise RuntimeError(f"alloc kernel occupancy query failed: cudaError {err}")
    return registers.value, ctas.value


def exponent_rows(p, cells: int, device) -> torch.Tensor:
    """The float64 ``c = 1/(1-p)`` of each of ``cells`` rows from a tensor
    ``p`` of shape ``[cells]`` or ``[cells, 1]`` on ``device``, as the
    kernel reads them (computed on the device: no host sync)."""
    if p.device != device:
        raise ValueError(f"p lies on {p.device}, the sizes on {device}")
    if p.numel() != cells or p.shape not in ((cells,), (cells, 1)):
        raise ValueError(f"p must be a float, [cells] or [cells, 1]; got {tuple(p.shape)} "
                         f"for {cells} cells")
    return (1.0 / (1.0 - p.to(torch.float64))).reshape(cells).contiguous()


def _alloc_cuda(x: torch.Tensor, p, n_chips: int, min_chips: int):
    """Launch the kernel on ``x[..., M]`` (CUDA, f64 or f32, contiguous);
    ``p`` a float, or one value a cell row (``[cells]`` or ``[cells, 1]``
    on the card)."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"the alloc kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"the alloc kernel takes float64 or float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the alloc kernel takes a contiguous [cells, M] tensor")
    M = x.shape[-1]
    if M > MAX_JOBS:
        raise ValueError(f"the alloc kernel takes at most {MAX_JOBS} jobs per cell, got {M}")
    cells = x.numel() // M if M else 0
    c_rows = exponent_rows(p, cells, x.device) if isinstance(p, torch.Tensor) else None
    theta = torch.empty_like(x)
    chips = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    if x.numel() == 0:
        return theta, chips
    lib = load_library()
    fn = lib.hesrpt_alloc_f64 if x.dtype == torch.float64 else lib.hesrpt_alloc_f32
    LAUNCHES += 1
    err = fn(
        x.data_ptr(), theta.data_ptr(), chips.data_ptr(), cells, M, pad_len(M),
        0.0 if c_rows is not None else 1.0 / (1.0 - float(p)),
        None if c_rows is None else c_rows.data_ptr(), int(n_chips), int(min_chips),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"alloc kernel launch failed: cudaError {err}")
    return theta, chips


# ----------------------------------------------------------------- dispatch
def hesrpt_alloc_fused(x: torch.Tensor, p, n_chips: int, *, min_chips: int = 1):
    """Fused heSRPT allocate ``(theta, chips)`` over the last dim of ``x``.

    ``p`` is a float, or a tensor of one exponent a cell row (``[cells]`` or
    ``[cells, 1]``: a drifting ``p``, each row in its own regime).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (and
    raises on what the kernel does not take).
    """
    if x.device.type == "cpu":
        return hesrpt_alloc_fused_ref(x, p, n_chips, min_chips=min_chips)
    return _alloc_cuda(x, p, n_chips, min_chips)


def hesrpt_theta_fused(x: torch.Tensor, p) -> torch.Tensor:
    """Fused continuous-regime theta (no quantization): the kernel with
    ``n_chips = 0`` on CUDA, ``policies.hesrpt`` on the CPU; ``p`` as in
    :func:`hesrpt_alloc_fused`."""
    if x.device.type == "cpu":
        return hesrpt(x, p[:, None] if isinstance(p, torch.Tensor) and p.ndim == 1 else p)
    theta, _ = _alloc_cuda(x, p, 0, 1)
    return theta
