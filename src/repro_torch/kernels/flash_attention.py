"""Flash-attention forward as a hand-written CUDA kernel for Hopper.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro/kernels/flash_attention.py::_flash_kernel``: causal attention with a
query offset, a sliding window and GQA/MQA, by tiles with an online softmax
in float32.  Its plain PyTorch version is ``kernels.ref.attention``;
``kernels.ops.attention`` picks between the two by where the tensor lies.

:func:`flash_attention` takes CUDA tensors only, float32 or bfloat16, any
head dim up to 256, in any strides whose last dim is unit-stride (the model
hands it transposed views of its projections; the output takes ``q``'s
strides, so the model's transpose back is free).  The kernel is built for
head dims 16, 32, 64, 128, 160 and 256; any other D is zero-padded to the
next of them and the output sliced back (zero columns change neither q . k
nor the output's real columns; the logits keep the true D's scale), so a
padded D still runs the kernel.  It raises on anything else; it never falls
back to the plain version.  The kernel is compiled at first use
(``kernels/build.py``).

Two designs share the source, one per type.  float32 runs on the CUDA cores,
bound at 0.37 ms by the 67 TFLOP/s float32 rate at the phi4-mini prefill
shape [4, 24, 1000, 128]: 64 query rows a CTA, 4 x 4 logits and 4 x D / 16
outputs a thread in registers, every operand a 16-byte shared-memory load
that feeds 4 FMAs or more, and K/V tiles copied by ``cp.async`` into a ring
of half-tile slots ahead of the products (``F32Tile`` in the source).  Its
copies read 16-byte rows in place (:func:`f32_copies_in_place`); the model's
transposed views are such, and any other float32 input is copied contiguous
first and counted in :data:`ALIGN_COPIES`.  bfloat16 is bound 15x lower, at
0.025 ms by the 989 TFLOP/s tensor cores, so its kernel runs both products as
``wgmma`` on 128 query rows a CTA (``TcTile`` in the source), with K/V tiles
brought by TMA into a ring of shared-memory stages ahead of the products, and
P rounded to bf16 in registers between the two products.  TMA reads a tensor
in place only when it is 16-byte aligned (:func:`copies_in_place`); the
model's transposed views are, and any other bf16 input is copied contiguous
first and counted in :data:`ALIGN_COPIES`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import KernelLibrary

#: Launches of the CUDA kernel since the last reset (``chip_smoke.py``
#: zeroes it before the main path and reads it after).
LAUNCHES = 0

#: Copies of inputs that the kernel's tile copies cannot read in place
#: (:func:`copies_in_place` for bf16, :func:`f32_copies_in_place` for
#: float32), since the last reset (the model's path makes none).
ALIGN_COPIES = 0

#: Head dims the kernel is built for; any other D up to the last is padded.
HEAD_DIMS = (16, 32, 64, 128, 160, 256)

#: Seconds the last build took (0.0 when the library was already built).
BUILD_SECONDS = 0.0

_SRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_LIBRARY = KernelLibrary(_SRC, {
    name: [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    for name in ("flash_attention_f32", "flash_attention_bf16")
} | {
    "flash_attention_f32_occupancy": [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ],
})


def load_library() -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    global BUILD_SECONDS
    lib = _LIBRARY.load()
    BUILD_SECONDS = _LIBRARY.build_seconds
    return lib


def padded_head_dim(d: int) -> int:
    """The kernel instance that takes head dim ``d``: the least of
    :data:`HEAD_DIMS` at or above it; raises above the largest."""
    for inst in HEAD_DIMS:
        if d <= inst:
            return inst
    raise ValueError(f"the flash kernel takes head dim at most {HEAD_DIMS[-1]}, got {d}")


def occupancy(d: int) -> tuple[int, int]:
    """(registers a thread, resident CTAs an SM) of the float32 kernel's
    instance for head dim ``d`` (one of :data:`HEAD_DIMS`) on the current
    card."""
    if d not in HEAD_DIMS:
        raise ValueError(f"no float32 flash instance for head dim {d}")
    registers, ctas = ctypes.c_int(0), ctypes.c_int(0)
    err = load_library().flash_attention_f32_occupancy(d, ctypes.byref(registers),
                                                       ctypes.byref(ctas))
    if err != 0:
        raise RuntimeError(f"flash kernel occupancy query failed: cudaError {err}")
    return registers.value, ctas.value


def copies_in_place(t: torch.Tensor) -> bool:
    """Whether the bf16 kernel's tile copies (TMA) can read ``t`` where it
    lies: the start 16-byte aligned and the batch, head and sequence
    strides positive multiples of 8 elements (16 bytes); a dim of size 1 is
    never stepped, so its stride does not matter."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(n == 1 or (s > 0 and s % 8 == 0)
                    for s, n in zip(t.stride()[:3], t.shape[:3])))


def _in_place_or_copy(t: torch.Tensor) -> torch.Tensor:
    global ALIGN_COPIES
    if copies_in_place(t):
        return t
    ALIGN_COPIES += 1
    return t.clone(memory_format=torch.contiguous_format)  # a new, aligned allocation


def f32_copies_in_place(t: torch.Tensor) -> bool:
    """Whether the float32 kernel's 16-byte copies can read ``t`` where it
    lies: the head dim unit-stride, the start 16-byte aligned and the batch,
    head and sequence strides multiples of 4 elements (16 bytes); a dim of
    size 1 is never stepped, so its stride does not matter."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(n == 1 or s % 4 == 0 for s, n in zip(t.stride()[:3], t.shape[:3])))


def _f32_in_place_or_copy(t: torch.Tensor) -> torch.Tensor:
    global ALIGN_COPIES
    if f32_copies_in_place(t):
        return t
    ALIGN_COPIES += 1
    return t.clone(memory_format=torch.contiguous_format)  # a new, aligned allocation


def flash_attention(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Skv, D]
    v: torch.Tensor,  # [B, Hkv, Skv, D]
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention by the CUDA kernel, logits scaled by ``scale`` (default
    ``D ** -0.5`` of q's own D, also where D is zero-padded for the
    kernel); the output is in q's dtype and, for a D the kernel is built
    for, q's layout."""
    global LAUNCHES
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"the flash kernel takes CUDA tensors, got {name} on {t.device}")
        if t.dim() != 4:
            raise ValueError(f"the flash kernel takes [B, H, S, D] tensors, got {name} {t.shape}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash kernel takes float32 or bfloat16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, Skv, D) or v.shape != k.shape or Hq % Hkv:
        raise ValueError(f"shapes q {q.shape}, k {k.shape}, v {v.shape} do not fit GQA")
    scale = D ** -0.5 if scale is None else scale
    D_kernel = padded_head_dim(D)
    if D_kernel != D:
        q, k, v = (F.pad(t, (0, D_kernel - D)) for t in (q, k, v))
    if q.dtype == torch.bfloat16:
        q, k, v = (_in_place_or_copy(t) for t in (q, k, v))
    else:
        q, k, v = (_f32_in_place_or_copy(t) for t in (q, k, v))
    o = torch.empty_like(q)  # dense q keeps its strides, so o's layout is q's
    if o.numel() == 0:
        return o[..., :D]
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3])
    )
    lib = load_library()
    fn = lib.flash_attention_f32 if q.dtype == torch.float32 else lib.flash_attention_bf16
    with torch.cuda.device(q.device):
        LAUNCHES += 1
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Hq, Hkv, Sq, Skv, D_kernel, strides, scale, int(causal), int(window),
            int(q_offset), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    return o if D_kernel == D else o[..., :D]
