"""One step of the fluid event loop after the allocate: who departs or
arrives next, every job advanced to that event, the admissions.

Two versions of one function over the loop's ``[cells, M]`` rows:

- :func:`event_step_ref` — plain PyTorch: the ops ``core/engine.py::run``
  ran inline before this module, unchanged, with the drift boundary as a
  third candidate for ``dt`` (``t_next_drift``).
- the CUDA kernel in ``csrc/event_step.cu`` — replaces no TPU kernel (the
  JAX package leaves this step to XLA, which fuses it inside ``jit`` /
  ``lax.scan``): one launch a step in place of ~45 PyTorch ops, one CTA a
  row, with or without the drift boundary.

:func:`event_step` dispatches on where the tensors lie: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel or raises.  The kernel
equals the plain version bit for bit on the card: its arithmetic is
intrinsics nvcc never contracts into a multiply-add, its argmin keeps
``torch.argmin``'s order, and its admission count is the count
``torch.searchsorted`` finds in the loop's sorted arrival rows (searched
past the jobs already admitted).

The kernel writes fresh ``x``, ``x_act``, ``t``, ``i`` and ``dt`` every step,
so a recorded trace, a probe or a rule's state may keep the last ones; it
updates ``times`` in place, which only the loop holds.  It is compiled by
``nvcc`` at first use into ``build/repro_torch/`` and loaded with ``ctypes``
(``kernels/build.py``); nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels.build import KernelLibrary

#: Launches of the CUDA kernel since the last reset (``chip_smoke.py`` and
#: the card's tests zero it and read it after a run: one launch a step).
LAUNCHES = 0

_SRC = Path(__file__).resolve().parent / "csrc" / "event_step.cu"
#: Seconds the last build took (0.0 when the library was already built).
BUILD_SECONDS = 0.0


class Step(NamedTuple):
    """A step's result, each row at its next event."""

    x: torch.Tensor  # [C, M] remaining sizes
    x_act: torch.Tensor  # [C, M] the next allocate's input: sizes of the active jobs, else 0
    t: torch.Tensor  # [C, 1] clock
    i: torch.Tensor  # [C, 1] int64, jobs admitted
    times: torch.Tensor  # [C, M] completion times of the departed jobs
    dt: torch.Tensor  # [C, 1] the epoch's length (0 on no-op steps)


# ------------------------------------------------------------ plain version
def event_step_ref(x, rate, arr, t, i, tol, times, t_next_drift=None) -> Step:
    """The step in plain PyTorch from the epoch's ``rate`` ``[C, M]``.

    ``x`` ``[C, M]`` remaining sizes and ``arr`` the ascending arrival times
    of each row, ``t`` ``[C, 1]`` the clock, ``i`` ``[C, 1]`` the jobs
    admitted, ``tol`` ``[C, 1]`` the size below which a job has left,
    ``times`` the completion times so far; ``t_next_drift`` ``[C, 1]`` the
    next regime boundary under a drifting ``p``.  Ties go to the arrival,
    then the departure, then the boundary.
    """
    M = x.shape[-1]
    idx = torch.arange(M, device=x.device)
    active = (idx < i) & (x > 0)
    tt = torch.where(active & (rate > 0), x / rate, torch.inf)
    dt_dep = tt.amin(-1, keepdim=True)
    first = tt.argmin(-1, keepdim=True)  # first index on ties, as jnp.argmin
    t_next_arr = torch.where(i < M, arr.gather(-1, i.clamp(max=M - 1)), torch.inf)
    dt_arr = torch.clamp(t_next_arr - t, min=0.0)
    dt = torch.minimum(dt_dep, dt_arr)
    if t_next_drift is not None:
        dt_drift = torch.clamp(t_next_drift - t, min=0.0)
        dt = torch.minimum(dt, dt_drift)
    any_event = torch.isfinite(dt)
    dt = torch.where(any_event, dt, 0.0)
    # Landing on an arrival pins t to the exact arrival time so the
    # searchsorted admission below cannot miss it to float rounding (and
    # likewise a drift boundary); ties: arrival, departure, boundary.
    if t_next_drift is None:
        admit = any_event & (dt_arr <= dt_dep)
        take_dep = any_event & (dt_dep <= dt_arr)
        t_new = torch.where(admit, t_next_arr, t + dt)
    else:
        admit = any_event & (dt_arr <= torch.minimum(dt_dep, dt_drift))
        take_dep = any_event & (dt_dep <= torch.minimum(dt_arr, dt_drift))
        take_drift = any_event & ~admit & ~take_dep
        t_new = torch.where(admit, t_next_arr, torch.where(take_drift, t_next_drift, t + dt))
    x_new = torch.where(active, x - dt * rate, x)
    # The argmin job departs by construction when the departure is the
    # next event; float residue (~eps*x) must not keep it alive.
    departing = (idx == first) & active & take_dep
    x_new = torch.where(departing | (active & (x_new <= tol)), 0.0, x_new)
    times = torch.where(active & (x_new == 0.0), t_new, times)
    i_new = torch.maximum(i, torch.searchsorted(arr, t_new, right=True))
    x_act = torch.where((idx < i_new) & (x_new > 0), x_new, 0.0)
    return Step(x=x_new, x_act=x_act, t=t_new, i=i_new, times=times, dt=dt)


# -------------------------------------------------------------- CUDA kernel
#: C signature of ``fluid_event_step_f64`` / ``_f32``: x, rate, arr, t, i,
#: tol, t_next_drift (null without drift), times, x_out, x_act_out, t_out,
#: i_out, dt_out, cells, M, stream.
ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

_LIBRARY = KernelLibrary(_SRC, {
    name: ARGTYPES for name in ("fluid_event_step_f64", "fluid_event_step_f32")
})


def load_library() -> ctypes.CDLL:
    """The kernel's shared library, built on first use, with its C
    signatures declared."""
    global BUILD_SECONDS
    lib = _LIBRARY.load()
    BUILD_SECONDS = _LIBRARY.build_seconds
    return lib


def _check(x, rate, arr, t, i, tol, times, t_next_drift=None):
    """Raise on what the kernel does not take; returns ``rate`` contiguous
    (a rule's rate may be a view)."""
    if x.dtype not in (torch.float64, torch.float32):
        raise TypeError(f"the event-step kernel takes float64 or float32, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"the event-step kernel takes [cells, M] rows, got {tuple(x.shape)}")
    C = x.shape[0]
    for name, v, shape, dtype in (
        ("rate", rate, x.shape, x.dtype), ("arr", arr, x.shape, x.dtype),
        ("times", times, x.shape, x.dtype), ("t", t, (C, 1), x.dtype),
        ("tol", tol, (C, 1), x.dtype), ("i", i, (C, 1), torch.int64),
    ) + (() if t_next_drift is None else (("t_next_drift", t_next_drift, (C, 1), x.dtype),)):
        if v.device != x.device:
            raise ValueError(f"{name} lies on {v.device}, the sizes on {x.device}")
        if v.dtype != dtype:
            raise TypeError(f"the event-step kernel takes {name} as {dtype} beside sizes of "
                            f"{x.dtype}, got {v.dtype} (build the rule with dtype={x.dtype})")
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(v.shape)}")
    for name, v in (("x", x), ("arr", arr), ("times", times), ("t", t), ("tol", tol), ("i", i),
                    ("t_next_drift", t_next_drift)):
        if v is not None and not v.is_contiguous():
            raise ValueError(f"the event-step kernel takes a contiguous {name}")
    return rate.contiguous()


def _step_cuda(x, rate, arr, t, i, tol, times, t_next_drift=None) -> Step:
    """Launch the kernel on CUDA rows (f64 or f32, contiguous)."""
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"the event-step kernel takes CUDA tensors, got {x.device}")
    rate = _check(x, rate, arr, t, i, tol, times, t_next_drift)
    out = Step(x=torch.empty_like(x), x_act=torch.empty_like(x), t=torch.empty_like(t),
               i=torch.empty_like(i), times=times, dt=torch.empty_like(t))
    C, M = x.shape
    if x.numel() == 0:
        return out
    lib = load_library()
    fn = lib.fluid_event_step_f64 if x.dtype == torch.float64 else lib.fluid_event_step_f32
    LAUNCHES += 1
    err = fn(
        x.data_ptr(), rate.data_ptr(), arr.data_ptr(), t.data_ptr(), i.data_ptr(),
        tol.data_ptr(), None if t_next_drift is None else t_next_drift.data_ptr(),
        times.data_ptr(), out.x.data_ptr(), out.x_act.data_ptr(),
        out.t.data_ptr(), out.i.data_ptr(), out.dt.data_ptr(), C, M,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"event-step kernel launch failed: cudaError {err}")
    return out


# ----------------------------------------------------------------- dispatch
def on_kernel(x: torch.Tensor) -> bool:
    """Whether :func:`event_step` launches the kernel for rows ``x``: every
    tensor off the CPU."""
    return x.device.type != "cpu"


def event_step(x, rate, arr, t, i, tol, times, t_next_drift=None) -> Step:
    """The step (:func:`event_step_ref`'s arguments): the plain version on
    the CPU, the kernel on the card (raising on what it does not take, such
    as a rate or a boundary in another dtype than the sizes, which the plain
    version promotes), which updates ``times`` in place and returns it."""
    if not on_kernel(x):
        return event_step_ref(x, rate, arr, t, i, tol, times, t_next_drift)
    return _step_cuda(x, rate, arr, t, i, tol, times, t_next_drift)
