"""Fractional allocation -> whole chips, one job set at a time.

Port of ``repro.sched.quantize``.  The paper's theta* treats the N servers
as continuously divisible (heSRPT Thm 7); a cluster hands out whole chips
and prefers power-of-two slices.  :func:`quantize_allocation` is
largest-remainder apportionment with a minimum-chips floor (the
largest-theta jobs are served and the rest queued with 0 when every job
cannot hold ``min_chips``); :func:`snap_to_slices` restricts every job to
slice sizes {1, 2, 4, 8, ...}.

Both run the event loop's batched ``core.engine.quantize_allocation`` /
``snap_to_slices`` on one row, on the input's device, so the per-event
path and the engine round with one piece of code.  Those two equal the
reference's NumPy oracles, its tie-breaks and its two quirks included
(ROADMAP.md Queue C).  The one difference is how an oversubscribed row's
servable shares are renormalized: by the fixed pairwise tree of the port's
fused allocate (``kernels/alloc.py``, ``csrc/alloc.cu``), where NumPy and
``quantize_allocation_jax`` take ``sum``.  The two totals can differ in the
last ulp, which moves a chip only where a renormalized share times N is an
integer in exact arithmetic (Queue C shows such an input).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.engine import DEFAULT_SLICES
from repro_torch.device import DTYPE, resolve_device


def _row(v, dtype, device):
    """``(row [1, M] on the device, back)``: ``back`` turns a ``[1, M]``
    int32 result into the caller's form, a numpy int64 array for a numpy
    (or list) input, a tensor on the input's device for a tensor."""
    if isinstance(v, torch.Tensor):
        return v.reshape(1, -1).to(dtype), lambda out: out.reshape(v.shape)
    dev = resolve_device("cuda" if device is None else device)
    row = torch.as_tensor(np.asarray(v, dtype=np.float64), device=dev).reshape(1, -1)
    return row.to(dtype), lambda out: out.reshape(-1).cpu().numpy().astype(np.int64)


def quantize_allocation(theta, n_chips: int, *, min_chips: int = 1, device=None):
    """Largest-remainder rounding of ``theta * n_chips`` (theta sums to
    <= 1) for a 1-D ``theta``.  A tensor is rounded on its own device and
    comes back an int32 tensor; an array on ``device`` (default ``"cuda"``)
    and comes back an int64 array, as the NumPy oracle's."""
    row, back = _row(theta, DTYPE, device)
    return back(engine.quantize_allocation(row, n_chips, min_chips=min_chips))


def snap_to_slices(chips, n_chips: int, *, slices=DEFAULT_SLICES, device=None):
    """Snap each job's count down to the largest slice <= count, then hand
    leftovers (largest lost allocation first) to jobs whose next slice step
    fits; 1-D, tensors and arrays as :func:`quantize_allocation`."""
    row, back = _row(chips, torch.int64, device)
    return back(engine.snap_to_slices(row, n_chips, slices=tuple(slices)))


__all__ = ["DEFAULT_SLICES", "quantize_allocation", "snap_to_slices"]
