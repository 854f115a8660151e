"""The benchmark's yardstick: the card's peaks and the bytes a piece of work
must move, counted from shapes alone, so a later change to the program can
neither move nor redefine them.

The HBM bandwidth of one NVIDIA H100 SXM (NVIDIA's data sheet, at the 700 W
limit), as the port's ``launch/roofline.py`` has it; the scheduler's work is
bound by bytes, not operations.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12

DTYPE_BYTES = {"float64": 8, "float32": 4}
CHIP_BYTES = 4  # the allocate writes whole chips as int32


def alloc_launch_bytes(cells: int, jobs: int, dtype: str, quantized: bool) -> int:
    """One fused allocate over ``[cells, jobs]``: the sizes read once, the
    shares written once, and the whole chips written once when it rounds."""
    per_job = 2 * DTYPE_BYTES[dtype] + (CHIP_BYTES if quantized else 0)
    return cells * jobs * per_job


def event_step_bytes(cells: int, jobs: int, dtype: str, quantized: bool) -> int:
    """The least an event step moves over ``[cells, jobs]``: the remaining
    sizes read and written once, and the allocation (whole chips, or the
    float shares) written once."""
    alloc = CHIP_BYTES if quantized else DTYPE_BYTES[dtype]
    return cells * jobs * (2 * DTYPE_BYTES[dtype] + alloc)


def roofline_share(bytes_moved: float, seconds: float) -> float | None:
    """Percent of the HBM bound that ``bytes_moved`` in ``seconds`` reaches."""
    if bytes_moved <= 0 or seconds <= 0:
        return None
    return 100.0 * bytes_moved / HBM_BYTES_PER_S / seconds
