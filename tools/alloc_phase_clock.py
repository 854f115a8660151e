"""Where the fused-allocate kernel spends its time on a CUDA card.

``python3 tools/alloc_phase_clock.py`` from the repo root, on a card with
nvcc.  Three read-outs, each beside the card's name and power limit:

1. Phases: builds a copy of ``src/repro_torch/kernels/csrc/alloc.cu`` with a
   block-wide barrier and a ``clock64()`` stamp by thread 0 after each
   phase (load and count, first sort, theta, renormalizer, rounding,
   bisection, full trim rounds, second sort, positions and trim, store),
   runs it once at [192, 1000] f64 and f32 and at [192, 4096] f64 (256
   chips, p = 0.5), and prints each phase's SM cycles, the median over the
   cells, and its share of the cell's total.  The barriers add a little
   time of their own; the shares are what the read-out is for.
2. Cells: the unmodified kernel's device ms a launch at [cells, 1000] f64
   for 1, 66, 132, 192, 264 and 396 cells (one CTA alone, up to three on
   every SM), and theta only (n_chips = 0) at [192, 1000]: whether one
   CTA's chain of dependent steps or the SMs' issue rate bounds a launch.
3. Threads: the source rebuilt with 128 and 512 threads a CTA in place of
   its 256, each held bit for bit against the plain version and timed at
   [192, 1000] f64 and f32.

Every time is device ms (CUDA events around launches queued behind a sleep
kernel).  The full read-out goes to ``chiprun_out/alloc_phase_clock.json``.
Without CUDA it exits with 1.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "repro_torch" / "phase_clock"

# (statement after which a stamp goes, phase it closes).  Each must occur
# exactly once in alloc.cu; the tool stops if one does not.
PHASES = (
    ("  const int m = block_sum(n_live, sred, parity);\n", "load and count"),
    ("  bitonic_sort<T, ITEMS>(key, idx, skey, sidx);\n", "first sort"),
    ("  int chips[ITEMS];\n", "theta"),
    ("  const T tot = pairwise_sum<T, ITEMS>(skey, swarp);\n", "cut and renormalizer"),
    ("  const int over_by = block_sum(sum_base, sred, parity) - n_chips;\n", "rounding"),
    ("  const int r_star = lo_r;\n", "bisection"),
    ("  const int extra_needed = K - block_sum(sum_full, sred, parity);\n", "full trim rounds"),
    ("  bitonic_sort<T, ITEMS>(key2, idx2, skey, sidx);\n", "second sort"),
    ("  const int remainder = n_chips - block_sum(sum_new, sred, parity);\n",
     "positions and trim"),
    ("  store_rows<T, ITEMS>(theta, chips, idx, skey, sidx, M, theta_out, chips_out);\n}\n",
     "leftover and store"),
)
START = "  // Descending-size order of the active jobs"
MAX_CELLS = 4096
STAMP_HEADER = f"""
__device__ long long g_stamps[{MAX_CELLS} * 16];
#define STAMP(n) do {{ __syncthreads(); \\
  if (threadIdx.x == 0) g_stamps[blockIdx.x * 16 + (n)] = clock64(); }} while (0)
"""
STAMP_READER = """
extern "C" int alloc_read_stamps(long long* host, int n) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, n * sizeof(long long)));
}
"""


def _instrumented(src: str) -> str:
    """alloc.cu with STAMP(0) at the kernel's start and STAMP(k) after the
    k-th entry of PHASES."""
    def once(text, anchor):
        if text.count(anchor) != 1:
            raise SystemExit(f"alloc_phase_clock: anchor not found once in alloc.cu: {anchor!r}")
        return text.index(anchor)

    at = once(src, START)
    src = src[:at] + "  STAMP(0);\n" + src[at:]
    for k, (anchor, _) in enumerate(PHASES, start=1):
        at = once(src, anchor)
        if anchor.endswith("}\n"):  # the kernel's last statement: stamp before its brace
            end = at + len(anchor) - 2
        else:
            end = at + len(anchor)
        src = src[:end] + f"  STAMP({k});\n" + src[end:]
    first_ns = src.index("namespace {")
    return src[:first_ns] + STAMP_HEADER + src[first_ns:] + STAMP_READER


def _with_threads(src: str, threads: int) -> str:
    pattern = r"constexpr int kThreads = \d+;"
    if len(re.findall(pattern, src)) != 1:
        raise SystemExit("alloc_phase_clock: kThreads not found once in alloc.cu")
    return re.sub(pattern, f"constexpr int kThreads = {threads};", src)


def _build(nvcc: Path, flags, source: str, name: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(source)
    subprocess.run([str(nvcc), *flags, "-o", str(so), str(cu)],
                   check=True, capture_output=True, text=True)
    from repro_torch.kernels.alloc import ARGTYPES

    lib = ctypes.CDLL(str(so))
    for fn in ("hesrpt_alloc_f64", "hesrpt_alloc_f32"):
        getattr(lib, fn).argtypes = ARGTYPES
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _launch(lib, alloc, x, p, n_chips):
    import torch

    theta = torch.empty_like(x)
    chips = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    fn = lib.hesrpt_alloc_f64 if x.dtype == torch.float64 else lib.hesrpt_alloc_f32
    err = fn(x.data_ptr(), theta.data_ptr(), chips.data_ptr(), x.shape[0], x.shape[1],
             alloc.pad_len(x.shape[1]), 1.0 / (1.0 - p), None, n_chips, 1,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"alloc kernel launch failed: cudaError {err}")
    return theta, chips


def _time_ms(fn, iters: int = 200) -> float:
    import torch

    for _ in range(3):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _sizes(cells, M, dtype, seed):
    """Pareto-like sizes with ~20% departed jobs and exact ties (the lane's
    mix, as chip_smoke.py phase 6 draws it)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.exp(torch.empty((cells, M), dtype=torch.float64, device="cuda")
                  .exponential_(generator=gen) / 1.5)
    drop = torch.rand((cells, M), generator=gen, device="cuda", dtype=torch.float64) < 0.2
    x = torch.where(drop, 0.0, x)
    k = M // 4
    x[:, :k] = x[:, k:2 * k]
    return x.to(dtype).contiguous()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("alloc_phase_clock: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import alloc

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    nvcc = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "nvcc"
    src = alloc._SRC.read_text()
    report = {"card": card, "phases": {}, "cells": {}, "threads": {}}

    # 1. Phases.
    lib = _build(nvcc, alloc.NVCC_FLAGS, _instrumented(src), "alloc_stamped")
    names = [name for _, name in PHASES]
    for label, M, dtype in (("f64 [192, 1000]", 1000, torch.float64),
                            ("f32 [192, 1000]", 1000, torch.float32),
                            ("f64 [192, 4096]", 4096, torch.float64)):
        x = _sizes(192, M, dtype, seed=6)
        for _ in range(3):
            _launch(lib, alloc, x, 0.5, 256)
        torch.cuda.synchronize()
        stamps = (ctypes.c_longlong * (192 * 16))()
        if lib.alloc_read_stamps(stamps, 192 * 16) != 0:
            raise RuntimeError("reading the stamps failed")
        rows = torch.tensor(list(stamps), dtype=torch.float64).view(192, 16)[:, :len(PHASES) + 1]
        cycles = (rows[:, 1:] - rows[:, :-1]).median(dim=0).values.tolist()
        total = sum(cycles)
        print(f"phases, {label}: {total:.0f} SM cycles a cell (median over cells)", flush=True)
        for name, c in zip(names, cycles, strict=True):
            print(f"    {name:>22s} {c:9.0f} cycles  {c / total:6.1%}")
        report["phases"][label] = {"total_cycles": total, "cycles": dict(zip(names, cycles))}

    # 2. Cells.
    for cells in (1, 66, 132, 192, 264, 396):
        x = _sizes(cells, 1000, torch.float64, seed=7)
        ms = _time_ms(lambda: alloc.hesrpt_alloc_fused(x, 0.5, 256))
        report["cells"][str(cells)] = ms
        print(f"cells: [{cells}, 1000] f64 {ms:.4f} ms", flush=True)
    x = _sizes(192, 1000, torch.float64, seed=7)
    ms = _time_ms(lambda: alloc.hesrpt_alloc_fused(x, 0.5, 0))
    report["cells"]["192, theta only"] = ms
    print(f"cells: [192, 1000] f64 theta only (n_chips = 0) {ms:.4f} ms", flush=True)

    # 3. Threads.
    for threads in (128, 256, 512):
        lib = _build(nvcc, alloc.NVCC_FLAGS, _with_threads(src, threads), f"alloc_t{threads}")
        row = {}
        for dtype in (torch.float64, torch.float32):
            x = _sizes(192, 1000, dtype, seed=8)
            got = _launch(lib, alloc, x, 0.5, 256)
            want = alloc.hesrpt_alloc_fused_ref(x, 0.5, 256)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"{threads} threads: kernel != plain version ({dtype})")
            row[str(dtype)] = _time_ms(lambda: _launch(lib, alloc, x, 0.5, 256))
        report["threads"][str(threads)] = row
        print(f"threads {threads}: [192, 1000] f64 {row['torch.float64']:.4f} ms, "
              f"f32 {row['torch.float32']:.4f} ms (bit for bit)", flush=True)

    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "alloc_phase_clock.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
