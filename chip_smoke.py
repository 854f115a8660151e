#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on a GPU.

``python3 chip_smoke.py`` from the repo root, on a machine with one NVIDIA
card (sm_90a, nvcc under ``CUDA_HOME``).  It builds the fused-allocate
kernel from ``src/repro_torch/kernels/csrc/alloc.cu`` and runs, in order
(any failure raises, and the exit code is not 0):

1. environment: the card's name and power limit, torch and CUDA versions,
   the kernel's build time;
2. the kernel against its plain PyTorch version on the card, bit for bit
   (theta bitwise, chips equal) over sizes with zeros and exact ties, f64
   and f32, plus the reference behaviours ROADMAP.md's Queue C records;
3. the three canonical sweep lanes at full size (24 rates x 8 seeds x 1000
   jobs, 256 chips, p = 0.5); the launch count is zeroed just before and
   read just after, and the fused lane must launch the kernel once per
   event step (2M = 2000);
4. one smoke-size lane on the same tapes on the CPU and on the card: flows
   within 1e-12 relative, chips equal at every event;
5. Thm 8: a batch heSRPT tape simulated on the card against the closed form;
6. kernel timing at the lane shape [192, 1000] (CUDA events) beside the
   plain version's and the bound.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Without CUDA, or without the repo's
sources beside it, it exits with 1 and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM, from NVIDIA's data sheet:
# HBM rate, and the float32 rate outside the tensor cores (the table has no
# float64 row; the f64 rate is lower, so this understates no bound).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _sizes(gen, shape, device, dtype):
    """Pareto-like sizes with ~20% zeros (departed jobs) and exact ties."""
    import torch

    x = torch.exp(torch.empty(shape, dtype=torch.float64, device=device)
                  .exponential_(generator=gen) / 1.5)
    drop = torch.rand(shape, generator=gen, device=device, dtype=torch.float64) < 0.2
    x = torch.where(drop, 0.0, x)
    k = shape[-1] // 4
    x[..., :k] = x[..., k:2 * k]
    return x.to(dtype).contiguous()


def _time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(3):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def phase_kernel_vs_plain(alloc, engine, device) -> float:
    """Phase 2: bitwise equality on the card; returns the max |theta| error."""
    import torch

    gen = torch.Generator(device=device).manual_seed(2)
    worst, checked = 0.0, 0
    for dtype in (torch.float64, torch.float32):
        for M in (1, 7, 60, 257, 1000, 1024):
            x = _sizes(gen, (6, M), device, dtype)
            for n_chips in (0, 16, 256):
                for min_chips in (1, 2, 4):
                    for p in (0.5, 0.3, 0.99):  # c = 2 (products), pow, subnormal brackets
                        kw = dict(min_chips=min_chips)
                        theta, chips = alloc.hesrpt_alloc_fused(x, p, n_chips, **kw)
                        theta0, chips0 = alloc.hesrpt_alloc_fused_ref(x, p, n_chips, **kw)
                        err = (theta - theta0).abs().max().item()
                        worst = max(worst, err)
                        if not (torch.equal(theta, theta0) and torch.equal(chips, chips0)):
                            raise AssertionError(
                                f"kernel != plain: {dtype} M={M} n_chips={n_chips} "
                                f"min_chips={min_chips} p={p} max|dtheta|={err} "
                                f"chip diffs={(chips != chips0).sum().item()}"
                            )
                        checked += 1
    # Queue C: ties break by index (through the kernel) ...
    theta, chips = alloc.hesrpt_alloc_fused(torch.tensor([1.0, 1.0], device=device), 0.5, 4)
    assert theta.tolist() == [0.25, 0.75] and chips.tolist() == [1, 3], (theta, chips)
    # ... f64 on the card keeps a subnormal share (the NumPy oracle's answer),
    # and a leftover chip may go to a job at the min-chips floor.
    sub = torch.tensor([0.0] * 13 + [1.0, 1.11253693e-308], dtype=torch.float64, device=device)
    assert engine.quantize_allocation(sub, 2)[-2:].tolist() == [1, 1]
    floor_case = torch.tensor([0, 0, 0.04142012, 0.9112426, 0.04733728, 0], device=device,
                              dtype=torch.float64)
    assert engine.quantize_allocation(floor_case, 24).tolist() == [0, 0, 2, 21, 1, 0]
    print(f"phase 2: kernel == plain version bit for bit on {checked} cases "
          f"(max |dtheta| = {worst}); Queue C inputs as recorded", flush=True)
    return worst


def phase_lanes(alloc, lanes, device):
    """Phase 3: the three lanes at full size; returns (results, launches)."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    alloc.LAUNCHES = 0
    results = lanes.run_lanes(device=device)
    torch.cuda.synchronize()
    launches = alloc.LAUNCHES
    by_label = dict(results)
    M = by_label["quantized-fused"].spec.n_jobs
    assert launches == 2 * M, f"fused lane launched the kernel {launches} times, not {2 * M}"
    assert lanes.fused_equals_unfused(results), "fused lane != unfused lane"
    for label, res in results:
        a = res.stats["hesrpt"]["mean_flowtime"]
        assert a.shape == (len(res.spec.rates), res.spec.n_seeds) and np.all(np.isfinite(a))
        jobs = res.spec.total_jobs()
        means = [round(v["hesrpt"], 6) for v in res.cell_means().values()]
        print(f"phase 3: {label:>15s} wall {res.wall_s:.3f} s, {jobs / res.wall_s:.0f} jobs/s, "
              f"per-rate mean flow {means}", flush=True)
    print(f"phase 3: kernel launches during the lanes: {launches} (2M = {2 * M}); "
          "fused == unfused bit for bit", flush=True)
    return results, launches


def phase_cpu_vs_cuda(lanes, sweeps, engine, policies, device):
    """Phase 4: one smoke-size lane, same tapes, CPU vs card."""
    import numpy as np
    import torch

    worst = 0.0
    for label, spec in lanes.lane_specs(smoke=True):
        x0, arr = sweeps.draw_tapes(spec, device="cpu")
        cpu = sweeps.simulate_cells(spec, x0, arr, device="cpu")["hesrpt"]["mean_flowtime"]
        gpu = sweeps.simulate_cells(spec, x0, arr, device=device)["hesrpt"]["mean_flowtime"]
        rel = float(np.max(np.abs(gpu - cpu) / np.abs(cpu)))
        assert rel <= 1e-12, f"{label}: CPU vs CUDA mean flow differ by {rel} relative"
        worst = max(worst, rel)
    spec = dict(lanes.lane_specs(smoke=True))["quantized-fused"]
    x0, arr = sweeps.draw_tapes(spec, device="cpu")
    x0, arr = x0.reshape(-1, spec.n_jobs), arr.reshape(-1, spec.n_jobs)
    rule = engine.quantized_rule(policies.hesrpt, spec.n_chips)
    cpu = engine.run(x0, arr, spec.p, rule, record=True, fused=True)
    gpu = engine.run(x0.to(device), arr.to(device), spec.p, rule, record=True, fused=True)
    assert torch.equal(cpu.trace.alloc, gpu.trace.alloc.cpu()), "chips differ CPU vs CUDA"
    print(f"phase 4: smoke lanes CPU vs CUDA on the same tapes: max rel mean-flow gap "
          f"{worst}; chips equal at every event", flush=True)
    return worst


def phase_theorem8(simulator, flowtime, policies, device) -> float:
    """Phase 5: batch heSRPT on the card against the Thm-8 closed form."""
    import torch

    gen = torch.Generator(device=device).manual_seed(8)
    x = torch.exp(torch.empty((4, 1000), dtype=torch.float64, device=device)
                  .exponential_(generator=gen) / 1.5)
    sim = simulator.simulate(x, 0.5, 256.0, policies.hesrpt, device=device)
    closed = flowtime.hesrpt_total_flowtime(torch.sort(x, -1, descending=True).values, 0.5, 256.0)
    rel = ((sim.total_flowtime - closed).abs() / closed).max().item()
    assert math.isfinite(rel) and rel <= 1e-9, f"Thm 8 gap {rel}"
    print(f"phase 5: Thm 8 closed form vs simulator on the card, 4 x 1000 jobs: "
          f"max rel gap {rel}", flush=True)
    return rel


def phase_timing(alloc, device) -> dict:
    """Phase 6: per-launch time at the lane shape [192, 1000]."""
    import torch

    cells, M, n_chips = 192, 1000, 256
    x = _sizes(torch.Generator(device=device).manual_seed(6), (cells, M), device, torch.float64)
    before = alloc.LAUNCHES
    ms = _time_ms(lambda: alloc.hesrpt_alloc_fused(x, 0.5, n_chips), 200)
    plain_ms = _time_ms(lambda: alloc.hesrpt_alloc_fused_ref(x, 0.5, n_chips), 50)
    alloc.LAUNCHES = before  # timing launches are not the main path's
    # Least time for the same function: read x once, write theta and chips
    # once; the operations of a comparison sort (2 M log2 M per cell) and
    # ~40 scalar ops per job are far below the bytes' time.
    n_bytes = cells * M * (8 + 8 + 4)
    n_ops = cells * (2 * M * math.ceil(math.log2(M)) + 40 * M)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / PEAK_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"phase 6: kernel {ms:.4f} ms/launch at [{cells}, {M}] f64, plain version "
          f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({n_bytes} bytes); no single "
          "PyTorch call computes this function, so there is no library yardstick", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a GPU", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "alloc.cu").is_file():
        print("chip_smoke: run it from a checkout of the repo (src/repro_torch missing)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import lanes
    from repro_torch.core import engine, flowtime, policies, simulator, sweeps
    from repro_torch.kernels import alloc

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    card = _card()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    alloc.load_library()
    print(f"phase 1: built {alloc._SRC.name} in {alloc.BUILD_SECONDS:.2f} s "
          f"(nvcc {' '.join(alloc.NVCC_FLAGS)})", flush=True)

    max_err = phase_kernel_vs_plain(alloc, engine, device)
    results, launches = phase_lanes(alloc, lanes, device)
    cpu_gap = phase_cpu_vs_cuda(lanes, sweeps, engine, policies, device)
    thm8_gap = phase_theorem8(simulator, flowtime, policies, device)
    timing = phase_timing(alloc, device)

    kernels = [{
        "name": "hesrpt_alloc",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/alloc.cu",
        "replaces": "src/repro/kernels/alloc.py:160",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
    }]
    detail = {
        "card": card,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_s": alloc.BUILD_SECONDS,
        "kernels": kernels,
        "timing": timing,
        "lanes": lanes.lane_records(results),
        "cpu_vs_cuda_max_rel": cpu_gap,
        "thm8_max_rel": thm8_gap,
        "total_s": time.perf_counter() - t_start,
    }
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(detail, indent=1))
    print(f"total {detail['total_s']:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
