"""Where the time goes in the port's sweep lanes on a CUDA card.

``python3 tools/torch_lane_profile.py [--smoke] [--lane LABEL]`` from the
repo root runs each canonical lane (``repro_torch.lanes``), or only the one
named (e.g. ``quantized-fused``), on the card after a warm-up:
once plain, for its wall time, and once under ``torch.profiler`` for the
device time by kernel.  It prints, per lane, the wall time, the summed
device time, the device's idle share (1 - device time / plain wall; also
against the profiled wall) and the kernels that take the most device
time, and writes the whole read-out to
``chiprun_out/torch_lane_profile.json``.  The card's name and power limit
head the output.  Without CUDA it exits with 1.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _profile_lane(spec, device) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.sweeps import run_sweep

    run_sweep(spec, device=device)  # warm-up: kernel build, allocator
    plain = run_sweep(spec, device=device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_sweep(spec, device=device)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    # Kernel rows only: an operator's row repeats its kernels' device time.
    rows = [
        {"name": evt.key, "count": evt.count, "device_us": evt.self_device_time_total}
        for evt in prof.key_averages()
        if getattr(evt, "device_type", None) == DeviceType.CUDA
    ]
    rows.sort(key=lambda r: -r["device_us"])
    device_s = sum(r["device_us"] for r in rows) * 1e-6
    return {
        "wall_s": plain.wall_s,
        "profiled_wall_s": prof_wall,
        "device_s": device_s if rows else None,  # None: the trace saw no kernel
        # Against the unprofiled wall (the lane as users run it) and against
        # the profiled one (inflated by the profiler's own host cost).
        "idle_share": 1.0 - device_s / plain.wall_s if rows else None,
        "profiled_idle_share": 1.0 - device_s / prof_wall if rows else None,
        "steps": 2 * spec.n_jobs,
        "top": rows[:12],
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_lane_profile: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import lanes

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    out = {"card": card, "torch": torch.__version__, "lanes": {}}
    only = sys.argv[sys.argv.index("--lane") + 1] if "--lane" in sys.argv else None
    for label, spec in lanes.lane_specs(smoke="--smoke" in sys.argv):
        if only is not None and label != only:
            continue
        r = _profile_lane(spec, device)
        out["lanes"][label] = r
        print(f"{label:>15s}: wall {r['wall_s']} s ({r['wall_s'] / r['steps'] * 1e3} ms/step), "
              f"device {r['device_s']} s, idle share {r['idle_share']} "
              f"(profiled: wall {r['profiled_wall_s']} s, idle share "
              f"{r['profiled_idle_share']})", flush=True)
        for row in r["top"][:8]:
            print(f"    {row['device_us'] / 1e3:10.3f} ms  x{row['count']:<7d} {row['name']}")
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "torch_lane_profile.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
