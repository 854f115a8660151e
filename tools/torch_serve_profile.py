"""Where the time goes when the port serves a model on a CUDA card.

``python3 tools/torch_serve_profile.py [--arch ARCH] [--smoke]`` from the
repo root builds ``ARCH`` (phi4-mini-3.8b by default, mamba2-130m or
recurrentgemma-9b) at full width (float32 weights drawn on the card from a seed; ``--smoke`` takes
the smoke config), warms up with one short ``generate``, then:

1. times ``launch/serve.py::generate`` at batch 4 x the arch's prompt (1000
   tokens for phi4-mini, 30000 for mamba2, 4096 for recurrentgemma) + 32
   greedy tokens, twice
   (prefill and decode wall, synchronised);
2. profiles one prefill and 8 decode steps under ``torch.profiler``, and
   reports for each the summed device time, the device's idle share
   (1 - device time / unprofiled wall of the same work) and the kernels that
   take the most device time.

The card's name and power limit head the output; the whole read-out goes
to ``torch_serve_profile_<arch>.json`` in the output directory that
``chip_smoke.py`` writes to.  Without CUDA it exits with 1.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BATCH, GEN, PROFILED_STEPS = 4, 32, 8
# chip_smoke.py's serve phases
PROMPTS = {"phi4-mini-3.8b": 1000, "mamba2-130m": 30000, "recurrentgemma-9b": 4096}


def _kernel_rows(prof) -> list[dict]:
    from torch.autograd import DeviceType

    # Kernel rows only: an operator's row repeats its kernels' device time.
    rows = [
        {"name": evt.key, "count": evt.count, "device_us": evt.self_device_time_total}
        for evt in prof.key_averages()
        if getattr(evt, "device_type", None) == DeviceType.CUDA
    ]
    return sorted(rows, key=lambda r: -r["device_us"])


def _profiled(fn, wall_s: float) -> dict:
    """Run ``fn`` under the profiler; idle share against ``wall_s``, the
    unprofiled wall of the same work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    rows = _kernel_rows(prof)
    device_s = sum(r["device_us"] for r in rows) * 1e-6
    return {
        "wall_s": wall_s,
        "profiled_wall_s": prof_wall,
        "device_s": device_s if rows else None,  # None: the trace saw no kernel
        "idle_share": 1.0 - device_s / wall_s if rows else None,
        "top": rows[:12],
    }


def main(argv=None) -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="phi4-mini-3.8b", choices=sorted(PROMPTS))
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_serve_profile: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.launch.serve import generate
    from repro_torch.models.common import ModelOptions
    from repro_torch.models.model import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    arch, prompt = args.arch, PROMPTS[args.arch]
    cfg = smoke_config(arch) if args.smoke else get_config(arch)
    model = build_model(cfg, ModelOptions(activation_dtype="float32"), device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (BATCH, prompt))
    batch = {"tokens": torch.as_tensor(tokens, device=device)}

    generate(model, params, batch, gen_len=2)  # warm-up: kernel build, cuBLAS, allocator
    runs = []
    for _ in range(2):
        t = {}
        generate(model, params, batch, gen_len=GEN, timings=t)
        runs.append(t)
        print(f"generate: prefill {t['prefill_s']} s, decode {t['decode_s']} s "
              f"({BATCH * GEN / t['decode_s']} tok/s, {t['decode_s'] / GEN * 1e3} ms/step)",
              flush=True)

    logits, caches = model.prefill_fn(params, batch, max_len=prompt + GEN)
    tok = logits.argmax(-1, keepdim=True)

    def decode_steps():
        nonlocal tok
        for i in range(PROFILED_STEPS):
            lg, _ = model.decode_fn(params, tok, caches, prompt + i)
            tok = lg[:, -1].argmax(-1, keepdim=True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_steps()
    torch.cuda.synchronize()
    decode_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.prefill_fn(params, batch, max_len=prompt + GEN)
    torch.cuda.synchronize()
    prefill_wall = time.perf_counter() - t0

    out = {"card": card, "torch": torch.__version__, "arch": cfg.name, "batch": BATCH,
           "prompt_len": prompt, "gen_len": GEN, "generate": runs,
           "prefill": _profiled(lambda: model.prefill_fn(params, batch, max_len=prompt + GEN),
                                prefill_wall),
           "decode": _profiled(decode_steps, decode_wall), "decode_steps": PROFILED_STEPS}
    for phase in ("prefill", "decode"):
        r = out[phase]
        print(f"{phase}: wall {r['wall_s']} s, device {r['device_s']} s, idle share "
              f"{r['idle_share']} (profiled wall {r['profiled_wall_s']} s)", flush=True)
        for row in r["top"][:10]:
            print(f"    {row['device_us'] / 1e3:10.3f} ms  x{row['count']:<6d} {row['name'][:110]}")
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"torch_serve_profile_{arch}.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
