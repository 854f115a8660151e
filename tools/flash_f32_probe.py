"""Where the float32 flash kernel's time goes, by taking one cost away at a time.

``python3 tools/flash_f32_probe.py`` from the repo root, on the machine with a
card and nvcc.  It builds variants of ``flash_fwd_f32`` from
``src/repro_torch/kernels/csrc/flash_attention.cu``, each with one textual
edit that drops one kind of work, and times each at ``chip_smoke.py`` phase
10's float32 shapes (phi4-mini's and recurrentgemma's prefill) with that
phase's device timer.  The variants compute wrong attention; their times
only bound what each cost can take:

- ``q_once`` / ``k_once``: the logits product loads its Q (K) operands once
  per eight d-chunks instead of every chunk (the compiler folds the repeated
  loads), so its shared-memory reads of Q (K) fall 8x;
- ``p_once`` / ``v_once``: the same for P (once a 16-key group) and V (once a
  16-key group) in O += P V;
- ``no_exp``: the softmax's ``expf`` calls become plain subtractions;
- ``no_sync``: the one ``__syncthreads`` a half-tile is gone;
- ``no_copy``: only the first tile's K and V are copied; later half-tiles
  read what their slot holds;
- ``loads_once``: the four ``*_once`` edits together;
- ``ffma_only``: every edit above: what is left is the FFMAs, the masks and
  the bookkeeping.

The base kernel is timed first and last.  Then ``base`` and ``ffma_only``
run for two seconds at each shape while ``nvidia-smi`` samples the SM clock
and the power draw every 100 ms; the median clock gives the card's float32
FMA rate under that load (SMs x 128 lanes x 2 flops x clock), beside the
67 TFLOP/s of the data sheet, which assumes the 1980 MHz boost clock.
Prints one line a measurement, with the card's name and power limit, and
writes ``chiprun_out/flash_f32_probe.json``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
F32_END = "// ------------------------------------------------------------ bfloat16, wgmma"

# name -> edits: (text in the float32 part of the source, its replacement)
EDITS = {
    "q_once": ("qa[i] = lds4(((y & 1) ? q_odd : q_even) + 2 * i * D + 4 * (c0 + y));",
               "qa[i] = lds4(q_even + 2 * i * D + 4 * c0);"),
    "k_once": ("const float* kx = k_row + 4 * c0 + ((4 * x) ^ lk4);",
               "const float* kx = k_row + 4 * c0 + lk4;"),
    "p_once": ("pa[i] = lds4(p_g[i >> 1] + 2 * i * F_BK + 4 * y + ((y & 1) ? -4 * lr : 4 * lr));",
               "pa[i] = lds4(p_g[i >> 1] + 2 * i * F_BK);"),
    "v_once": ("const float* vk = v_row + key * D + ((4 * ((4 * z + jj) & SW)) ^ lk4);",
               "const float* vk = v_row + 16 * g * D + lk4;"),
    "no_exp": ("expf(", "("),
    "no_sync": ("    __syncthreads();              // everyone's have", "    // everyone's have"),
    "no_copy": ("    if (n < halves) {", "    if (n < STAGES - 1) {"),
}
PROBES = {name: (name,) for name in EDITS}
PROBES["loads_once"] = ("q_once", "k_once", "p_once", "v_once")
PROBES["ffma_only"] = tuple(EDITS)


def variant(name: str) -> str:
    """The source with probe ``name``'s edit applied to its float32 part."""
    src = SRC.read_text()
    cut = src.index(F32_END)
    f32, rest = src[:cut], src[cut:]
    for edit in PROBES.get(name, ()):
        old, new = EDITS[edit]
        if old not in f32:
            raise SystemExit(f"flash_f32_probe: {edit}'s text is no longer in {SRC.name}")
        f32 = f32.replace(old, new)
    return f32 + rest


def _clocks_under_load(run, seconds: float = 2.0) -> dict:
    """Median SM clock (MHz) and power draw (W) that ``nvidia-smi`` reads
    every 100 ms while ``run`` is called back to back for ``seconds``."""
    import torch

    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(5):
                run()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=60)
    rows = [[float(x) for x in line.split(",")] for line in out.splitlines() if line.strip()]
    rows = rows[2:] or rows  # the first samples may predate the load
    return {"sm_mhz": statistics.median(r[0] for r in rows),
            "power_w": statistics.median(r[1] for r in rows), "samples": len(rows)}


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import FLASH_TIMING_SHAPES, _card, _time_ms
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.kernels.build import BUILD_DIR, KernelLibrary

    if not torch.cuda.is_available():
        print("flash_f32_probe: needs a CUDA card", file=sys.stderr)
        return 1
    card = _card()
    print(card, flush=True)
    out_dir = BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    names = ["base", *PROBES, "base"]
    libs = {}
    for name in dict.fromkeys(names):
        path = out_dir / f"flash_attention_{name}.cu"
        path.write_text(variant(name))
        libs[name] = KernelLibrary(path, flash._LIBRARY.signatures)
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc a variant, together
        for lib in pool.map(KernelLibrary.load, libs.values()):
            assert lib is not None

    gen = torch.Generator(device="cuda").manual_seed(10)
    inputs = {}
    for shape, (b, hq, hkv, s, d, window) in FLASH_TIMING_SHAPES.items():
        q = torch.randn((b, hq, s, d), generator=gen, device="cuda")
        k = torch.randn((b, hkv, s, d), generator=gen, device="cuda")
        v = torch.randn((b, hkv, s, d), generator=gen, device="cuda")
        inputs[shape] = (q, k, v, window)
    record = {"card": card, "runs": []}
    try:
        for name in names:
            flash._LIBRARY = libs[name]
            for shape, (q, k, v, window) in inputs.items():
                ms = _time_ms(lambda: flash.flash_attention(q, k, v, causal=True, window=window),
                              20)
                print(f"flash_f32_probe: {name:>8s} {shape}: {ms:.4f} ms", flush=True)
                record["runs"].append({"probe": name, "shape": shape, "ms": ms})
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for name in ("base", "ffma_only"):
            flash._LIBRARY = libs[name]
            for shape, (q, k, v, window) in inputs.items():
                clk = _clocks_under_load(
                    lambda: flash.flash_attention(q, k, v, causal=True, window=window))
                clk["fma_tflops_at_clock"] = sms * 128 * 2 * clk["sm_mhz"] * 1e6 / 1e12
                print(f"flash_f32_probe: {name:>8s} {shape} under load: SM clock "
                      f"{clk['sm_mhz']:.0f} MHz, power {clk['power_w']:.1f} W "
                      f"({clk['samples']} samples): float32 FMA rate at that clock "
                      f"{clk['fma_tflops_at_clock']:.2f} TFLOP/s", flush=True)
                record["runs"].append({"probe": name, "shape": shape, "under_load": clk})
    finally:
        flash._LIBRARY = libs["base"]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "flash_f32_probe.json").write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
