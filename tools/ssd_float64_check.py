"""The SSD kernel and its plain version against a float64 evaluation.

``python3 tools/ssd_float64_check.py`` from the repo root, on a CUDA card:
draws float32 inputs at the mamba2-130m prefill shape of one layer (x
[4, 30000, 24, 64], b/c [4, 30000, 128], as ``chip_smoke.py`` draws them)
and evaluates the plain chunked form (``kernels/chunked.py``) on them in
float64.  Against that it holds, in float32, the CUDA kernel
(``kernels/ssd_scan.py``, 64-step chunks) and the plain version at 64 and
at 128 steps a chunk (the TPU kernel's default), and reports for each the
max and mean |error| of y and of the final state and the count of y
elements beyond 2e-5 + 2e-5 |y| (the float32 tolerance of
``tests/test_kernels.py``) and states beyond 1e-3 + 1e-3 |state|.  Two
float32 summation orders can differ by about the tolerance at 1.8e8
outputs; this says which one is nearer the exact answer.

Prints the card's name and power limit first; exits with 1 if the kernel
has any element beyond the tolerance, or without CUDA.  The read-out also
goes to ``chiprun_out/ssd_float64_check.json``.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPE = (4, 30000, 24, 64, 128)  # (b, s, h, p, n): chip_smoke.py's serve prefill
Y_TOL = (2e-5, 2e-5)  # (atol, rtol)
STATE_TOL = (1e-3, 1e-3)


def _errors(got, truth, tol) -> dict:
    err = (got.double() - truth).abs()
    beyond = int((err > tol[0] + tol[1] * truth.abs()).sum().item())
    return {"max": err.max().item(), "mean": err.mean().item(), "beyond_tol": beyond}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssd_float64_check: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import chunked, ssd_scan

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    b, s, h, p, n = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(14)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x = randn(b, s, h, p)
    dt = torch.rand((b, s, h), generator=gen, device="cuda") * 0.19 + 0.01
    a = -(torch.rand((h,), generator=gen, device="cuda") * 1.5 + 0.5)
    args = (x, dt, a, randn(b, s, n), randn(b, s, n), randn(h))
    y64, st64 = chunked.ssd(*(t.double() for t in args), block=ssd_scan.CHUNK,
                            return_state=True)
    sides = {
        "kernel": lambda: ssd_scan.ssd_scan(*args, return_state=True),
        f"chunked_q{ssd_scan.CHUNK}": lambda: chunked.ssd(*args, block=ssd_scan.CHUNK,
                                                          return_state=True),
        "chunked_q128": lambda: chunked.ssd(*args, block=128, return_state=True),
    }
    out = {"card": card, "shape": dict(zip("bshpn", SHAPE)), "y_max_abs": y64.abs().max().item()}
    for name, fn in sides.items():
        y, st = fn()
        out[name] = {"y": _errors(y, y64, Y_TOL), "state": _errors(st, st64, STATE_TOL)}
        del y, st
        r = out[name]
        print(f"{name:>12s}: y max |err| {r['y']['max']:.3e} mean {r['y']['mean']:.3e}, "
              f"{r['y']['beyond_tol']} beyond tolerance; state max |err| "
              f"{r['state']['max']:.3e} mean {r['state']['mean']:.3e}, "
              f"{r['state']['beyond_tol']} beyond", flush=True)
    print(f"max |y| {out['y_max_abs']:.2f} over {b * s * h * p} outputs", flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "ssd_float64_check.json").write_text(json.dumps(out, indent=1))
    kernel = out["kernel"]
    return 0 if kernel["y"]["beyond_tol"] == 0 and kernel["state"]["beyond_tol"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
