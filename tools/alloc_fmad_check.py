"""Why the fused-allocate kernel is built without ``-fmad=false``.

``python3 tools/alloc_fmad_check.py`` from the repo root, on a CUDA card:
builds ``src/repro_torch/kernels/csrc/alloc.cu`` twice — with the port's
flags (nvcc's default ``-fmad=true``) and with ``-fmad=false`` added — and
counts, over random [192, 1000] batches at exponents that take the device
``pow``, the theta and chip entries where each build differs from the plain
PyTorch version.  libdevice's ``pow`` is compiled with the caller's flags,
so the flag alone can move it against torch's own ``pow``.  Prints the
card's name and power limit, the nvcc version and the counts.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "repro_torch" / "fmad_check"


def _build(nvcc: Path, src: Path, flags: tuple[str, ...], name: str) -> ctypes.CDLL:
    """Compile ``src`` with ``flags`` into ``OUT/name`` and load it."""
    OUT.mkdir(parents=True, exist_ok=True)
    lib_path = OUT / name
    subprocess.run([str(nvcc), *flags, "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    from repro_torch.kernels.alloc import ARGTYPES

    lib = ctypes.CDLL(str(lib_path))
    lib.hesrpt_alloc_f64.argtypes = ARGTYPES
    lib.hesrpt_alloc_f64.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("alloc_fmad_check: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import alloc

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    nvcc = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "nvcc"
    print(subprocess.run([str(nvcc), "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1], flush=True)
    variants = {
        "default (-fmad=true)": _build(nvcc, alloc._SRC, alloc.NVCC_FLAGS, "fmad_true.so"),
        "-fmad=false": _build(nvcc, alloc._SRC, (*alloc.NVCC_FLAGS, "-fmad=false"),
                              "fmad_false.so"),
    }
    counts = {name: [0, 0] for name in variants}
    entries = 0
    gen = torch.Generator(device="cuda").manual_seed(1)
    for _ in range(60):
        for p in (0.3, 0.7, 0.9, 0.1):
            shape = (192, 1000)
            x = torch.rand(shape, generator=gen, device="cuda", dtype=torch.float64)
            drop = torch.rand(shape, generator=gen, device="cuda", dtype=torch.float64) < 0.3
            x = torch.where(drop, 0.0, x)
            theta0, chips0 = alloc.hesrpt_alloc_fused_ref(x, p, 256)
            for name, lib in variants.items():
                theta = torch.empty_like(x)
                chips = torch.empty(shape, dtype=torch.int32, device="cuda")
                err = lib.hesrpt_alloc_f64(
                    x.data_ptr(), theta.data_ptr(), chips.data_ptr(), shape[0], shape[1],
                    alloc.pad_len(shape[1]), 1.0 / (1.0 - p), None, 256, 1,
                    torch.cuda.current_stream().cuda_stream,
                )
                if err != 0:
                    raise RuntimeError(f"alloc kernel launch failed: cudaError {err}")
                counts[name][0] += int((theta != theta0).sum())
                counts[name][1] += int((chips != chips0).sum())
            entries += x.numel()
    for name, (d_theta, d_chips) in counts.items():
        print(f"{name:>22s}: theta differs on {d_theta} of {entries} entries, "
              f"chips on {d_chips}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
