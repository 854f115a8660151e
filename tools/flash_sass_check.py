"""What the flash kernel compiles to: registers, spills, tensor-core instructions.

``python3 tools/flash_sass_check.py`` from the repo root, on the machine with
the CUDA toolkit (``nvcc`` and ``cuobjdump`` under ``CUDA_HOME``).  It builds
``src/repro_torch/kernels/csrc/flash_attention.cu`` with the port's nvcc
flags (``kernels/build.py``) plus ``-Xptxas -v`` into
``build/repro_torch/sass/``, and prints for each kernel instance
(``flash_fwd<float, D>``, ``flash_fwd_tc<D>``) the registers, spill bytes
and stack ptxas reports, and the count of ``HGMMA`` (``wgmma``), ``HMMA``
(``mma.sync``) and ``FFMA`` instructions in ``cuobjdump -sass``.  ptxas's
notes on ``wgmma`` (serialised pipelines) are printed as they come.

Exits 1 if the build fails, or if a bf16 instance issues no ``HGMMA`` or
spills.  The read-out also goes to ``chiprun_out/flash_sass_check.json``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
# Mangled names: flash_fwd<float, D> and flash_fwd_tc<D> in the anonymous namespace.
KERNEL = re.compile(r"(flash_fwd_tc|flash_fwd)If?Li(\d+)E")


def _instance(mangled: str) -> str | None:
    m = KERNEL.search(mangled)
    if m is None:
        return None
    return f"flash_fwd_tc<{m.group(2)}>" if m.group(1) == "flash_fwd_tc" else \
        f"flash_fwd<float, {m.group(2)}>"


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels.build import BUILD_DIR, NVCC_FLAGS

    bin_dir = Path(CUDA_HOME or "/usr/local/cuda") / "bin"
    out_dir = BUILD_DIR / "sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "flash_attention_v.so"
    build = subprocess.run([str(bin_dir / "nvcc"), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
                            str(SRC)], capture_output=True, text=True)
    if build.returncode != 0:
        print(build.stderr, file=sys.stderr)
        return 1

    kernels: dict[str, dict] = {}
    current = None
    for line in build.stderr.splitlines():
        if "wgmma" in line.lower():
            print(line)
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: |$)",
                      line)
        if m:
            current = _instance(m.group(1))
            if current:
                kernels.setdefault(current, {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            kernels[current].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                    spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            kernels[current]["registers"] = int(m.group(1))

    sass = subprocess.run([str(bin_dir / "cuobjdump"), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    current = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = _instance(m.group(1))
            if current:
                kernels.setdefault(current, {}).update(HGMMA=0, HMMA=0, FFMA=0)
            continue
        if current:
            for op in ("HGMMA", "HMMA", "FFMA"):
                if re.search(rf"\b{op}\b", line):
                    kernels[current][op] += 1

    bad = []
    for name in sorted(kernels, key=lambda n: (n.startswith("flash_fwd_tc"), n)):
        rec = kernels[name]
        print(f"{name}: {rec.get('registers')} registers, spill stores "
              f"{rec.get('spill_stores')} B, spill loads {rec.get('spill_loads')} B, stack "
              f"{rec.get('stack')} B; SASS HGMMA {rec.get('HGMMA')}, HMMA {rec.get('HMMA')}, "
              f"FFMA {rec.get('FFMA')}")
        if name.startswith("flash_fwd_tc") and (not rec.get("HGMMA") or rec.get("spill_stores")):
            bad.append(name)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "flash_sass_check.json").write_text(json.dumps(kernels, indent=1))
    if bad or not any(n.startswith("flash_fwd_tc") for n in kernels):
        print(f"flash_sass_check: no HGMMA, or spills, in {bad or 'any bf16 instance'}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
