"""What the flash kernel compiles to: registers, spills, the instruction mix.

``python3 tools/flash_sass_check.py`` from the repo root, on the machine with
the CUDA toolkit (``nvcc`` and ``cuobjdump`` under ``CUDA_HOME``) and a card.
It builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` with the
port's nvcc flags (``kernels/build.py``) plus ``-Xptxas -v`` into
``build/repro_torch/sass/``, and prints for each kernel instance
(``flash_fwd_f32<D>``, ``flash_fwd_tc<D>``) the registers, spill bytes and
stack ptxas reports, and the static count in ``cuobjdump -sass`` of
``HGMMA`` (``wgmma``), ``HMMA`` (``mma.sync``), ``FFMA`` and the
shared-memory loads by width (``LDS.128``, ``LDS.64``, 32-bit ``LDS``).  For
each float32 instance it also prints the resident CTAs an SM on this card
(``kernels/flash_attention.py::occupancy``, the library the port builds).
ptxas's notes on ``wgmma`` (serialised pipelines) are printed as they come.

Exits 1 if the build fails, if any instance spills, or if a bf16 instance
issues no ``HGMMA``.  The read-out also goes to
``chiprun_out/flash_sass_check.json``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
# Mangled names: flash_fwd_f32<D> and flash_fwd_tc<D> in the anonymous namespace.
KERNEL = re.compile(r"(flash_fwd_tc|flash_fwd_f32)ILi(\d+)E")
# Opcodes counted in the SASS; a shared-memory load's width is its last suffix.
OPS = ("HGMMA", "HMMA", "FFMA", "LDS.128", "LDS.64", "LDS")
LDS = re.compile(r"\bLDS((?:\.[A-Z0-9]+)*)\b")


def _instance(mangled: str) -> str | None:
    m = KERNEL.search(mangled)
    return None if m is None else f"{m.group(1)}<{m.group(2)}>"


def _count(rec: dict, line: str) -> None:
    if "@!PT" in line:  # predicated off for good: a placeholder, never issued
        return
    for op in ("HGMMA", "HMMA", "FFMA"):
        if re.search(rf"\b{op}\b", line):
            rec[op] += 1
    m = LDS.search(line)  # not LDSM (ldmatrix): no word boundary after LDS
    if m:
        width = m.group(1).rsplit(".", 1)[-1] if m.group(1) else ""
        rec[f"LDS.{width}" if width in ("64", "128") else "LDS"] += 1


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
                kernels.setdefault(current, {}).update(dict.fromkeys(OPS, 0))
            continue
        if current:
            _count(kernels[current], line)

    from repro_torch.kernels import flash_attention
    for name, rec in kernels.items():
        if name.startswith("flash_fwd_f32"):
            rec["ctas_per_sm"] = flash_attention.occupancy(int(name[14:-1]))[1]

    bad = []
    for name in sorted(kernels, key=lambda n: (n.startswith("flash_fwd_tc"), len(n), n)):
        rec = kernels[name]
        ctas = f", {rec['ctas_per_sm']} CTAs an SM" if "ctas_per_sm" in rec else ""
        print(f"{name}: {rec.get('registers')} registers{ctas}, spill stores "
              f"{rec.get('spill_stores')} B, spill loads {rec.get('spill_loads')} B, stack "
              f"{rec.get('stack')} B; SASS " + ", ".join(f"{op} {rec.get(op)}" for op in OPS))
        if rec.get("spill_stores") or rec.get("spill_loads") or (
                name.startswith("flash_fwd_tc") and not rec.get("HGMMA")):
            bad.append(name)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "flash_sass_check.json").write_text(json.dumps(kernels, indent=1))
    missing = [p for p in ("flash_fwd_f32", "flash_fwd_tc") if not any(
        n.startswith(p) for n in kernels)]
    if bad or missing:
        print(f"flash_sass_check: spills, or a bf16 instance without HGMMA, in {bad}; "
              f"no instance of {missing}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
