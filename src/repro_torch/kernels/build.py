"""The build shared by the port's CUDA kernels: nvcc at first use, ctypes.

Each kernel's source under ``csrc/`` has a plain C interface.  It is compiled
by ``nvcc`` (found through ``CUDA_HOME``) for ``sm_90a`` into a shared
library named by the hash of its source and flags, in the git-ignored
``build/repro_torch/`` at the repo root, and loaded with ``ctypes``.  A
kernel's wrapper calls :meth:`KernelLibrary.load` at its first launch;
nothing is built when a module is imported.  Each library has its own lock
and ``nvcc`` runs outside the interpreter lock, so two threads build two
kernels at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"


class KernelLibrary:
    """One ``csrc/*.cu`` source: built once per content, loaded once per
    process, its C functions declared from ``signatures`` (name -> argtypes;
    every function returns a ``cudaError_t`` as ``int``)."""

    def __init__(self, src: Path, signatures: dict[str, list]):
        self.src = src
        self.signatures = signatures
        #: Seconds the build took (0.0 when the library was already built).
        self.build_seconds = 0.0
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()

    def _build(self) -> Path:
        digest = hashlib.sha256(self.src.read_bytes() + " ".join(NVCC_FLAGS).encode())
        out = BUILD_DIR / f"{self.src.stem}_{digest.hexdigest()[:16]}.so"
        if out.exists():
            self.build_seconds = 0.0
            return out
        from torch.utils.cpp_extension import CUDA_HOME

        nvcc = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "nvcc"
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        run = subprocess.run(
            [str(nvcc), *NVCC_FLAGS, "-o", str(tmp), str(self.src)],
            capture_output=True, text=True,
        )
        if run.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.src.name}:\n{run.stderr}")
        os.replace(tmp, out)
        self.build_seconds = time.perf_counter() - t0
        return out

    def load(self) -> ctypes.CDLL:
        """The shared library, built on first use."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self._build()))
                for name, argtypes in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib
