"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` exposes a plain ``extern "C"`` launcher.
It is compiled at first use by ``nvcc`` into a shared library under
``vidsgg_torch/ops/build/`` (ignored by git), named by a hash of the source
and the flags, and loaded with ``ctypes``. Nothing is built or loaded when a
module is imported. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


class CudaKernel:
    """One kernel source: builds it once, loads it once, and counts the
    launches its wrappers make: ``launches`` in all, ``launches_by`` per
    call contract the wrapper names, ``launches_by_dtype`` per contract and
    element type (plain counters; ``reset_counts``)."""

    def __init__(self, source: str, declare=None):
        self.source = CSRC_DIR / source
        self._declare_fns = declare
        self.launches = 0
        self.launches_by: dict[str, int] = {}
        self.launches_by_dtype: dict[str, int] = {}
        self.build_log = ""
        self._lib = None

    def count(self, contract: str, dtype: str | None = None):
        """One launch, made through ``contract`` (on ``dtype`` elements)."""
        self.launches += 1
        self.launches_by[contract] = self.launches_by.get(contract, 0) + 1
        key = contract if dtype is None else f"{contract} {dtype}"
        self.launches_by_dtype[key] = self.launches_by_dtype.get(key, 0) + 1

    def reset_counts(self):
        self.launches = 0
        self.launches_by = {}
        self.launches_by_dtype = {}

    def library_path(self) -> Path:
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{digest}.so"

    def build(self) -> Path:
        out = self.library_path()
        log = out.with_suffix(".log")
        if out.exists():
            self.build_log = log.read_text() if log.exists() else ""
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {self.source.name} (exit {proc.returncode}):\n"
                f"{self.build_log}"
            )
        log.write_text(self.build_log)
        os.replace(tmp, out)
        return out

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            lib.vidsgg_cuda_error_string.argtypes = [ctypes.c_int]
            lib.vidsgg_cuda_error_string.restype = ctypes.c_char_p
            if self._declare_fns is not None:
                self._declare_fns(lib)
            self._lib = lib
        return self._lib

    def check(self, status: int, what: str):
        if status != 0:
            msg = self.lib().vidsgg_cuda_error_string(status).decode()
            raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
