"""Build and load the port's CUDA sources: ``nvcc`` for ``sm_90a`` into
``build/`` at the repo root, one shared library per source named by the hash
of that source (an edited source rebuilds), loaded with ``ctypes``.

Nothing here runs at import: each kernel module calls ``Library.get()``
inside the wrapper that launches its kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``.  Raises if there is none."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


class Library:
    """One ``.cu`` source, its build and its loaded ``ctypes`` library.

    ``signatures`` maps each exported C function to its ``argtypes``; every
    one returns an int (``cudaGetLastError()`` after its launch)."""

    def __init__(self, source: Path, signatures: dict, defines=()):
        self.source = Path(source)
        self.signatures = signatures
        # preprocessor names set for this build (``-D``); a library with
        # defines is named after them too
        self.defines = tuple(defines)
        self.last_build = {}   # the nvcc command and seconds of this process's build
        self._lock = threading.Lock()
        self._lib = None

    def build(self) -> Path:
        """Compile the source (once per source hash); return the library."""
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        tag = "".join(f"_{d.lower()}" for d in self.defines)
        out = BUILD_DIR / f"lib{self.source.stem}{tag}_{digest}.so"
        if out.is_file():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *self.flags(), "-o", str(tmp),
               str(self.source)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)
        self.last_build.update(cmd=" ".join(cmd), seconds=time.perf_counter() - t0)
        return out

    def flags(self) -> list:
        """The nvcc flags of this build beyond ``NVCC_FLAGS``."""
        return [f"-D{d}" for d in self.defines]

    def get(self):
        """The loaded library, built on first use."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                for name, argtypes in self.signatures.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._lib = lib
        return self._lib


def raise_on(err: int, name: str):
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
