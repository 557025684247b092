"""Build and load one CUDA source of csrc/ as a shared library.

Each kernel module (gf_kernels.py, crush_kernels.py) owns one
``NvccLibrary``: at first use nvcc compiles the checkout's source for
sm_90a into build/ceph_tpu_torch/ (plain C interface, no PyTorch
headers, a few seconds), and ctypes loads it.  The file name carries a
hash of the source and flags, so an edited source is rebuilt and a built
one is reused.  A failed build raises; nothing falls back.  Two
libraries can build at once (one nvcc each), which is how chip_smoke.py
builds them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ceph_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelError(RuntimeError):
    """A hand-written kernel that did not build or launch.  Callers that
    keep a loop alive across other errors let this one through: nothing
    turns a failed kernel into another path or a counted hiccup."""


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found: the port's kernels need the CUDA toolkit")


class NvccLibrary:
    """csrc/<source> compiled on first ``load()``; ``bind`` sets the
    ctypes signatures of its C functions."""

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self._bind = bind
        self._lib: ctypes.CDLL | None = None
        self._lock = threading.Lock()
        #: nvcc's output from the build this process made (ptxas register
        #: and spill report), empty when the library was already built
        self.build_log = ""

    def path(self) -> Path:
        src = self.source.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}_{tag}.so"

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            path = self.path()
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(
                    [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                    capture_output=True, text=True)
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise KernelError(
                        f"nvcc failed on {self.source.name} ({proc.returncode}):\n"
                        f"{self.build_log}")
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            self._bind(lib)
            self._lib = lib
            return lib
