"""nvcc builds of the port's CUDA sources, bound through ctypes.

Each `KernelLibrary` is one source under cednerf_torch/csrc/ with a plain C
interface. nvcc compiles it for sm_90a the first time one of its kernels is
called, or when `build_all()` is, into cednerf_torch/_build/ (a file named
after a hash of the source, the csrc/ headers and the flags, so an edited
source or header rebuilds).
`build_all()` starts one nvcc per source, all at once, and waits for them
together.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, List, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LIBRARIES: List["KernelLibrary"] = []


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (looked for {nvcc})")
    return nvcc


def _headers() -> List[str]:
    """The .cuh headers under csrc/, which sources include."""
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(".cuh"))


class KernelLibrary:
    """One nvcc-built shared library, compiled and loaded on first use.

    bind(lib) sets the ctypes signatures of the library's C functions."""

    def __init__(self, stem: str, bind: Callable[[ctypes.CDLL], None]):
        self.stem = stem
        self.source = os.path.join(CSRC_DIR, stem + ".cu")
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()
        self.build_seconds = None
        self.build_log = ""
        LIBRARIES.append(self)

    def _target(self) -> str:
        src = b""
        for path in [self.source] + _headers():
            with open(path, "rb") as fh:
                src += fh.read()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return os.path.join(BUILD_DIR, f"lib{self.stem}_{tag[:16]}.so")

    def _start(self):
        """Start nvcc unless the library is built; returns the pending job."""
        so = self._target()
        if os.path.exists(so):
            self.build_seconds = 0.0
            return so, None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return so, (proc, tmp, time.perf_counter())

    def _finish(self, job):
        so, pending = job
        if pending is not None:
            proc, tmp, t0 = pending
            self.build_log = proc.communicate()[0]
            self.build_seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                                   f"{self.source}:\n{self.build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        self._bind(lib)
        lib.cednerf_error_string.argtypes = [ctypes.c_int]
        lib.cednerf_error_string.restype = ctypes.c_char_p
        self._lib = lib

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                self._finish(self._start())
            return self._lib

    def check(self, rc: int, name: str):
        if rc != 0:
            msg = self._lib.cednerf_error_string(rc).decode()
            raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def build_all() -> Dict[str, Tuple[float, str]]:
    """Build every library of the port at once (one nvcc per source, all
    started together) and load them: {stem: (nvcc seconds, nvcc log)}."""
    from . import (compact_kernels, encode_kernels,  # noqa: F401 (register)
                   gather_kernels, scatter_kernels)

    for lib in LIBRARIES:
        lib._lock.acquire()
    try:
        jobs = [(lib, lib._start()) for lib in LIBRARIES if lib._lib is None]
        for lib, job in jobs:
            lib._finish(job)
    finally:
        for lib in LIBRARIES:
            lib._lock.release()
    return {lib.stem: (lib.build_seconds, lib.build_log) for lib in LIBRARIES}
