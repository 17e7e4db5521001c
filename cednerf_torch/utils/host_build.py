"""g++ builds of the port's host C++ sources, bound through ctypes.

Each `HostLibrary` is one source under cednerf_torch/csrc/host/ with a plain
C interface (the PNG unfilter, the DyNeRF ray sampler and weight maps). g++
compiles it the first time it is asked for, into cednerf_torch/_build/ (a
file named after a hash of the source and the flags, written under a
temporary name and renamed, so processes building at once do not collide).
The flags are those the JAX package builds csrc/ with, so the sampler's and
the weights' results are bit for bit the original's. A failed build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_DIR = os.path.join(_PKG, "csrc", "host")
BUILD_DIR = os.path.join(_PKG, "_build")
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")


class HostLibrary:
    """One g++-built shared library, compiled and loaded on first use.

    bind(lib) sets the ctypes signatures of the library's C functions."""

    def __init__(self, stem: str, bind: Callable[[ctypes.CDLL], None]):
        self.stem = stem
        self.source = os.path.join(HOST_DIR, stem + ".cpp")
        self._bind = bind
        self._lib = None
        self._lock = threading.Lock()

    def _target(self) -> str:
        with open(self.source, "rb") as fh:
            src = fh.read()
        tag = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()
        return os.path.join(BUILD_DIR, f"lib{self.stem}_{tag[:16]}.so")

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                so = self._target()
                if not os.path.exists(so):
                    gxx = shutil.which("g++")
                    if gxx is None:
                        raise RuntimeError(
                            f"g++ not found: cannot build {self.source}")
                    os.makedirs(BUILD_DIR, exist_ok=True)
                    tmp = f"{so}.{os.getpid()}.tmp"
                    proc = subprocess.run([gxx, *GXX_FLAGS, self.source, "-o",
                                           tmp], capture_output=True,
                                          text=True)
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"g++ failed ({proc.returncode}) on "
                            f"{self.source}:\n{proc.stderr}")
                    os.replace(tmp, so)
                lib = ctypes.CDLL(so)
                self._bind(lib)
                self._lib = lib
            return self._lib
