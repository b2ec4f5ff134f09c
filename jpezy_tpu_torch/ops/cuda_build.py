"""Build and load the port's hand-written CUDA kernels.

Each source under csrc/ is compiled with nvcc for sm_90a into its own
shared library with a plain C interface and loaded with ctypes, the way
runtime/native.py builds the C++ host library: no PyTorch headers (which
take minutes to compile) and no ninja.  The libraries go to
build/torch_ext/ and are rebuilt when their source is newer.  A failed
build raises; nothing falls back to a plain torch version.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_ext")


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    return found


class KernelLibrary:
    """One csrc/*.cu source (or one in `directory`) and the shared library
    built from it.

    bind(lib) sets the restype/argtypes of the library's entry points;
    every library also exports jz_cuda_error_string(int)."""

    def __init__(self, source: str, bind, directory: str | None = None):
        self.src = os.path.join(directory or os.path.join(_PKG, "csrc"),
                                source)
        self.so = os.path.join(
            BUILD_DIR, f"libjz_{os.path.splitext(source)[0]}.so")
        self._bind = bind
        self._lock = threading.Lock()
        self.handle = None
        # nvcc's output from the last build in this process (ptxas -v)
        self.build_log = ""

    def build(self, force: bool = False) -> float:
        """Compile the source for sm_90a if the library is missing or
        stale.  Returns the seconds spent compiling (0.0 when fresh)."""
        if (not force and os.path.exists(self.so)
                and os.path.getmtime(self.so) >= os.path.getmtime(self.src)):
            return 0.0
        cc = nvcc()
        cuda_lib = os.path.join(os.path.dirname(os.path.dirname(cc)), "lib64")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{self.so}.{os.getpid()}.tmp"
        cmd = [
            cc, "-O3", "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-cudart",
            "shared", "-Xptxas", "-v", "-Xlinker", "-rpath", "-Xlinker",
            cuda_lib, self.src, "-o", tmp,
        ]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        secs = time.perf_counter() - t0
        self.build_log = (res.stdout + res.stderr).strip()
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}) building "
                               f"{self.src}:\n{self.build_log}")
        os.replace(tmp, self.so)
        return secs

    def get(self) -> ctypes.CDLL:
        """Build if needed and load the library (CUDA initialised first,
        so it binds to the cudart PyTorch already loaded)."""
        with self._lock:
            if self.handle is not None:
                return self.handle
            if not torch.cuda.is_available():
                raise RuntimeError("the CUDA kernels need a CUDA device")
            torch.cuda.init()
            self.build()
            lib = ctypes.CDLL(self.so)
            lib.jz_cuda_error_string.restype = ctypes.c_char_p
            lib.jz_cuda_error_string.argtypes = [ctypes.c_int]
            self._bind(lib)
            self.handle = lib
            return lib

    def raise_on(self, fn: str, rc: int) -> None:
        """Raise if a launcher returned a CUDA error code."""
        if rc != 0:
            msg = self.handle.jz_cuda_error_string(rc).decode(
                errors="replace")
            raise RuntimeError(f"{fn} kernel launch failed: {msg} ({rc})")


def check_tensors(fn: str, ref: torch.Tensor, *specs) -> None:
    """specs: (name, tensor, dtype, shape) each checked against `ref`'s
    device; raises ValueError on what the kernels do not take."""
    for name, t, dtype, shape in specs:
        if t.dtype != dtype:
            raise ValueError(f"{fn}: {name} is {t.dtype}, want {dtype}")
        if not t.is_cuda:
            raise ValueError(f"{fn}: {name} is not a CUDA tensor")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, "
                             f"want {tuple(shape)}")
        if t.device != ref.device:
            raise ValueError(f"{fn}: inputs on different devices")
