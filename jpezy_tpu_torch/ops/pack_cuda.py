"""Loader and wrapper of the hand-written CUDA pack kernel (csrc/pack_words.cu).

Replaces the Pallas TPU kernel jpezy_tpu/ops/pack_pallas.py.  The kernel is
compiled with nvcc into a shared library with a plain C interface and
loaded with ctypes, the way runtime/native.py builds the C++ host library:
no PyTorch headers (which take minutes to compile) and no ninja.  The
library goes to build/torch_ext/ and is rebuilt when the .cu source is
newer than it.  A failed build or launch raises; nothing falls back to the
plain torch pack.

`launches` counts kernel launches made through pack_words_cuda, so a run
can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

from .entropy import M32

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "pack_words.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_ext")
_SO = os.path.join(_BUILD_DIR, "libjz_pack_words.so")

_lock = threading.Lock()
_lib = None
launches = 0
# nvcc's output from the last build in this process (ptxas resource usage)
build_log = ""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA pack kernel")
    return found


def build(force: bool = False) -> float:
    """Compile pack_words.cu for sm_90a if the library is missing or stale.

    Returns the seconds spent compiling (0.0 when the library was fresh)."""
    global build_log
    if (not force and os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return 0.0
    nvcc = _nvcc()
    cuda_lib = os.path.join(os.path.dirname(os.path.dirname(nvcc)), "lib64")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [
        nvcc, "-O3", "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-cudart", "shared",
        "-Xptxas", "-v", "-Xlinker", "-rpath", "-Xlinker", cuda_lib,
        _SRC, "-o", tmp,
    ]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    build_log = (res.stdout + res.stderr).strip()
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) building {_SRC}:\n{build_log}")
    os.replace(tmp, _SO)
    return secs


def get_lib() -> ctypes.CDLL:
    """Build if needed and load the kernel library (CUDA initialised first,
    so the library binds to the cudart PyTorch already loaded)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA pack kernel needs a CUDA device")
        torch.cuda.init()
        build()
        lib = ctypes.CDLL(_SO)
        vp = ctypes.c_void_p
        lib.jz_pack_words.restype = ctypes.c_int
        lib.jz_pack_words.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong,
                                      vp]
        lib.jz_cuda_error_string.restype = ctypes.c_char_p
        lib.jz_cuda_error_string.argtypes = [ctypes.c_int]
        _lib = lib
        return _lib


def _as_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensors with the same 32-bit
    pattern (no reliance on a wrapping cast)."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32).contiguous()


def pack_words_cuda(hi: torch.Tensor, lo: torch.Tensor, nbits: torch.Tensor):
    """CUDA form of entropy.pack_block_words.

    hi, lo: [B, 64] int64 uint32 emission halves (entropy.block_emissions);
    nbits: [B, 64] int32 lengths.  Returns (words [B, 64] int64 in
    [0, 2**32), bits [B] int32), on the inputs' device and stream."""
    global launches
    for name, t, dtype in (("hi", hi, torch.int64), ("lo", lo, torch.int64),
                           ("nbits", nbits, torch.int32)):
        if t.dtype != dtype:
            raise ValueError(f"pack_words_cuda: {name} is {t.dtype}, want {dtype}")
        if not t.is_cuda:
            raise ValueError(f"pack_words_cuda: {name} is not a CUDA tensor")
        if t.dim() != 2 or t.shape[1] != 64 or t.shape != hi.shape:
            raise ValueError(
                f"pack_words_cuda: {name} has shape {tuple(t.shape)}, "
                "want [B, 64] for all inputs")
        if t.device != hi.device:
            raise ValueError("pack_words_cuda: inputs on different devices")
    lib = get_lib()
    B = hi.shape[0]
    dev = hi.device
    with torch.cuda.device(dev):
        h32, l32 = _as_i32_bits(hi), _as_i32_bits(lo)
        n32 = nbits.contiguous()
        words = torch.empty((B, 64), dtype=torch.int32, device=dev)
        bits = torch.empty((B,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jz_pack_words(h32.data_ptr(), l32.data_ptr(),
                               n32.data_ptr(), words.data_ptr(),
                               bits.data_ptr(), B, stream)
    if rc != 0:
        msg = lib.jz_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"pack_words kernel launch failed: {msg} ({rc})")
    if B > 0:  # the launcher returns without a launch for an empty batch
        with _lock:
            launches += 1
    return words.to(torch.int64) & M32, bits
