"""Loader and wrappers of the hand-written CUDA entropy kernels
(csrc/entropy_pack.cu).

Replaces the Pallas TPU kernel jpezy_tpu/ops/pack_pallas.py.  The source
holds one warp-per-block pack routine and two entry points:

  pack_words_cuda     merged emissions (hi, lo, nbits) -> packed words; the
                      one-to-one counterpart of the Pallas kernel.  Per
                      block the function reads 768 bytes and writes 260
                      (64 32-bit words and a count): a bound of 1,028.
  encode_blocks_cuda  quantized blocks + DC predictors + Huffman tables ->
                      packed words, the emissions computed in registers;
                      the encode program calls this one.  Per block the
                      function reads 260 bytes and writes 260: a bound
                      of 520.

Both are bound by memory traffic; the design (coalesced rows, a warp
shuffle scan, a 64-word shared-memory buffer per warp) is described in the
source's header.  Words come back as int64 values in [0, 2**32), the word
convention of ops/entropy.py: the kernels store them zero-extended
themselves (256 bytes per block beyond the bound), which was measured
faster on an H100 than 32-bit stores and a widening pass (PERF.md).

The kernels are compiled with nvcc into a shared library with a plain C
interface and loaded with ctypes, the way runtime/native.py builds the
C++ host library: no PyTorch headers (which take minutes to compile) and
no ninja.  The library goes to build/torch_ext/ and is rebuilt when the
.cu source is newer than it.  A failed build or launch raises; nothing
falls back to the plain torch versions.

`launches` counts launches of the pack kernel made through
pack_words_cuda and `encode_launches` those of the fused kernel made
through encode_blocks_cuda, so a run can show which kernels its path went
through.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

import torch

from ..constants import codec_constants

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "entropy_pack.cu")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_ext")
_SO = os.path.join(_BUILD_DIR, "libjz_entropy_pack.so")

_lock = threading.Lock()
_lib = None
launches = 0
encode_launches = 0
# nvcc's output from the last build in this process (ptxas resource usage)
build_log = ""
# int32 copies of the fixed Huffman tables, one set per (device, chroma)
_tables: dict = {}
_TABLE_LENGTHS = (12, 12, 162, 162)  # dc_code, dc_size, ac_code, ac_size


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    return found


def build(force: bool = False) -> float:
    """Compile entropy_pack.cu for sm_90a if the library is missing or stale.

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
            raise RuntimeError("the CUDA entropy kernels need a CUDA device")
        torch.cuda.init()
        build()
        lib = ctypes.CDLL(_SO)
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.jz_pack_words.restype = ci
        lib.jz_pack_words.argtypes = [vp, vp, vp, vp, vp, ll, vp]
        lib.jz_encode_blocks.restype = ci
        lib.jz_encode_blocks.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ll,
                                         vp]
        lib.jz_cuda_error_string.restype = ctypes.c_char_p
        lib.jz_cuda_error_string.argtypes = [ci]
        _lib = lib
        return _lib


def _low32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same 32-bit
    pattern: the low half of each little-endian int64, picked from a view
    of the same memory (no reliance on a wrapping cast)."""
    return x.contiguous().view(torch.int32)[..., ::2].contiguous()


def _check(fn: str, ref: torch.Tensor, *specs) -> None:
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


def _outputs(B: int, dev: torch.device):
    return (torch.empty((B, 64), dtype=torch.int64, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev))


def _raise_on(fn: str, lib, rc: int) -> None:
    if rc != 0:
        msg = lib.jz_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{fn} kernel launch failed: {msg} ({rc})")


def pack_words_cuda(hi: torch.Tensor, lo: torch.Tensor, nbits: torch.Tensor):
    """CUDA form of entropy.pack_block_words.

    hi, lo: [B, 64] int64 uint32 emission halves (entropy.block_emissions);
    nbits: [B, 64] int32 lengths in [0, 59].  Returns (words [B, 64] int64
    in [0, 2**32), bits [B] int32), on the inputs' device and stream."""
    global launches
    if hi.dim() != 2 or hi.shape[1] != 64:
        raise ValueError(f"pack_words_cuda: hi has shape {tuple(hi.shape)}, "
                         "want [B, 64]")
    _check("pack_words_cuda", hi, ("hi", hi, torch.int64, hi.shape),
           ("lo", lo, torch.int64, hi.shape),
           ("nbits", nbits, torch.int32, hi.shape))
    lib = get_lib()
    B = hi.shape[0]
    dev = hi.device
    with torch.cuda.device(dev):
        h32, l32 = _low32(hi), _low32(lo)
        n32 = nbits.contiguous()
        words, bits = _outputs(B, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jz_pack_words(h32.data_ptr(), l32.data_ptr(),
                               n32.data_ptr(), words.data_ptr(),
                               bits.data_ptr(), B, stream)
    _raise_on("pack_words", lib, rc)
    if B > 0:  # the launcher returns without a launch for an empty batch
        with _lock:
            launches += 1
    return words, bits


def huffman_tables_i32(device: torch.device, chroma: bool):
    """The component's fixed Annex K tables (dc_code, dc_size, ac_code,
    ac_size) as int32 tensors on `device`, made once per device."""
    key = (device, bool(chroma))
    tabs = _tables.get(key)
    if tabs is None:
        c = codec_constants(device)
        p = "c_" if chroma else "y_"
        tabs = tuple(c[p + k].to(torch.int32).contiguous()
                     for k in ("dc_code", "dc_size", "ac_code", "ac_size"))
        _tables[key] = tabs
    return tabs


def encode_blocks_cuda(q: torch.Tensor, pred: torch.Tensor, tables):
    """CUDA form of entropy.encode_block_words: block_emissions and
    pack_block_words in one kernel, the emissions never stored.

    q: [B, 64] int32 quantized blocks, natural order; pred: [B] int32 DC
    predictors; tables: False/True for the fixed luma/chroma Huffman
    tables, or (dc_code [12], dc_size [12], ac_code [162], ac_size [162])
    int32 tensors on q's device.  Returns (words [B, 64] int64 in
    [0, 2**32), bits [B] int32), on the inputs' device and stream."""
    global encode_launches
    if q.dim() != 2 or q.shape[1] != 64:
        raise ValueError(f"encode_blocks_cuda: q has shape {tuple(q.shape)}, "
                         "want [B, 64]")
    B = q.shape[0]
    _check("encode_blocks_cuda", q, ("q", q, torch.int32, q.shape),
           ("pred", pred, torch.int32, (B,)))
    if isinstance(tables, bool):
        tables = huffman_tables_i32(q.device, tables)
    else:
        tables = tuple(tables)
        if len(tables) != 4:
            raise ValueError("encode_blocks_cuda: tables must be a bool or "
                             "(dc_code, dc_size, ac_code, ac_size)")
        _check("encode_blocks_cuda", q, *(
            (name, t, torch.int32, (n,)) for name, t, n in zip(
                ("dc_code", "dc_size", "ac_code", "ac_size"), tables,
                _TABLE_LENGTHS)))
        tables = tuple(t.contiguous() for t in tables)
    lib = get_lib()
    dev = q.device
    with torch.cuda.device(dev):
        qc, pc = q.contiguous(), pred.contiguous()
        words, bits = _outputs(B, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jz_encode_blocks(qc.data_ptr(), pc.data_ptr(),
                                  *(t.data_ptr() for t in tables),
                                  words.data_ptr(), bits.data_ptr(), B,
                                  stream)
    _raise_on("encode_blocks", lib, rc)
    if B > 0:  # the launcher returns without a launch for an empty batch
        with _lock:
            encode_launches += 1
    return words, bits
