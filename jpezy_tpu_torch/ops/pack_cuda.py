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

The library is built at first use and loaded with ctypes by
ops/cuda_build.py.  A failed build or launch raises; nothing falls back to
the plain torch versions.

`launches` counts launches of the pack kernel made through
pack_words_cuda and `encode_launches` those of the fused kernel made
through encode_blocks_cuda, so a run can show which kernels its path went
through.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..constants import codec_constants
from .cuda_build import KernelLibrary, check_tensors as _check


def _bind(lib) -> None:
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.jz_pack_words.restype = ci
    lib.jz_pack_words.argtypes = [vp, vp, vp, vp, vp, ll, vp]
    lib.jz_encode_blocks.restype = ci
    lib.jz_encode_blocks.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ll, vp]


LIB = KernelLibrary("entropy_pack.cu", _bind)

_lock = threading.Lock()
launches = 0
encode_launches = 0
# int32 copies of the fixed Huffman tables, one set per (device, chroma)
_tables: dict = {}
_TABLE_LENGTHS = (12, 12, 162, 162)  # dc_code, dc_size, ac_code, ac_size


def _low32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same 32-bit
    pattern: the low half of each little-endian int64, picked from a view
    of the same memory (no reliance on a wrapping cast)."""
    return x.contiguous().view(torch.int32)[..., ::2].contiguous()


def _outputs(B: int, dev: torch.device):
    return (torch.empty((B, 64), dtype=torch.int64, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev))


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
    lib = LIB.get()
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
    LIB.raise_on("pack_words", rc)
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
    lib = LIB.get()
    dev = q.device
    with torch.cuda.device(dev):
        qc, pc = q.contiguous(), pred.contiguous()
        words, bits = _outputs(B, dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jz_encode_blocks(qc.data_ptr(), pc.data_ptr(),
                                  *(t.data_ptr() for t in tables),
                                  words.data_ptr(), bits.data_ptr(), B,
                                  stream)
    LIB.raise_on("encode_blocks", rc)
    if B > 0:  # the launcher returns without a launch for an empty batch
        with _lock:
            encode_launches += 1
    return words, bits
