"""Wrapper of the hand-written CUDA Huffman scan (csrc/huffman_scan.cu).

decode_segments_cuda is the CUDA form of entropy_decode.decode_segments:
one thread per restart segment (or pseudo-segment) walks its row of
destuffed words with a 64-bit window register and one LUT read per
symbol.  It replaces jpezy_tpu/ops/entropy_decode.py:decode_segments (a
lockstep scan that XLA fused on the TPU).  The function must move each
row, the LUT and the [S, max_blocks, 64] int16 blocks once; the kernel is
bound by the latency of each lane's serial chain instead (see the
source's header and PERF.md).

The library is built at first use and loaded with ctypes by
ops/cuda_build.py.  A failed build or launch raises; nothing falls back to
entropy_decode.decode_segments_plain.

`launches` counts launches of the kernel made through
decode_segments_cuda, so a run can show that its path went through it.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .cuda_build import KernelLibrary, check_tensors


def _bind(lib) -> None:
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.jz_decode_segments.restype = ci
    lib.jz_decode_segments.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                       ll, ci, ci, ci, vp]


LIB = KernelLibrary("huffman_scan.cu", _bind)

_lock = threading.Lock()
launches = 0


def decode_segments_cuda(words, nblk, lut, tsel=None, rawlen=None,
                         skip0=None, preds0=None, *, max_blocks: int):
    """CUDA form of entropy_decode.decode_segments (arguments as there).

    words: [S, Lw] int32 (uint32 bit patterns); nblk [S] int32; lut
    [T, 6, 65536] or [6, 65536] int32; tsel, rawlen, skip0 [S] int32 and
    preds0 [S, 3] int32 are optional.  Returns (blocks [S, max_blocks, 64]
    int16, bad [S] bool) on the inputs' device and stream."""
    global launches
    fn = "decode_segments_cuda"
    if lut.dim() == 2:
        lut = lut[None]
    if words.dim() != 2 or words.shape[1] < 1:
        raise ValueError(f"{fn}: words has shape {tuple(words.shape)}, "
                         "want [S, Lw] with Lw >= 1")
    if lut.dim() != 3 or tuple(lut.shape[1:]) != (6, 65536):
        raise ValueError(f"{fn}: lut has shape {tuple(lut.shape)}, "
                         "want [T, 6, 65536]")
    if max_blocks < 0:
        raise ValueError(f"{fn}: max_blocks must be >= 0, got {max_blocks}")
    S, Lw = words.shape
    i32 = torch.int32
    specs = [("words", words, i32, (S, Lw)), ("nblk", nblk, i32, (S,)),
             ("lut", lut, i32, lut.shape)]
    for name, t, shape in (("tsel", tsel, (S,)), ("rawlen", rawlen, (S,)),
                           ("skip0", skip0, (S,)),
                           ("preds0", preds0, (S, 3))):
        if t is not None:
            specs.append((name, t, i32, shape))
    check_tensors(fn, words, *specs)
    lib = LIB.get()
    dev = words.device
    with torch.cuda.device(dev):
        args = [None if t is None else t.contiguous()
                for t in (words, nblk, lut, tsel, rawlen, skip0, preds0)]
        # the kernel stores only the coefficients it decodes
        blocks = torch.zeros((S, max_blocks, 64), dtype=torch.int16,
                             device=dev)
        bad = torch.empty((S,), dtype=torch.uint8, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jz_decode_segments(
            *(None if t is None else t.data_ptr() for t in args),
            blocks.data_ptr(), bad.data_ptr(), S, Lw, lut.shape[0],
            max_blocks, stream)
    LIB.raise_on("decode_segments", rc)
    if S > 0 and max_blocks > 0:  # else the launcher returns with no launch
        with _lock:
            launches += 1
    return blocks, bad.bool()
