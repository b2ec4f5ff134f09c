"""Wrapper of the hand-written CUDA Huffman scan (csrc/huffman_scan.cu).

decode_segments_cuda is the CUDA form of entropy_decode.decode_segments.
It replaces jpezy_tpu/ops/entropy_decode.py:decode_segments (a lockstep
scan that XLA fused on the TPU).  One warp decodes one restart segment (or
pseudo-segment): the segment's row of destuffed words sits in the warp's
registers, one word a thread, and refills the 64-bit window by a shuffle;
codes of at most FIRST_LEVEL_BITS bits are answered by a first-level table
that each thread block builds in shared memory from the full LUT
(entropy_decode.first_level_table is the rule), longer codes and invalid
windows by the full LUT in the L1 and L2 caches; a decode step runs
without branches on table entries split into the fields it needs; the
current 8x8 block is held in two registers per thread and leaves with one
coalesced 128-byte store.  The kernel writes every block slot, the
undecoded ones as zeros, so the blocks are allocated without clearing
them.  The function must move each row, the LUT and the
[S, max_blocks, 64] int16 blocks once; the kernel is bound instead by each
segment's serial chain of symbols, and then by the rate at which an SM's
schedulers dispatch instructions (see the source's header and PERF.md).

The library is built at first use and loaded with ctypes by
ops/cuda_build.py.  A failed build or launch raises; nothing falls back to
entropy_decode.decode_segments_plain.

`launches` counts launches of the kernel, so a run can show that its path
went through it.
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
    for fn in (lib.jz_scan_warps_per_block, lib.jz_scan_first_level_bits,
               lib.jz_scan_blocks_per_sm):
        fn.restype = ci
        fn.argtypes = []


LIB = KernelLibrary("huffman_scan.cu", _bind)

_lock = threading.Lock()
launches = 0


def layout() -> dict:
    """How the built kernel is laid out on the card: segments (warps) per
    thread block, index bits of the first-level table, thread blocks one
    SM holds at a time."""
    lib = LIB.get()
    return {"warps_per_block": lib.jz_scan_warps_per_block(),
            "first_level_bits": lib.jz_scan_first_level_bits(),
            "blocks_per_sm": lib.jz_scan_blocks_per_sm()}


def _launch(args, blocks, bad) -> None:
    """Launch the kernel on checked, contiguous CUDA tensors
    args = (words, nblk, lut [T, 6, 65536], tsel, rawlen, skip0, preds0;
    the last four may be None) into blocks [S, max_blocks, 64] int16 and
    bad [S] uint8, on the current stream.  Whatever `blocks` held is
    overwritten: the kernel writes every slot."""
    global launches
    lib = LIB.get()
    words, lut = args[0], args[2]
    S, Lw = words.shape
    max_blocks = blocks.shape[1]
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = lib.jz_decode_segments(
            *(None if t is None else t.data_ptr() for t in args),
            blocks.data_ptr(), bad.data_ptr(), S, Lw, lut.shape[0],
            max_blocks, stream)
    LIB.raise_on("decode_segments", rc)
    if S > 0 and max_blocks > 0:  # else the launcher returns with no launch
        with _lock:
            launches += 1


def prepare(words, nblk, lut, tsel=None, rawlen=None, skip0=None,
            preds0=None, *, max_blocks: int):
    """Checks decode_segments_cuda's arguments and returns (args, blocks,
    bad): the contiguous inputs in the order _launch takes them (lut as
    [T, 6, 65536]), and the uncleared outputs on the inputs' device."""
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
    dev = words.device
    with torch.cuda.device(dev):
        args = [None if t is None else t.contiguous()
                for t in (words, nblk, lut, tsel, rawlen, skip0, preds0)]
        # not cleared: the kernel writes every slot
        blocks = torch.empty((S, max_blocks, 64), dtype=torch.int16,
                             device=dev)
        bad = torch.empty((S,), dtype=torch.uint8, device=dev)
    return args, blocks, bad


def decode_segments_cuda(words, nblk, lut, tsel=None, rawlen=None,
                         skip0=None, preds0=None, *, max_blocks: int):
    """CUDA form of entropy_decode.decode_segments (arguments as there).

    words: [S, Lw] int32 (uint32 bit patterns); nblk [S] int32; lut
    [T, 6, 65536] or [6, 65536] int32; tsel, rawlen, skip0 [S] int32 and
    preds0 [S, 3] int32 are optional.  Returns (blocks [S, max_blocks, 64]
    int16, bad [S] bool) on the inputs' device and stream."""
    args, blocks, bad = prepare(words, nblk, lut, tsel, rawlen, skip0,
                                preds0, max_blocks=max_blocks)
    _launch(args, blocks, bad)
    return blocks, bad.bool()
