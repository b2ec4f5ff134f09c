"""Loader and wrappers of the hand-written CUDA entropy kernels
(csrc/entropy_pack.cu).

Replaces the Pallas TPU kernel jpezy_tpu/ops/pack_pallas.py, and the
symbol counts of the optimized encode (jpezy_tpu/codec/jax_codec.py:
_symbol_histograms_batch over entropy.symbol_histograms, XLA-fused on
the TPU).  The source holds one
warp-per-block pack routine and three entry points:

  pack_words_cuda     merged emissions (hi, lo, nbits) -> packed words; the
                      one-to-one counterpart of the Pallas kernel.  Per
                      block the function reads 768 bytes and writes 260
                      (64 32-bit words and a count): a bound of 1,028.
  encode_blocks_batch_cuda
                      a batch's three components of quantized blocks +
                      Huffman tables -> packed 32-bit words per
                      component, one launch, a warp a run of 32 blocks
                      staged in shared memory by asynchronous copies
                      with their table sets, a lane a block coded into
                      its words, the DC predictors found in the kernel;
                      the encode program calls this one.  Takes
                      the fixed tables, or the caller's: one set or one
                      per image (optimize), with emissions of up to 74
                      bits.  Per block the function reads 256 bytes and
                      writes 260: a bound of 516, which is what it
                      moves.
  symbol_histograms_batch_cuda
                      a batch's three components of quantized blocks ->
                      per-image symbol counts [N, 4, 256] (pass 1 of
                      optimize), one launch, the DC predictors derived
                      in the kernel.  Per block it reads 256 bytes, per
                      image it writes 4 KB.

All are bound by memory traffic; their designs are described in the
source's header.  The fused kernel's words come back as int32 tensors
holding the 32-bit patterns (words at or above 2**31 read negative): the
layout the stream concat kernel reads (ops/concat_cuda.py), so no byte
beyond the bound is moved; torch on the card compares and shifts them as
signed, so nothing but the concat and the host (which views them as
uint32) should read them.  The pack alone keeps the int64 convention of
ops/entropy.py, values in [0, 2**32).

The library is built at first use and loaded with ctypes by
ops/cuda_build.py.  A failed build or launch raises; nothing falls back to
the plain torch versions.

`launches` counts launches of the pack kernel made through
pack_words_cuda, `encode_launches` those of the fused kernel made through
encode_blocks_batch_cuda and `histogram_launches` those of the histogram kernel
made through symbol_histograms_batch_cuda, so a run can show which
kernels its path went through.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .cuda_build import KernelLibrary, check_tensors as _check

KERNEL_ROW = 2 * (12 + 162)  # one table set: dc_code, dc_size, ac_code, ac_size


def _bind(lib) -> None:
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.jz_pack_words.restype = ci
    lib.jz_pack_words.argtypes = [vp, vp, vp, vp, vp, ll, vp]
    lib.jz_encode_blocks_batch.restype = ci
    lib.jz_encode_blocks_batch.argtypes = [vp] * 5 + [ci, ci] + [vp] * 7 + [
        ll] * 4 + [vp]
    lib.jz_symbol_histograms_batch.restype = ci
    lib.jz_symbol_histograms_batch.argtypes = [vp, vp, vp, vp, vp, ll, ll, ll,
                                               ll, vp]
    lib.jz_entropy_kernel_info.restype = ci
    lib.jz_entropy_kernel_info.argtypes = [ci, vp]


LIB = KernelLibrary("entropy_pack.cu", _bind)

_lock = threading.Lock()
launches = 0
encode_launches = 0
histogram_launches = 0
# the fixed Annex K tables as the kernel's row, per (device, chroma)
_rows: dict = {}
# the kernels' instantiations, in jz_entropy_kernel_info's order
KERNEL_INFO = ("encode_blocks fixed tables", "encode_blocks custom tables",
               "symbol_histograms", "pack_words")


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
    from .entropy import words32

    lib = LIB.get()
    B = hi.shape[0]
    dev = hi.device
    with torch.cuda.device(dev):
        h32, l32 = words32(hi).contiguous(), words32(lo).contiguous()
        n32 = nbits.contiguous()
        words = torch.empty((B, 64), dtype=torch.int64, device=dev)
        bits = torch.empty((B,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jz_pack_words(h32.data_ptr(), l32.data_ptr(),
                               n32.data_ptr(), words.data_ptr(),
                               bits.data_ptr(), B, stream)
    LIB.raise_on("pack_words", rc)
    if B > 0:  # the launcher returns without a launch for an empty batch
        with _lock:
            launches += 1
    return words, bits


def annex_k_row(device: torch.device, chroma: bool) -> torch.Tensor:
    """The component's fixed Annex K Huffman tables as the kernel's
    [1, 348] int32 row on `device` (entropy.kernel_tables), made once per
    device."""
    key = (device, bool(chroma))
    row = _rows.get(key)
    if row is None:
        from . import entropy as E

        row = E.kernel_tables(E.annex_k_tables(torch.device("cpu"), chroma),
                              device)
        _rows[key] = row
    return row


def kernel_info() -> dict:
    """{instantiation: (registers a thread, resident thread blocks an SM,
    static shared bytes, local bytes a thread, threads a block)} as
    cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor
    report them on the current card."""
    lib = LIB.get()
    out = {}
    for i, name in enumerate(KERNEL_INFO):
        info = (ctypes.c_int * 5)()
        LIB.raise_on(f"kernel_info({name})",
                     lib.jz_entropy_kernel_info(i, info))
        out[name] = tuple(info)
    return out


def encode_blocks_batch_cuda(yq: torch.Tensor, cbq: torch.Tensor,
                             crq: torch.Tensor, *, restart_interval: int = 0,
                             carry: torch.Tensor | None = None,
                             tables=None):
    """CUDA form of entropy.encode_blocks_batch_plain, one launch for the
    three components: block_emissions and pack_block_words in one kernel,
    the emissions never stored, each block's DC predictor found in the
    kernel, the words stored as 32-bit words.

    yq [N, B_Y, 64], cbq and crq [N, B_C, 64] int32 quantized blocks in
    natural order; each component of an image is one DC chain, reset
    every restart_interval MCUs (4 blocks of Y, 1 of Cb and of Cr);
    carry: None, or [N, 3] int32 first predictors (a tile shard's
    carry-in).  tables: None for the fixed Annex K tables, or the
    caller's (luma, chroma) as the kernel's rows, int32 [T, 348] tensors
    on the blocks' device (entropy.kernel_tables builds them from the JAX
    order), T = 1 for the batch or N, one set an image; their emissions
    may exceed 64 bits.  Returns ((words_Y, words_Cb, words_Cr) [N, B_c,
    64] int32 holding the 32-bit words' patterns, (bits_Y, bits_Cb,
    bits_Cr) [N, B_c] int32), on the inputs' device and stream.  The
    kernel copies the blocks and the table rows 16 bytes at a time, from
    16-byte addresses: a contiguous tensor whose data is not 16-byte
    aligned (a view at an odd offset) is refused; a non-contiguous one is
    copied, and the copy is aligned."""
    global encode_launches
    if yq.dim() != 3 or yq.shape[2] != 64 or cbq.dim() != 3:
        raise ValueError(f"encode_blocks_batch_cuda: yq has shape "
                         f"{tuple(yq.shape)}, cbq {tuple(cbq.shape)}, want "
                         "[N, B, 64] each")
    named = [("yq", yq), ("cbq", cbq), ("crq", crq)]
    if tables is not None and len(tables) == 2:
        named += [("luma tables", tables[0]), ("chroma tables", tables[1])]
    for name, t in named:
        if (isinstance(t, torch.Tensor) and t.is_contiguous()
                and t.numel() and t.data_ptr() % 16):
            raise ValueError(f"encode_blocks_batch_cuda: {name} is not "
                             "16-byte aligned (the kernel's 16-byte copies "
                             "need it); pass a fresh tensor (.clone())")
    N = yq.shape[0]
    specs = [("yq", yq, torch.int32, yq.shape),
             ("cbq", cbq, torch.int32, (N, cbq.shape[1], 64)),
             ("crq", crq, torch.int32, cbq.shape)]
    if carry is not None:
        specs.append(("carry", carry, torch.int32, (N, 3)))
    custom = tables is not None
    if custom:
        if len(tables) != 2 or not all(isinstance(t, torch.Tensor)
                                       and t.dim() == 2 for t in tables):
            raise ValueError("encode_blocks_batch_cuda: tables must be None "
                             "or the kernel's (luma, chroma) rows [T, 348] "
                             "(entropy.kernel_tables)")
        rows = tables
    else:
        rows = (annex_k_row(yq.device, False), annex_k_row(yq.device, True))
    nsets = rows[0].shape[0]
    specs += [("luma tables", rows[0], torch.int32, (nsets, KERNEL_ROW)),
              ("chroma tables", rows[1], torch.int32, (nsets, KERNEL_ROW))]
    _check("encode_blocks_batch_cuda", yq, *specs)
    if nsets not in (1, N) or restart_interval < 0 or 0 in (yq.shape[1],
                                                            cbq.shape[1]):
        raise ValueError(f"encode_blocks_batch_cuda: {nsets} table sets for "
                         f"{N} images, restart_interval={restart_interval}, "
                         f"blocks {yq.shape[1]} and {cbq.shape[1]}")
    lib = LIB.get()
    dev = yq.device
    with torch.cuda.device(dev):
        qs = [t.contiguous() for t in (yq, cbq, crq)]
        rs = [r.contiguous() for r in rows]
        cc = None if carry is None else carry.contiguous()
        outs = [(torch.empty((N, q.shape[1], 64), dtype=torch.int32,
                             device=dev),
                 torch.empty((N, q.shape[1]), dtype=torch.int32, device=dev))
                for q in qs]
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jz_encode_blocks_batch(
            *(t.data_ptr() for t in qs + rs), nsets, int(custom),
            None if cc is None else cc.data_ptr(),
            *(w.data_ptr() for w, _ in outs), *(b.data_ptr() for _, b in outs),
            N, yq.shape[1], cbq.shape[1], restart_interval, stream)
    LIB.raise_on("encode_blocks_batch", rc)
    if N > 0:  # the launcher returns without a launch for an empty batch
        with _lock:
            encode_launches += 1
    return tuple(w for w, _ in outs), tuple(b for _, b in outs)


def symbol_histograms_batch_cuda(yq: torch.Tensor, cbq: torch.Tensor,
                                 crq: torch.Tensor, *,
                                 restart_interval: int = 0,
                                 carry: torch.Tensor | None = None):
    """CUDA form of entropy.symbol_histograms_batch_plain, one launch for
    the three components: per-image Huffman symbol counts [N, 4, 256]
    int32 (Y DC, Y AC, chroma DC, chroma AC; Cb and Cr summed).

    yq [N, B_Y, 64], cbq and crq [N, B_C, 64] int32 quantized blocks in
    natural order; the kernel derives each block's DC predictor itself
    (entropy.dc_predictors_restart over each image's chain, reset every
    restart_interval MCUs), as encode_blocks_batch_cuda does; carry: None, or [N, 3] int32 first predictors
    (a tile shard's carry-in).  On the inputs' device and stream; the
    counts are zeroed first (a memset) and the kernel adds into them."""
    global histogram_launches
    if yq.dim() != 3 or yq.shape[2] != 64 or cbq.dim() != 3:
        raise ValueError(f"symbol_histograms_batch_cuda: yq has shape "
                         f"{tuple(yq.shape)}, cbq {tuple(cbq.shape)}, want "
                         "[N, B, 64] each")
    N = yq.shape[0]
    specs = [("yq", yq, torch.int32, yq.shape),
             ("cbq", cbq, torch.int32, (N, cbq.shape[1], 64)),
             ("crq", crq, torch.int32, cbq.shape)]
    if carry is not None:
        specs.append(("carry", carry, torch.int32, (N, 3)))
    _check("symbol_histograms_batch_cuda", yq, *specs)
    if restart_interval < 0 or 0 in (yq.shape[1], cbq.shape[1]):
        raise ValueError("symbol_histograms_batch_cuda: restart_interval < 0 "
                         "or a component without blocks")
    lib = LIB.get()
    dev = yq.device
    with torch.cuda.device(dev):
        qs = [t.contiguous() for t in (yq, cbq, crq)]
        cc = None if carry is None else carry.contiguous()
        hist = torch.zeros((N, 4, 256), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jz_symbol_histograms_batch(
            *(t.data_ptr() for t in qs), None if cc is None else cc.data_ptr(),
            hist.data_ptr(), N, yq.shape[1], cbq.shape[1], restart_interval,
            stream)
    LIB.raise_on("symbol_histograms_batch", rc)
    if N > 0:
        with _lock:
            histogram_launches += 1
    return hist
