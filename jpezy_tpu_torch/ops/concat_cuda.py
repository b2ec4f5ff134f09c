"""Wrapper of the hand-written CUDA stream concat (csrc/stream_concat.cu).

concat_streams_cuda is the CUDA form of entropy.concat_streams_plain: the
batch's packed blocks, kept per component as the entropy kernel wrote
them, become each image's entropy stream at its MCU-order bit offsets,
with byte-aligned restart segments when a restart interval is given.  It
replaces the concat that XLA fused behind the Pallas pack on the TPU
(jpezy_tpu/codec/jax_codec.py:_concat_batch_combined_comp with
jpezy_tpu/ops/entropy.py:stream_offsets_batch,
stream_offsets_restart_batch and _concat_batch_scatter).  One launch a
call and no scratch: a thread block a tile of an image's MCUs
(tile_layout) re-reduces the bit counts from the image's start to its
tile's end, keeps its MCUs' offsets in shared memory, and assembles each
stream word it owns in a shared-memory stage from the blocks that overlap
it; every word, zeros included, leaves as one plain store.  The design
and what bounds it are in the source's header.

The library is built at first use and loaded with ctypes by
ops/cuda_build.py.  A failed build or launch raises; nothing falls back to
the plain version.

`launches` counts calls that launched the kernel, so a run can show that
its path went through it.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .cuda_build import KernelLibrary, check_tensors

WORDS_PER_BLOCK = 64
# An image's tiles: about TILE_MCUS MCUs each (at least 8 tiles a 512x512
# image of 1,024 MCUs), at most MAX_TILES of them (each tile re-reduces its
# predecessors' bit counts, so an image's counts are read at most
# MAX_TILES / 2 times), unless a tile would then pass MAX_TILE_MCUS, the
# kernel's shared-memory offsets (kMaxTileMcus).
TILE_MCUS = 128
MAX_TILES = 16
MAX_TILE_MCUS = 2048


def _bind(lib) -> None:
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.jz_concat_streams.restype = ci
    lib.jz_concat_streams.argtypes = [vp] * 7 + [ll] * 7 + [vp]
    lib.jz_concat_kernel_info.restype = ci
    lib.jz_concat_kernel_info.argtypes = [vp]


LIB = KernelLibrary("stream_concat.cu", _bind)

_lock = threading.Lock()
launches = 0


def tile_layout(nm: int) -> tuple[int, int]:
    """(tiles an image, MCUs a tile but the last) of the kernel for
    images of nm MCUs: 8 tiles of 128 MCUs at 512x512, 16 of 2,025 at
    3840x2160."""
    tiles = max(min(MAX_TILES, -(-nm // TILE_MCUS)),
                -(-nm // MAX_TILE_MCUS), 1)
    mcus = -(-nm // tiles)
    return -(-nm // mcus), mcus


def kernel_info() -> tuple[int, ...]:
    """(registers a thread, resident thread blocks an SM, static shared
    bytes, local bytes a thread, threads a block) of the kernel, as
    cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor
    report them on the current card."""
    lib = LIB.get()
    info = (ctypes.c_int * 5)()
    LIB.raise_on("concat kernel_info", lib.jz_concat_kernel_info(info))
    return tuple(info)


def concat_streams_cuda(words, bits, *, maxw: int,
                        restart_interval: int = 0) -> torch.Tensor:
    """Per-component packed blocks -> combined [N, 1 + S + maxw] int64.

    words: (Y, Cb, Cr) int32 [N, B_c, 64] holding 32-bit words' patterns,
    zero past each block's bits (what the entropy kernel writes; the
    kernel loads only each block's used words); bits: (Y, Cb, Cr)
    int32 [N, B_c]; B_Y = 4 nm and B_Cb = B_Cr = nm for nm MCUs an image.
    Column 0 of each row is the image's total bits, then with
    restart_interval > 0 the S = ceil(nm / restart_interval) segments' bit
    counts, then the stream (words past maxw are dropped).  On the
    inputs' device and stream."""
    global launches
    if len(words) != 3 or len(bits) != 3:
        raise ValueError("concat_streams_cuda: words and bits must be "
                         "(Y, Cb, Cr) triples")
    if bits[1].dim() != 2:
        raise ValueError(f"concat_streams_cuda: Cb bits have shape "
                         f"{tuple(bits[1].shape)}, want [N, nm]")
    N, nm = bits[1].shape
    specs = []
    for name, w, b, per_mcu in zip(("Y", "Cb", "Cr"), words, bits, (4, 1, 1)):
        specs += [(f"{name} words", w, torch.int32,
                   (N, per_mcu * nm, WORDS_PER_BLOCK)),
                  (f"{name} bits", b, torch.int32, (N, per_mcu * nm))]
    check_tensors("concat_streams_cuda", words[0], *specs)
    if nm <= 0 or maxw <= 0 or restart_interval < 0:
        raise ValueError(f"concat_streams_cuda: nm={nm}, maxw={maxw}, "
                         f"restart_interval={restart_interval}")
    ntiles, tile_mcus = tile_layout(nm)
    ri = restart_interval
    nseg = -(-nm // ri) if ri else 0
    lib = LIB.get()
    dev = words[0].device
    with torch.cuda.device(dev):
        ws = [w.contiguous() for w in words]
        bs = [b.contiguous() for b in bits]
        # the kernel reads an MCU's four Y counts as one 16-byte load
        if bs[0].data_ptr() % 16:
            bs[0] = bs[0].clone()
        # every element is written by the kernel
        combined = torch.empty((N, 1 + nseg + maxw), dtype=torch.int64,
                               device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jz_concat_streams(
            *(t.data_ptr() for t in ws + bs), combined.data_ptr(), N, nm, ri,
            nseg, maxw, tile_mcus, ntiles, stream)
    LIB.raise_on("concat_streams", rc)
    if N > 0:
        with _lock:
            launches += 1
    return combined
