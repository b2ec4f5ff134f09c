"""Wrapper of the hand-written CUDA stream concat (csrc/stream_concat.cu).

concat_streams_cuda is the CUDA form of entropy.concat_streams_plain: the
batch's packed blocks, kept per component as the entropy kernel wrote
them, become each image's entropy stream at its MCU-order bit offsets,
with byte-aligned restart segments when a restart interval is given.  It
replaces the concat that XLA fused behind the Pallas pack on the TPU
(jpezy_tpu/codec/jax_codec.py:_concat_batch_combined_comp with
jpezy_tpu/ops/entropy.py:stream_offsets_batch,
stream_offsets_restart_batch and _concat_batch_scatter).  Two launches a
call: a scan of the bit counts, one thread block an image (and a few
that zero the streams), then a scatter of the used words, each warp's 32
blocks' output words as one list over its lanes; the design and what
bounds it are in the source's header.

The library is built at first use and loaded with ctypes by
ops/cuda_build.py.  A failed build or launch raises; nothing falls back to
the plain version.

`launches` counts calls that launched the kernels (one a call, though a
call launches two), so a run can show that its path went through them.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .cuda_build import KernelLibrary, check_tensors

WORDS_PER_BLOCK = 64


def _bind(lib) -> None:
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.jz_concat_streams.restype = ci
    lib.jz_concat_streams.argtypes = [vp] * 8 + [ll] * 5 + [vp]


LIB = KernelLibrary("stream_concat.cu", _bind)

_lock = threading.Lock()
launches = 0


def concat_streams_cuda(words, bits, *, maxw: int,
                        restart_interval: int = 0) -> torch.Tensor:
    """Per-component packed blocks -> combined [N, 1 + S + maxw] int64.

    words: (Y, Cb, Cr) int64 [N, B_c, 64] words in [0, 2**32), zero past
    each block's bits (what the entropy kernel writes); bits: (Y, Cb, Cr)
    int32 [N, B_c]; B_Y = 4 nm and B_Cb = B_Cr = nm for nm MCUs an image.
    Column 0 of each row is the image's total bits, then with
    restart_interval > 0 the S = ceil(nm / restart_interval) segments' bit
    counts, then the stream (words past maxw are dropped).  On the inputs'
    device and stream."""
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
        specs += [(f"{name} words", w, torch.int64,
                   (N, per_mcu * nm, WORDS_PER_BLOCK)),
                  (f"{name} bits", b, torch.int32, (N, per_mcu * nm))]
    check_tensors("concat_streams_cuda", words[0], *specs)
    if nm <= 0 or maxw <= 0 or restart_interval < 0:
        raise ValueError(f"concat_streams_cuda: nm={nm}, maxw={maxw}, "
                         f"restart_interval={restart_interval}")
    ri = restart_interval
    nseg = -(-nm // ri) if ri else 0
    lib = LIB.get()
    dev = words[0].device
    with torch.cuda.device(dev):
        ws = [w.contiguous() for w in words]
        bs = [b.contiguous() for b in bits]
        goff = torch.empty((N, 6 * nm), dtype=torch.int64, device=dev)
        combined = torch.empty((N, 1 + nseg + maxw), dtype=torch.int64,
                               device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jz_concat_streams(
            *(t.data_ptr() for t in ws + bs), goff.data_ptr(),
            combined.data_ptr(), N, nm, ri, nseg, maxw, stream)
    LIB.raise_on("concat_streams", rc)
    if N > 0:
        with _lock:
            launches += 1
    return combined
