"""The earlier designs of five of jpezy_tpu_torch's kernels, built from
scripts/previous_designs.cu with the package's loader, so that
chip_smoke.py times them beside the current kernels in one run, on the
same inputs and the same card.  Nothing in the package calls them.

  encode_stage       the entropy stage as torch_codec._emit_local ran it
                     before the kernel found the predictors: per
                     component the plain torch predictor chain
                     (entropy.dc_predictors_restart on the card), then one
                     launch of the per-component fused kernel; three
                     launches and the chains' events a batch.
  concat_two_pass    the stream concat's two-pass design: a scan of the
                     bit counts, one thread block an image, into an
                     offsets scratch [N, 6 nm] (and thread blocks that zero
                     the streams), then a scatter of the used words with
                     atomicOr on shared words; two launches a call.
  fdct_quantize_exact_first, idct_planes_exact_first
                     exact mode's first float64 kernels, with the
                     arguments and results of exact_cuda's
                     fdct_quantize_exact_cuda and idct_planes_exact_cuda:
                     every term of every block issued (products by
                     exactly 1 and first adds onto +0 included), and each
                     block's own nonzero mask walked with the tables in
                     shared memory.
  idct_planes_rgb_first
                     the first fast rgb IDCT, with the arguments and
                     results of exact_cuda.idct_planes_rgb_cuda: a lane a
                     column of its block, 8 products and 8 adds a term,
                     each block's own nonzero mask walked with the float32
                     basis in shared memory.

All raise without a card; none falls back.
"""
from __future__ import annotations

import ctypes
import os

import torch

import numpy as np

from jpezy_tpu_torch.constants import EXACT_TABLES
from jpezy_tpu_torch.ops import entropy as E
from jpezy_tpu_torch.ops import exact_cuda
from jpezy_tpu_torch.ops.cuda_build import KernelLibrary
from jpezy_tpu_torch.ops.pack_cuda import annex_k_row
from jpezy_tpu_torch.ops.transform_cuda import _inverse_basis_t

KERNEL_INFO = ("encode_blocks per component", "concat_streams pass 1",
               "concat_streams pass 2", "fdct_quantize_exact first int8",
               "idct_planes_exact first int16", "idct_planes_rgb first int16")


def _bind(lib) -> None:
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.jz_prev_encode_blocks.restype = ci
    lib.jz_prev_encode_blocks.argtypes = [vp, vp, vp, ci, ci, ll, vp, vp, ll,
                                          vp]
    lib.jz_prev_concat_streams.restype = ci
    lib.jz_prev_concat_streams.argtypes = [vp] * 8 + [ll] * 5 + [vp]
    lib.jz_prev_fdct_quantize_exact.restype = ci
    lib.jz_prev_fdct_quantize_exact.argtypes = [ci] + [vp] * 11
    lib.jz_prev_idct_planes_exact.restype = ci
    lib.jz_prev_idct_planes_exact.argtypes = [ci] + [vp] * 8
    lib.jz_prev_idct_planes_rgb.restype = ci
    lib.jz_prev_idct_planes_rgb.argtypes = [ci] + [vp] * 8
    lib.jz_prev_kernel_info.restype = ci
    lib.jz_prev_kernel_info.argtypes = [ci, vp]


LIB = KernelLibrary("previous_designs.cu", _bind,
                    directory=os.path.dirname(os.path.abspath(__file__)))


def kernel_info() -> dict:
    """{kernel: (registers a thread, resident thread blocks an SM, static
    shared bytes, local bytes a thread, threads a block)} on this card."""
    lib = LIB.get()
    out = {}
    for i, name in enumerate(KERNEL_INFO):
        info = (ctypes.c_int * 5)()
        LIB.raise_on(f"kernel_info({name})", lib.jz_prev_kernel_info(i, info))
        out[name] = tuple(info)
    return out


def encode_stage(yq, cbq, crq, restart_interval: int = 0):
    """(words, bits) per component of the batch's quantized blocks [N,
    B_c, 64] int32 on the card, with the fixed tables, as the encode
    program made them before the batched kernel."""
    lib = LIB.get()
    words, bits = [], []
    for q, chroma, bpm in ((yq, False, 4), (cbq, True, 1), (crq, True, 1)):
        n, b, _ = q.shape
        pred = E.dc_predictors_restart(q[:, :, 0], restart_interval * bpm)
        pred = pred.reshape(-1).to(torch.int32).contiguous()
        qc = q.reshape(-1, 64).contiguous()
        w = torch.empty((n * b, 64), dtype=torch.int64, device=q.device)
        bt = torch.empty((n * b,), dtype=torch.int32, device=q.device)
        rc = lib.jz_prev_encode_blocks(
            qc.data_ptr(), pred.data_ptr(),
            annex_k_row(q.device, chroma).data_ptr(), 1, 0, 0, w.data_ptr(),
            bt.data_ptr(), n * b, torch.cuda.current_stream().cuda_stream)
        LIB.raise_on("prev_encode_blocks", rc)
        words.append(w.reshape(n, b, 64))
        bits.append(bt.reshape(n, b))
    return tuple(words), tuple(bits)


def concat_two_pass(words, bits, *, maxw: int, restart_interval: int = 0):
    """combined [N, 1 + S + maxw] int64 of the two-pass design, from the
    per-component (words, bits) that encode_stage or the current kernel
    returns."""
    lib = LIB.get()
    N, nm = bits[1].shape
    ri = restart_interval
    nseg = -(-nm // ri) if ri else 0
    dev = words[0].device
    ws = [w.contiguous() for w in words]
    bs = [b.to(torch.int32).contiguous() for b in bits]
    goff = torch.empty((N, 6 * nm), dtype=torch.int64, device=dev)
    combined = torch.empty((N, 1 + nseg + maxw), dtype=torch.int64,
                           device=dev)
    rc = lib.jz_prev_concat_streams(
        *(t.data_ptr() for t in ws + bs), goff.data_ptr(),
        combined.data_ptr(), N, nm, ri, nseg, maxw,
        torch.cuda.current_stream().cuda_stream)
    LIB.raise_on("prev_concat_streams", rc)
    return combined


def fdct_quantize_exact_first(y, cb, cr, yqt, cqt, *, gray: bool = False,
                              rounded: bool = False):
    """exact_cuda.fdct_quantize_exact_cuda's result from the first exact
    forward kernel: (yq [N, 4 nm, 64], cbq, crq [N, nm, 64]) int32."""
    lib = LIB.get()
    N, H, W = y.shape
    my, mx = H // 16, W // 16
    desc = np.array([N, my, mx, int(gray), int(rounded), *y.stride(),
                     *cb.stride(), *cr.stride()], np.int64)
    tabs = [t.contiguous() for t in (yqt, cqt)]
    outs = [torch.empty((N, k * my * mx, 64), dtype=torch.int32,
                        device=y.device) for k in (4, 1, 1)]
    rc = lib.jz_prev_fdct_quantize_exact(
        {torch.int8: 1, torch.int32: 4}[y.dtype], desc.ctypes.data,
        EXACT_TABLES.ctypes.data,
        *(t.data_ptr() for t in (y, cb, cr, *tabs, *outs)),
        torch.cuda.current_stream().cuda_stream)
    LIB.raise_on("prev_fdct_quantize_exact", rc)
    return tuple(outs)


def _inverse_desc(coeff_all, *, geom, level: int, gray: bool, sizes):
    """The inverse kernels' desc (exact_cuda._inverse's) and their planes."""
    N = coeff_all.shape[0]
    used = 1 if gray else len(sizes)
    comps, first = [], 0
    for c in range(3):
        comps += ([sizes[c], int(geom[c][2]), int(geom[c][3]), first]
                  if c < used else [0, 0, 0, 0])
        first += sizes[c] if c < len(sizes) else 0
    mcus_y, mcus_x = (int(x) for x in geom[0][:2])
    desc = np.array([N, used, mcus_x, sum(sizes), level, *comps], np.int64)
    outs = [torch.empty((N, mcus_y * int(g[2]) * 8, mcus_x * int(g[3]) * 8),
                        dtype=torch.int32, device=coeff_all.device)
            for g in geom[:used]]
    return desc, outs


def idct_planes_exact_first(coeff_all, qtab, *, geom, level: int,
                            gray: bool, sizes):
    """exact_cuda.idct_planes_exact_cuda's planes from the first exact
    inverse kernel (coeff_all contiguous and 16-byte aligned)."""
    lib = LIB.get()
    desc, outs = _inverse_desc(coeff_all, geom=geom, level=level, gray=gray,
                               sizes=sizes)
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    q = qtab.contiguous()
    rc = lib.jz_prev_idct_planes_exact(
        exact_cuda._COEFF_BYTES[coeff_all.dtype], desc.ctypes.data,
        EXACT_TABLES.ctypes.data, coeff_all.data_ptr(), q.data_ptr(), *ptrs,
        torch.cuda.current_stream().cuda_stream)
    LIB.raise_on("prev_idct_planes_exact", rc)
    return outs


def idct_planes_rgb_first(coeff_all, qtab, *, geom, level: int, gray: bool,
                          sizes):
    """exact_cuda.idct_planes_rgb_cuda's planes from the first fast rgb
    IDCT kernel (coeff_all contiguous and 16-byte aligned)."""
    lib = LIB.get()
    desc, outs = _inverse_desc(coeff_all, geom=geom, level=level, gray=gray,
                               sizes=sizes)
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    q = qtab.contiguous()
    rc = lib.jz_prev_idct_planes_rgb(
        exact_cuda._COEFF_BYTES[coeff_all.dtype], desc.ctypes.data,
        _inverse_basis_t(coeff_all.device).data_ptr(), coeff_all.data_ptr(),
        q.data_ptr(), *ptrs, torch.cuda.current_stream().cuda_stream)
    LIB.raise_on("prev_idct_planes_rgb", rc)
    return outs
