"""The earlier designs of nine of jpezy_tpu_torch's kernels, built from
scripts/previous_designs.cu with the package's loader, so that
chip_smoke.py times them beside the current kernels in one run, on the
same inputs and the same card.  Nothing in the package calls them.

  encode_blocks_fused_first
                     the first design of the fused entropy kernel, with
                     the arguments of pack_cuda.encode_blocks_batch_cuda:
                     a warp 2 blocks in registers, gathered by 4-byte
                     loads, tables read through the read-only cache, and
                     the words stored zero-extended, int64 [N, B_c, 64].
  concat_streams_first
                     the stream concat as it read those words, with the
                     arguments of concat_cuda.concat_streams_cuda but int64
                     words: 64-bit word loads.
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
  idct_planes_overflow_first
                     the ycc420 IDCT with the first design of its overflow
                     launch, with the arguments and results of
                     transform_cuda.idct_planes_sparse_cuda: the current
                     sparse launch, then the first overflow launch (a group
                     of 8 lanes a row, every term's coefficient loaded
                     again, the [64][64] basis in shared memory).
  idct_planes_sparse_first
                     the first sparse launch of the ycc420 IDCT (PR 9's
                     design), with the arguments of
                     transform_cuda.idct_planes_sparse_cuda: a group of 8
                     lanes a block over its own mask, the [64][64] basis in
                     shared memory, the strip staged in shared memory; the
                     sparse launch alone (no overflow launch follows, so an
                     overflow row's block keeps its level).
  idct_planes_dense_first
                     the first dense launch of the ycc420 IDCT, with the
                     arguments and results of
                     transform_cuda.idct_planes_dense_cuda: a unit's
                     blocks loaded with nothing in flight behind the
                     sums, a group of 8 lanes a block over its own mask,
                     the [64][64] basis in shared memory, the unit staged
                     in a shared image.
  fdct_quantize_first
                     PR 9's fDCT kernel, with the arguments and results of
                     transform_cuda.fdct_quantize_cuda: the separable
                     float32 form (block_transform.separable_forward is its
                     model), 4 blocks a warp, a lane a row then a column,
                     transposes through a per-warp shared tile.

and, from scripts/scan_grid.cu, one design that was tried and not taken:

  decode_segments_grid
                     a Huffman scan with the arguments and results of
                     scan_cuda.decode_segments_cuda that takes the table
                     lookups off the symbol chain: a warp builds the
                     decoded entry at every bit offset of a chunk of its
                     segment in each table row the walk can reach, then
                     walks them (GRID, grid_layout).

All raise without a card; none falls back.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch

import numpy as np

from jpezy_tpu_torch.constants import (EXACT_TABLES, FDCT_COS, FDCT_SCALE,
                                       codec_constants)
from jpezy_tpu_torch.ops import concat_cuda, exact_cuda
from jpezy_tpu_torch.ops.cuda_build import KernelLibrary
from jpezy_tpu_torch.ops.pack_cuda import annex_k_row
from jpezy_tpu_torch.ops import transform_cuda

KERNEL_INFO = ("encode_blocks fused first", "concat_streams 64-bit loads",
               "fdct_quantize_exact first int8",
               "idct_planes_exact first int16", "idct_planes_rgb first int16",
               "idct_planes overflow first", "fdct_quantize first int8",
               "fdct_quantize first int32", "idct_planes sparse first",
               "idct_planes dense first")


def _bind(lib) -> None:
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.jz_prev_encode_blocks_fused.restype = ci
    lib.jz_prev_encode_blocks_fused.argtypes = [vp] * 5 + [ci, ci] + [
        vp] * 7 + [ll] * 4 + [vp]
    lib.jz_prev_concat_streams.restype = ci
    lib.jz_prev_concat_streams.argtypes = [vp] * 7 + [ll] * 7 + [vp]
    lib.jz_prev_fdct_quantize_exact.restype = ci
    lib.jz_prev_fdct_quantize_exact.argtypes = [ci] + [vp] * 11
    lib.jz_prev_idct_planes_exact.restype = ci
    lib.jz_prev_idct_planes_exact.argtypes = [ci] + [vp] * 8
    lib.jz_prev_idct_planes_rgb.restype = ci
    lib.jz_prev_idct_planes_rgb.argtypes = [ci] + [vp] * 8
    lib.jz_prev_idct_planes_overflow.restype = ci
    lib.jz_prev_idct_planes_overflow.argtypes = [vp] * 6
    lib.jz_prev_idct_planes_sparse.restype = ci
    lib.jz_prev_idct_planes_sparse.argtypes = [vp] * 6
    lib.jz_prev_idct_planes_dense.restype = ci
    lib.jz_prev_idct_planes_dense.argtypes = [vp] * 7
    lib.jz_prev_fdct_quantize.restype = ci
    lib.jz_prev_fdct_quantize.argtypes = [ci] + [vp] * 11
    lib.jz_prev_kernel_info.restype = ci
    lib.jz_prev_kernel_info.argtypes = [ci, vp]


LIB = KernelLibrary("previous_designs.cu", _bind,
                    directory=os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=8)
def _inverse_basis_t(device: torch.device) -> torch.Tensor:
    """The float32 inverse basis transposed, [k][p], on device (once): the
    first designs copy it into shared memory with coalesced reads."""
    return codec_constants(device)["inv64_f32"].t().contiguous()


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


def encode_blocks_fused_first(yq, cbq, crq, *, restart_interval: int = 0,
                              carry=None, tables=None):
    """pack_cuda.encode_blocks_batch_cuda's (words, bits) from the first
    fused design: the same arguments, words int64 [N, B_c, 64] in [0,
    2**32)."""
    lib = LIB.get()
    N = yq.shape[0]
    custom = tables is not None
    rows = tables if custom else (annex_k_row(yq.device, False),
                                  annex_k_row(yq.device, True))
    qs = [t.contiguous() for t in (yq, cbq, crq)]
    rs = [r.contiguous() for r in rows]
    cc = None if carry is None else carry.contiguous()
    outs = [(torch.empty((N, q.shape[1], 64), dtype=torch.int64,
                         device=yq.device),
             torch.empty((N, q.shape[1]), dtype=torch.int32,
                         device=yq.device)) for q in qs]
    rc = lib.jz_prev_encode_blocks_fused(
        *(t.data_ptr() for t in qs + rs), rows[0].shape[0], int(custom),
        None if cc is None else cc.data_ptr(),
        *(w.data_ptr() for w, _ in outs), *(b.data_ptr() for _, b in outs),
        N, yq.shape[1], cbq.shape[1], restart_interval,
        torch.cuda.current_stream().cuda_stream)
    LIB.raise_on("prev_encode_blocks_fused", rc)
    return tuple(w for w, _ in outs), tuple(b for _, b in outs)


def concat_streams_first(words, bits, *, maxw: int,
                         restart_interval: int = 0):
    """combined [N, 1 + S + maxw] int64 of the concat with 64-bit word
    loads, from int64 words (encode_blocks_fused_first's, or
    entropy.words64 of the current kernel's)."""
    lib = LIB.get()
    if any(w.dtype != torch.int64 for w in words):
        raise ValueError("concat_streams_first: words must be int64")
    N, nm = bits[1].shape
    ri = restart_interval
    nseg = -(-nm // ri) if ri else 0
    ntiles, tile_mcus = concat_cuda.tile_layout(nm)
    ws = [w.contiguous() for w in words]
    bs = [b.to(torch.int32).contiguous() for b in bits]
    if bs[0].data_ptr() % 16:
        bs[0] = bs[0].clone()
    combined = torch.empty((N, 1 + nseg + maxw), dtype=torch.int64,
                           device=words[0].device)
    rc = lib.jz_prev_concat_streams(
        *(t.data_ptr() for t in ws + bs), combined.data_ptr(), N, nm, ri,
        nseg, maxw, tile_mcus, ntiles, torch.cuda.current_stream().cuda_stream)
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


def idct_planes_overflow_first(flat, qtab, *, geom, level: int, shapes, K: int,
                               N: int, caps):
    """transform_cuda.idct_planes_sparse_cuda's planes with the first
    overflow launch: the current sparse launch alone (the description's
    caps zeroed), then the first overflow kernel over the same upload."""
    lib = LIB.get()
    desc, planes = transform_cuda.sparse_desc(
        flat, qtab, geom=geom, level=level, shapes=shapes, K=K, N=N,
        caps=caps)
    alone = desc.copy()
    alone[16::12] = 0      # each component's cap
    out = torch.empty((N, planes), dtype=torch.uint8, device=flat.device)
    src, q = flat.contiguous(), qtab.contiguous()
    transform_cuda._launch(0, alone, src, None, q, out)
    rc = lib.jz_prev_idct_planes_overflow(
        desc.ctypes.data, src.data_ptr(), q.data_ptr(),
        _inverse_basis_t(flat.device).data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    LIB.raise_on("prev_idct_planes_overflow", rc)
    return out


def idct_planes_sparse_first(flat, qtab, *, geom, level: int, shapes,
                             K: int, N: int, caps):
    """The planes of the first sparse launch alone over the upload flat
    (transform_cuda.idct_planes_sparse_cuda's arguments): equal to
    block_transform.idct_planes_sparse_model with every cap 0."""
    lib = LIB.get()
    desc, planes = transform_cuda.sparse_desc(
        flat, qtab, geom=geom, level=level, shapes=shapes, K=K, N=N,
        caps=caps)
    out = torch.empty((N, planes), dtype=torch.uint8, device=flat.device)
    src, q = flat.contiguous(), qtab.contiguous()
    rc = lib.jz_prev_idct_planes_sparse(
        desc.ctypes.data, src.data_ptr(), q.data_ptr(),
        _inverse_basis_t(flat.device).data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    LIB.raise_on("prev_idct_planes_sparse", rc)
    return out


def idct_planes_dense_first(blocks, bad, qarr, *, N, nseg, ri, geom, level):
    """transform_cuda.idct_planes_dense_cuda's planes and flags from the
    first dense launch: the same arguments (checked by the package's rules)
    and results, [N, P + 1] uint8.  Not counted in
    transform_cuda.idct_launches."""
    lib = LIB.get()
    desc, planes, (src, flags, q) = transform_cuda.dense_desc(
        blocks, bad, qarr, N=N, nseg=nseg, ri=ri, geom=geom, level=level)
    out = torch.empty((N, planes + 1), dtype=torch.uint8,
                      device=blocks.device)
    rc = lib.jz_prev_idct_planes_dense(
        desc.ctypes.data, src.data_ptr(), flags.data_ptr(), q.data_ptr(),
        _inverse_basis_t(blocks.device).data_ptr(), out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    LIB.raise_on("prev_idct_planes_dense", rc)
    return out


# the separable form's float32 tables, C[v][x] then S[u][v] (host memory),
# as PR 9's launcher took them
_SEPARABLE = np.ascontiguousarray(np.concatenate(
    [FDCT_COS.ravel(), FDCT_SCALE.ravel()]), np.float32)


def fdct_quantize_first(y, cb, cr, yqt, cqt, *, gray: bool = False,
                        rounded: bool = False):
    """transform_cuda.fdct_quantize_cuda's arguments and results from PR
    9's kernel: (yq [N, 4 nm, 64], cbq, crq [N, nm, 64]) int32, equal to
    block_transform.fdct_quantize_model with transform=separable_forward."""
    lib = LIB.get()
    N, H, W = y.shape
    my, mx = H // 16, W // 16
    desc = np.array([N, my, mx, int(gray), int(rounded), *y.stride(),
                     *cb.stride(), *cr.stride()], np.int64)
    tabs = [t.contiguous() for t in (yqt, cqt)]
    outs = [torch.empty((N, k * my * mx, 64), dtype=torch.int32,
                        device=y.device) for k in (4, 1, 1)]
    rc = lib.jz_prev_fdct_quantize(
        {torch.int8: 1, torch.int32: 4}[y.dtype], desc.ctypes.data,
        _SEPARABLE.ctypes.data,
        *(t.data_ptr() for t in (y, cb, cr, *tabs, *outs)),
        torch.cuda.current_stream().cuda_stream)
    LIB.raise_on("prev_fdct_quantize", rc)
    return tuple(outs)


def _bind_grid(lib) -> None:
    from jpezy_tpu_torch.ops import scan_cuda

    scan_cuda._bind(lib)
    for fn in (lib.jz_scan_chunk_bits, lib.jz_scan_shared_bytes,
               lib.jz_scan_registers):
        fn.restype = ctypes.c_int
        fn.argtypes = []


GRID = KernelLibrary("scan_grid.cu", _bind_grid,
                     directory=os.path.dirname(os.path.abspath(__file__)))


def grid_layout() -> dict:
    """scan_cuda.layout() of the grid design, with the bit offsets of a
    chunk, shared bytes a thread block and registers a thread."""
    h = GRID.get()
    return {"warps_per_block": h.jz_scan_warps_per_block(),
            "first_level_bits": h.jz_scan_first_level_bits(),
            "chunk_bits": h.jz_scan_chunk_bits(),
            "shared_bytes": h.jz_scan_shared_bytes(),
            "registers": h.jz_scan_registers(),
            "blocks_per_sm": h.jz_scan_blocks_per_sm()}


def decode_segments_grid(words, nblk, lut, tsel=None, rawlen=None,
                         skip0=None, preds0=None, *, max_blocks: int,
                         lib=None):
    """scan_cuda.decode_segments_cuda's (blocks, bad) from the grid design
    (`lib`, a build of scripts/scan_grid.cu or a variant of it; GRID by
    default): the same arguments (CUDA tensors, checked by the package
    wrapper's rules) and results.  Not counted in scan_cuda.launches."""
    from jpezy_tpu_torch.ops import scan_cuda

    lib = lib or GRID
    h = lib.get()
    args, blocks, bad = scan_cuda.prepare(words, nblk, lut, tsel, rawlen,
                                          skip0, preds0,
                                          max_blocks=max_blocks)
    S, Lw = args[0].shape
    with torch.cuda.device(args[0].device):
        rc = h.jz_decode_segments(
            *(None if t is None else t.data_ptr() for t in args),
            blocks.data_ptr(), bad.data_ptr(), S, Lw, args[2].shape[0],
            max_blocks, torch.cuda.current_stream(args[0].device).cuda_stream)
    lib.raise_on("decode_segments_grid", rc)
    return blocks, bad.bool()
