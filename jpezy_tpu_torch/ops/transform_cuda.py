"""Wrappers of the hand-written CUDA block transforms
(csrc/block_transforms.cu).

fdct_quantize_cuda is the CUDA form of block_transform.fdct_quantize_plain
at float32: blockify, forward DCT (the integer form of
block_transform.integer_forward, on the int8 tensor cores with the
samples and W_int's three 8-bit digits, fragment_table) and quantize of the
three components in one launch, the planes read at their element strides
(the ycc420 upload's int8 views, the rgb path's int32 planes and decimated
chroma), so no copy is made first.  It replaces the stage XLA fused on the
TPU in jpezy_tpu/parallel/sharded.py:_quantize_local_ycc.

idct_planes_sparse_cuda and idct_planes_dense_cuda are the CUDA forms of
block_transform.idct_planes_sparse_plain and idct_planes_dense_plain:
dequantize, inverse DCT, level shift, truncation and clamp, written
straight into the packed u8 planes.  The sparse form reads the ycc420
transport's upload in place (one launch, and a second for the overflow
rows when the upload carries any); the dense form reads the Huffman
scan's blocks and writes each image's corruption flag after its planes
(one launch).  All three launches walk the union of several blocks'
nonzero coefficients with one product for the 4 samples of a mirror
quad, from exact_cuda's checked table of the basis' quads.
Every launch adds the same terms in the same ascending order.  They
replace jpezy_tpu/codec/jax_codec.py:_decode_fused_batch_ycc420 and the
tail of _decode_fused_batch_device.

The fDCT kernel's sums are exact integers and the IDCT kernels sum in a
fixed order, so block_transform's numpy models reproduce them bit for bit;
they compute the fast precision only.  Exact
mode's float64 transforms have kernels of their own (ops/exact_cuda.py,
csrc/exact_transforms.cu).  The library is built at first use and loaded with ctypes by
ops/cuda_build.py.  A failed build or launch raises; nothing falls back to
the plain versions.

`fdct_launches` and `idct_launches` count calls that launched a kernel
(an idct call with overflow rows launches two), so a run can show that
its path went through them.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from ..constants import FDCT_DIGITS
from .cuda_build import KernelLibrary, check_tensors


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.jz_fdct_quantize.restype = ci
    lib.jz_fdct_quantize.argtypes = [ci] + [vp] * 11
    lib.jz_idct_planes.restype = ci
    lib.jz_idct_planes.argtypes = [ci] + [vp] * 7
    lib.jz_transform_kernel_info.restype = ci
    lib.jz_transform_kernel_info.argtypes = [ci, vp]


LIB = KernelLibrary("block_transforms.cu", _bind)

_lock = threading.Lock()
fdct_launches = 0
idct_launches = 0
_SAMPLE_BYTES = {torch.int8: 1, torch.int32: 4}
# the sparse form stages at most this many value bytes a block
MAX_K = 64
# the kernels' instantiations, in jz_transform_kernel_info's order
KERNEL_INFO = ("fdct_quantize int8", "fdct_quantize int32",
               "idct_planes sparse", "idct_planes dense",
               "idct_planes overflow")


def slot_sample(j: int, slot) -> np.ndarray:
    """The fDCT kernel's order of a block's samples on the tensor cores:
    slot (0..31) of k-step j (0, 1) of mma m16n8k32 holds sample s = 8 (2 t
    + j) + 4 h + e, slot = 16 h + 4 t + e.  Lane 4 g + t of a warp loads
    rows 2 t and 2 t + 1 of its tile's blocks g and g + 8 as two 4-byte
    half-rows each (h = 0 the left, 1 the right), which are its A
    fragments' registers as they are: row 2 t + j's halves h of block g in
    registers 2 h, of block g + 8 in 2 h + 1.  The table's rows take the
    same order, so each product sums the same 64 terms."""
    slot = np.asarray(slot)
    h, t, e = slot >> 4, (slot >> 2) & 3, slot & 3
    return 8 * (2 * t + j) + 4 * h + e


@functools.lru_cache(maxsize=1)
def fragment_table() -> np.ndarray:
    """W_int's three digits (constants.FDCT_DIGITS) as the fDCT kernel's B
    fragments, int32 [3, 8, 32, 4] (12,288 bytes): [d][n-tile u][lane 4 g
    + t][2 j + r] is register r of k-step j of lane 4 g + t for coefficient
    row u, its byte e digit d of sample slot_sample(j, 16 r + 4 t + e) and
    coefficient k = 8 u + g (mma m16n8k32's B layout: register r holds
    rows 4 t + 16 r .. + 3 of column g, the low byte first).  A lane reads
    its 4 words of one digit and n-tile as one 16-byte word, neighbouring
    lanes on neighbouring words."""
    e = np.arange(4)
    out = np.zeros((3, 8, 32, 4), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j in range(2):
            for r in range(2):
                s = slot_sample(j, 16 * r + 4 * t + e)
                for u in range(8):
                    b = FDCT_DIGITS[:, s, 8 * u + g].astype(np.int64) & 0xFF
                    out[:, u, lane, 2 * j + r] = (b << (8 * e)).sum(axis=1)
    return out.astype(np.uint32).view(np.int32)


@functools.lru_cache(maxsize=8)
def _device_digits(device: torch.device) -> torch.Tensor:
    """fragment_table on device (once per device), passed to the fDCT
    kernel, which stages it in shared memory."""
    return torch.from_numpy(fragment_table().copy()).to(device)


def kernel_info() -> dict:
    """{instantiation: (registers a thread, resident thread blocks an SM,
    static shared bytes, local bytes a thread, threads a block)} as
    cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor
    report them on the current card."""
    lib = LIB.get()
    out = {}
    for i, name in enumerate(KERNEL_INFO):
        info = np.zeros(5, np.int32)
        LIB.raise_on(f"kernel_info({name})",
                     lib.jz_transform_kernel_info(i, info.ctypes.data))
        out[name] = tuple(int(v) for v in info)
    return out


def fdct_quantize_cuda(y, cb, cr, yqt, cqt, *, gray: bool = False,
                       rounded: bool = False):
    """Y-128 [N, H, W] and Cb, Cr [N, H/2, W/2] samples (int8 or int32,
    all three alike, any strides; H, W multiples of 16), quant tables yqt,
    cqt [64] int32 -> (yq [N, 4 nm, 64], cbq, crq [N, nm, 64]) int32
    quantized blocks in natural order, nm = H W / 256 MCUs an image.  On
    the inputs' device and stream.  The kernel multiplies int8 samples:
    int32 planes are narrowed, so a sample outside [-128, 127] raises
    (checked on the int32 form alone, the one that synchronises)."""
    global fdct_launches
    fn = "fdct_quantize_cuda"
    if y.dim() != 3 or y.shape[1] % 16 or y.shape[2] % 16:
        raise ValueError(f"{fn}: y has shape {tuple(y.shape)}, want "
                         "[N, H, W] with H, W multiples of 16")
    if y.dtype not in _SAMPLE_BYTES:
        raise ValueError(f"{fn}: y is {y.dtype}, want int8 or int32")
    N, H, W = y.shape
    check_tensors(fn, y, ("y", y, y.dtype, (N, H, W)),
                  ("cb", cb, y.dtype, (N, H // 2, W // 2)),
                  ("cr", cr, y.dtype, (N, H // 2, W // 2)),
                  ("yqt", yqt, torch.int32, (64,)),
                  ("cqt", cqt, torch.int32, (64,)))
    if y.dtype == torch.int32 and y.numel() > 0:
        for name, p in (("y", y), ("cb", cb), ("cr", cr)):
            lo, hi = (int(v) for v in torch.aminmax(p))
            if lo < -128 or hi > 127:
                raise ValueError(f"{fn}: {name} holds samples in [{lo}, "
                                 f"{hi}], want [-128, 127] (int8)")
    lib = LIB.get()
    dev = y.device
    my, mx = H // 16, W // 16
    desc = np.array([N, my, mx, int(gray), int(rounded), *y.stride(),
                     *cb.stride(), *cr.stride()], np.int64)
    with torch.cuda.device(dev):
        digits = _device_digits(dev)
        tabs = [t.contiguous() for t in (yqt, cqt)]
        outs = [torch.empty((N, k * my * mx, 64), dtype=torch.int32,
                            device=dev) for k in (4, 1, 1)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jz_fdct_quantize(
            _SAMPLE_BYTES[y.dtype], desc.ctypes.data, digits.data_ptr(),
            *(t.data_ptr() for t in (y, cb, cr, *tabs, *outs)), stream)
    LIB.raise_on("fdct_quantize", rc)
    if N > 0:
        with _lock:
            fdct_launches += 1
    return tuple(outs)


def _layout(geom, shapes):
    """Per component (mcus_y, mcus_x, v, h, ...) geometry and block counts
    -> (plane bytes of each component, their sum), after checking that
    every component covers the same MCU grid with its blocks, at sampling
    factors 1..4 (JPEG's range, which bounds the kernel's strips)."""
    mcus_y, mcus_x = geom[0][0], geom[0][1]
    sizes = []
    for g, Bn in zip(geom, shapes):
        my, mx, v, h = (int(x) for x in g[:4])
        if (my, mx) != (mcus_y, mcus_x) or not 1 <= v <= 4 \
                or not 1 <= h <= 4 or Bn != my * mx * v * h:
            raise ValueError(f"idct_planes: component geometry {g} does not "
                             f"hold {Bn} blocks on a {mcus_y}x{mcus_x} grid")
        sizes.append(my * v * 8 * mx * h * 8)
    return sizes, sum(sizes)


def _desc(N, geom, shapes, *, flag: bool, K=0, level=128, nseg=0,
          row_bytes=0, image_blocks=0, q_stride=0, mcu_blocks=0,
          fields=None):
    """(the launcher's int64 description, the planes' bytes in an output
    row, which holds one more byte with `flag`).  The description is a
    header, then per component nblocks, v, h, width, cap, slot0,
    plane_off, mlo_off, mhi_off, val_off, oidx_off, orows_off (fields:
    cap and the last five, per component)."""
    sizes, planes = _layout(geom, shapes)
    head = [N, len(geom), geom[0][1], K, level, nseg, row_bytes,
            image_blocks, planes + int(flag), q_stride, planes, mcu_blocks]
    comps, plane_off, slot0 = [], 0, 0
    for c in range(3):
        if c >= len(geom):
            comps += [0] * 12
            continue
        my, mx, v, h = (int(x) for x in geom[c][:4])
        cap, *offs = fields[c] if fields else (0, 0, 0, 0, 0, 0)
        comps += [shapes[c], v, h, mx * h * 8, cap, slot0, plane_off, *offs]
        plane_off += sizes[c]
        slot0 += v * h
    return np.array(head + comps, np.int64), planes


def _launch(dense: int, desc, src, bad, q, out) -> None:
    global idct_launches
    from .exact_cuda import _device_quads   # exact_cuda imports this module

    lib = LIB.get()
    dev = out.device
    with torch.cuda.device(dev):
        quads = _device_quads(dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jz_idct_planes(
            dense, desc.ctypes.data, src.data_ptr(),
            None if bad is None else bad.data_ptr(), q.data_ptr(),
            quads.data_ptr(), out.data_ptr(), stream)
    LIB.raise_on("idct_planes", rc)
    if out.shape[0] > 0:
        with _lock:
            idct_launches += 1


def sparse_desc(flat, qtab, *, geom, level, shapes, K, N, caps):
    """The sparse form's checked arguments: (the launcher's int64
    description of the upload flat, the planes' bytes an image)."""
    fn = "idct_planes_sparse_cuda"
    ncomp = len(geom)
    if not (1 <= ncomp <= 3) or len(shapes) != ncomp or len(caps) != ncomp:
        raise ValueError(f"{fn}: geom, shapes and caps must name the same "
                         "1 to 3 components")
    X = sum((8 + K) * Bn for Bn in shapes)
    need = N * X + sum(132 * cap for cap in caps)
    if flat.dim() != 1 or flat.numel() < need or not 1 <= K <= MAX_K:
        raise ValueError(f"{fn}: flat has shape {tuple(flat.shape)} and K "
                         f"{K}, want 1-D with at least {need} bytes and K "
                         f"in 1..{MAX_K}")
    _layout(geom, shapes)
    check_tensors(fn, flat, ("flat", flat, torch.uint8, tuple(flat.shape)),
                  ("qtab", qtab, torch.int32, (ncomp, 64)))
    fields, off, ooff = [], 0, N * X
    for Bn, cap in zip(shapes, caps):
        fields.append((cap, off, off + 4 * Bn, off + 8 * Bn,
                       ooff, ooff + 4 * cap))
        off += (8 + K) * Bn
        ooff += 132 * cap
    return _desc(N, geom, shapes, flag=False, K=K, level=level,
                 row_bytes=X, fields=fields)


def idct_planes_sparse_cuda(flat, qtab, *, geom, level, shapes, K, N, caps):
    """The ycc420 upload flat (1-D uint8, the layout of
    block_transform.idct_planes_sparse_plain) and the components' quant
    tables qtab [ncomp, 64] int32 -> [N, P] uint8 planes: the sparse
    launch, then the overflow launch where caps holds rows.  Overflow
    indices outside [0, N*B_c), the host's padding among them, write
    nothing."""
    desc, planes = sparse_desc(flat, qtab, geom=geom, level=level,
                               shapes=shapes, K=K, N=N, caps=caps)
    with torch.cuda.device(flat.device):
        out = torch.empty((N, planes), dtype=torch.uint8, device=flat.device)
        src, q = flat.contiguous(), qtab.contiguous()
    _launch(0, desc, src, None, q, out)
    return out


def dense_desc(blocks, bad, qarr, *, N, nseg, ri, geom, level):
    """The dense form's checked arguments: (the launcher's int64
    description, the planes' bytes an image, the blocks, flags as uint8
    and tables, contiguous)."""
    fn = "idct_planes_dense_cuda"
    if len(geom) != 3 or [tuple(g[2:4]) for g in geom] != [(2, 2), (1, 1),
                                                           (1, 1)]:
        raise ValueError(f"{fn}: takes standard 4:2:0 geometry, got {geom}")
    nmcu = geom[0][0] * geom[0][1]
    if ri < 1 or nseg * ri < nmcu:
        raise ValueError(f"{fn}: {nseg} segments of {ri} MCUs do not hold "
                         f"{nmcu} MCUs")
    if bad is None:
        raise ValueError(f"{fn}: bad is None, want [N*nseg] flags")
    if bad.dtype == torch.bool:
        bad = bad.view(torch.uint8)
    check_tensors(fn, blocks,
                  ("blocks", blocks, torch.int16, (N * nseg, ri * 6, 64)),
                  ("bad", bad, torch.uint8, (N * nseg,)),
                  ("qarr", qarr, torch.int32, (N, 3, 64)))
    desc, planes = _desc(N, geom, (4 * nmcu, nmcu, nmcu), flag=True,
                         level=level, nseg=nseg, image_blocks=nseg * ri * 6,
                         q_stride=3 * 64, mcu_blocks=6)
    with torch.cuda.device(blocks.device):
        args = tuple(t.contiguous() for t in (blocks, bad, qarr))
    return desc, planes, args


def idct_planes_dense_cuda(blocks, bad, qarr, *, N, nseg, ri, geom, level):
    """The Huffman scan's blocks [N*nseg, ri*6, 64] int16 (4 Y, Cb, Cr per
    MCU, the first nmcu MCUs of each image used), its flags bad [N*nseg]
    bool and the per-image quant tables qarr [N, 3, 64] int32 -> [N, P + 1]
    uint8: the planes, then 1 where any of the image's segments is
    corrupt."""
    desc, planes, args = dense_desc(blocks, bad, qarr, N=N, nseg=nseg,
                                    ri=ri, geom=geom, level=level)
    with torch.cuda.device(blocks.device):
        out = torch.empty((N, planes + 1), dtype=torch.uint8,
                          device=blocks.device)
    _launch(1, desc, *args, out)
    return out
