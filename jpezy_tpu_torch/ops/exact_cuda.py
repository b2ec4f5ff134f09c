"""Wrappers of the hand-written CUDA kernels of exact mode
(csrc/exact_transforms.cu).

fdct_quantize_exact_cuda is the CUDA form of
block_transform.fdct_quantize_plain at float64: blockify, the forward DCT
as the oracle's ordered float64 sums and quantize of the three components
in one launch, the planes read at their element strides (the ycc420
upload's int8 views, the rgb path's int32 planes and decimated chroma).
idct_planes_exact_cuda is the CUDA form of
block_transform.idct_planes_exact_plain: dequantize, the inverse DCT as
the oracle's ordered float64 sums, the level shift and truncation, into
each component's unclamped int32 plane, one launch for every component.
They replace exact mode's halves of the stages XLA fused on the TPU in
jpezy_tpu/parallel/sharded.py:_quantize_local_ycc and
jpezy_tpu/codec/jax_codec.py:_decode_fused_batch.  idct_planes_rgb_cuda
is the same walk with the fast precision's float32 arithmetic (the rgb
transport's fast decode, the other half of _decode_fused_batch): equal
to block_transform.idct_planes_rgb_model bit for bit, and within 1 of
idct_planes_rgb_plain's matrix product, which sums in another order.  Its
kernel takes one product for the four samples of a mirror quad, which is
exact only for a basis that is mirror-symmetric bit for bit
(mirror_symmetric): quad_basis, which makes the kernel's table on the host
when this module is imported, refuses any other.

Both make the oracle's roundings and nothing else: every multiply and add
a separate IEEE operation in the oracle's order, the tables the port's
float64 masters (constants.EXACT_TABLES), so their outputs equal the plain
versions' bit for bit on every input.  The library is built at first use
and loaded with ctypes by ops/cuda_build.py.  A failed build or launch
raises; nothing falls back to the plain versions.

`fdct_exact_launches`, `idct_exact_launches` and `idct_rgb_launches`
count calls that launched a kernel, so a run can show that its path went
through them.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from ..constants import EXACT_TABLES, codec_constants
from .cuda_build import KernelLibrary, check_tensors
from .transform_cuda import _layout


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.jz_fdct_quantize_exact.restype = ci
    lib.jz_fdct_quantize_exact.argtypes = [ci] + [vp] * 11
    lib.jz_idct_planes_exact.restype = ci
    lib.jz_idct_planes_exact.argtypes = [ci] + [vp] * 8
    lib.jz_idct_planes_rgb.restype = ci
    lib.jz_idct_planes_rgb.argtypes = [ci] + [vp] * 8
    lib.jz_exact_kernel_info.restype = ci
    lib.jz_exact_kernel_info.argtypes = [ci, vp]


LIB = KernelLibrary("exact_transforms.cu", _bind)

_lock = threading.Lock()
fdct_exact_launches = 0
idct_exact_launches = 0
idct_rgb_launches = 0
_SAMPLE_BYTES = {torch.int8: 1, torch.int32: 4}
_COEFF_BYTES = {torch.int16: 2, torch.int32: 4}
# the kernels' instantiations, in jz_exact_kernel_info's order
KERNEL_INFO = ("fdct_quantize_exact int8", "fdct_quantize_exact int32",
               "idct_planes_exact int16", "idct_planes_exact int32",
               "idct_planes_rgb int16", "idct_planes_rgb int32")


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
                     lib.jz_exact_kernel_info(i, info.ctypes.data))
        out[name] = tuple(int(v) for v in info)
    return out


def mirror_symmetric(basis: np.ndarray) -> bool:
    """Whether a [64, 64] float32 inverse basis M[p][k] (p = 8 y + x,
    k = 8 v + u) is mirror-symmetric bit for bit: M[8 y + 7 - x][k] =
    (-1)^u M[p][k] and M[8 (7 - y) + x][k] = (-1)^v M[p][k] for every entry.
    Negation is exact, and rounding to nearest is symmetric, so then
    fl(d M[p'][k]) = +-fl(d M[p][k]) at the mirrored samples p'."""
    m = np.asarray(basis)
    if m.dtype != np.float32 or m.shape != (64, 64):
        return False
    p, k = np.arange(64), np.arange(64)
    flip_x, flip_y = 8 * (p // 8) + 7 - p % 8, 8 * (7 - p // 8) + p % 8
    sign_u = np.where(k % 2 == 1, -1, 1).astype(np.float32)
    sign_v = np.where(k // 8 % 2 == 1, -1, 1).astype(np.float32)
    bits = m.view(np.uint32)
    return (np.array_equal(bits[flip_x], (m * sign_u).view(np.uint32))
            and np.array_equal(bits[flip_y], (m * sign_v).view(np.uint32)))


def quad_basis(basis: np.ndarray) -> np.ndarray:
    """The rows of a [64, 64] inverse basis that the fast kernel reads, in
    its layout: the 16 mirror quads' base samples p = 8 y + x (y, x < 4,
    quad q = 4 y + x), quads j and j + 8 and two k together, [32, 8, 2, 2]
    with Q[k // 2, j, h, k % 2] = M[p][k] for q = j + 8 h.  Raises for a
    basis that is not mirror-symmetric bit for bit: the kernel's one
    product a mirror quad would not give that basis's sums."""
    if not mirror_symmetric(basis):
        raise ValueError("quad_basis: the inverse basis is not a [64, 64] "
                         "float32 table mirror-symmetric bit for bit, which "
                         "the kernel's one product a mirror quad needs")
    q = np.arange(16)
    rows = np.asarray(basis, np.float32)[8 * (q // 4) + q % 4]   # [q, k]
    return np.ascontiguousarray(
        rows.reshape(2, 8, 32, 2).transpose(2, 1, 0, 3))


# The fast form's inverse basis M[p][k] (ops/dct.py's, at float32) and the
# kernel's table of it, made and checked on the host once.
INV_BASIS = codec_constants("cpu")["inv64_f32"].numpy()
_INV_QUADS = quad_basis(INV_BASIS)


@functools.lru_cache(maxsize=8)
def _device_quads(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_INV_QUADS).to(device)


def fdct_quantize_exact_cuda(y, cb, cr, yqt, cqt, *, gray: bool = False,
                             rounded: bool = False):
    """Y-128 [N, H, W] and Cb, Cr [N, H/2, W/2] samples (int8 or int32,
    all three alike, any strides; H, W multiples of 16), quant tables yqt,
    cqt [64] int32 -> (yq [N, 4 nm, 64], cbq, crq [N, nm, 64]) int32
    quantized blocks in natural order, nm = H W / 256 MCUs an image, equal
    to fdct_quantize_plain(..., dtype=float64)'s.  On the inputs' device
    and stream."""
    global fdct_exact_launches
    fn = "fdct_quantize_exact_cuda"
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
    lib = LIB.get()
    dev = y.device
    my, mx = H // 16, W // 16
    desc = np.array([N, my, mx, int(gray), int(rounded), *y.stride(),
                     *cb.stride(), *cr.stride()], np.int64)
    with torch.cuda.device(dev):
        tabs = [t.contiguous() for t in (yqt, cqt)]
        outs = [torch.empty((N, k * my * mx, 64), dtype=torch.int32,
                            device=dev) for k in (4, 1, 1)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jz_fdct_quantize_exact(
            _SAMPLE_BYTES[y.dtype], desc.ctypes.data,
            EXACT_TABLES.ctypes.data,
            *(t.data_ptr() for t in (y, cb, cr, *tabs, *outs)), stream)
    LIB.raise_on("fdct_quantize_exact", rc)
    if N > 0:
        with _lock:
            fdct_exact_launches += 1
    return tuple(outs)


def _inverse(fn: str, coeff_all, qtab, *, geom, level: int, gray: bool,
             sizes, fast: bool = False):
    """Check the arguments of an inverse kernel, allocate its planes and
    launch it: exact mode's, or with `fast` the fast form's.  Returns the
    planes."""
    ncomp = len(sizes)
    if not 1 <= ncomp <= 3 or len(geom) != ncomp:
        raise ValueError(f"{fn}: geom and sizes must name the same 1 to 3 "
                         "components")
    if coeff_all.dtype not in _COEFF_BYTES:
        raise ValueError(f"{fn}: coeff_all is {coeff_all.dtype}, want int16 "
                         "or int32")
    if coeff_all.dim() != 3:
        raise ValueError(f"{fn}: coeff_all has shape "
                         f"{tuple(coeff_all.shape)}, want [N, sum(sizes), "
                         "64]")
    used = 1 if gray else ncomp
    _layout(geom[:used], sizes[:used])   # one MCU grid, factors 1..4
    N = coeff_all.shape[0]
    check_tensors(fn, coeff_all,
                  ("coeff_all", coeff_all, coeff_all.dtype,
                   (N, sum(sizes), 64)),
                  ("qtab", qtab, torch.int32, (ncomp, 64)))
    lib = LIB.get()
    dev = coeff_all.device
    mcus_y, mcus_x = (int(x) for x in geom[0][:2])
    comps, first = [], 0
    for c in range(3):
        if c < used:
            v, h = (int(x) for x in geom[c][2:4])
            comps += [sizes[c], v, h, first]
        else:
            comps += [0, 0, 0, 0]
        first += sizes[c] if c < ncomp else 0
    desc = np.array([N, used, mcus_x, sum(sizes), level, *comps], np.int64)
    with torch.cuda.device(dev):
        src = coeff_all.contiguous()
        if src.data_ptr() % 16:
            src = src.clone()
        q = qtab.contiguous()
        outs = [torch.empty((N, mcus_y * int(g[2]) * 8,
                             mcus_x * int(g[3]) * 8), dtype=torch.int32,
                            device=dev) for g in geom[:used]]
        ptrs = [o.data_ptr() for o in outs] + [None] * (3 - used)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if fast:
            rc = lib.jz_idct_planes_rgb(
                _COEFF_BYTES[src.dtype], desc.ctypes.data,
                _device_quads(dev).data_ptr(), src.data_ptr(),
                q.data_ptr(), *ptrs, stream)
        else:
            rc = lib.jz_idct_planes_exact(
                _COEFF_BYTES[src.dtype], desc.ctypes.data,
                EXACT_TABLES.ctypes.data, src.data_ptr(), q.data_ptr(),
                *ptrs, stream)
    LIB.raise_on(fn, rc)
    return outs


def idct_planes_exact_cuda(coeff_all, qtab, *, geom, level: int, gray: bool,
                           sizes):
    """The rgb transport's coefficients coeff_all [N, sum(sizes), 64]
    (int16 or int32; per image every component's blocks in MCU order, one
    component after the other), the components' quant tables qtab
    [ncomp, 64] int32, their geometry (mcus_y, mcus_x, v, h, ...) and
    block counts -> a list of int32 planes [N, mcus_y v 8, mcus_x h 8]
    holding int(s / 4 + level) unclamped, one a component, or component 0's
    alone with `gray`; equal to idct_planes_exact_plain's.  One launch."""
    global idct_exact_launches
    outs = _inverse("idct_planes_exact_cuda", coeff_all, qtab, geom=geom,
                    level=level, gray=gray, sizes=sizes)
    if coeff_all.shape[0] > 0:
        with _lock:
            idct_exact_launches += 1
    return outs


def idct_planes_rgb_cuda(coeff_all, qtab, *, geom, level: int, gray: bool,
                         sizes):
    """idct_planes_exact_cuda's layout with the fast precision's
    arithmetic: per sample the float32 sum over the block's nonzero
    dequantized coefficients d[k] of d[k] M[p][k] in ascending k, then
    + level, truncated (block_transform.idct_planes_rgb_model), into
    unclamped int32 planes.  One launch."""
    global idct_rgb_launches
    outs = _inverse("idct_planes_rgb_cuda", coeff_all, qtab, geom=geom,
                    level=level, gray=gray, sizes=sizes, fast=True)
    if coeff_all.shape[0] > 0:
        with _lock:
            idct_rgb_launches += 1
    return outs
