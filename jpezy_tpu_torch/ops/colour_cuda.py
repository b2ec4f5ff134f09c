"""Wrappers of the hand-written CUDA colour kernels (csrc/colour.cu).

rgb_to_ycc420_cuda is the CUDA form of colorspace.rgb_to_ycc420_plain:
colour conversion and 4:2:0 decimation of [N, H, W, 3] uint8 into int8
planes, Y - 128 and the chroma of each 2x2 quad's top-left pixel, in
float32 (fast) or float64 (exact), one launch.  It replaces
jpezy_tpu/ops/colorspace.py:rgb_to_ycc and ops/blocks.py:decimate_420,
which XLA fused on the TPU into jpezy_tpu/parallel/sharded.py:_encode_local.

ycc_planes_to_rgb_cuda is the CUDA form of colorspace.planes_to_rgb_plain:
nearest upsampling of each component's unclamped int32 plane by its
(dup_y, dup_x), read in place, then colour conversion, or the gray clamp,
into [N, rows, cols, 3 or 1] uint8, one launch.  It replaces
jpezy_tpu/ops/colorspace.py:ycc_to_rgb and clamp_gray and
ops/blocks.py:upsample_nearest in jpezy_tpu/codec/jax_codec.py:
_decode_fused_batch.

Both make eager torch's roundings, one a multiply, add or subtract, in
torch's order, at either precision, so their outputs equal the plain
versions' bit for bit on every input; at float64 they are the reference's
double arithmetic, which the host C++ library (runtime/native.py:
rgb_to_ycc420, ycc_to_rgb_i32) computes too.  The library is built at
first use and loaded with ctypes by ops/cuda_build.py.  A failed build or
launch raises; nothing falls back to the plain versions.

`rgb_to_ycc420_launches` and `ycc_planes_to_rgb_launches` count calls that
launched a kernel, so a run can show that its path went through them.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .cuda_build import KernelLibrary, check_tensors


def _bind(lib) -> None:
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.jz_colour_rgb_to_ycc420.restype = ci
    lib.jz_colour_rgb_to_ycc420.argtypes = [ci, cll, cll, cll] + [vp] * 5
    lib.jz_colour_planes_to_rgb.restype = ci
    lib.jz_colour_planes_to_rgb.argtypes = [ci] + [vp] * 6
    lib.jz_colour_kernel_info.restype = ci
    lib.jz_colour_kernel_info.argtypes = [ci, vp]


LIB = KernelLibrary("colour.cu", _bind)

_lock = threading.Lock()
rgb_to_ycc420_launches = 0
ycc_planes_to_rgb_launches = 0
# the kernels' instantiations, in jz_colour_kernel_info's order
KERNEL_INFO = ("rgb_to_ycc420 float32", "rgb_to_ycc420 float64",
               "ycc_planes_to_rgb float32", "ycc_planes_to_rgb float64",
               "ycc_planes_to_rgb gray")


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
                     lib.jz_colour_kernel_info(i, info.ctypes.data))
        out[name] = tuple(int(v) for v in info)
    return out


def _exact(dtype) -> int:
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the colour kernels compute in float32 or float64, "
                         f"not {dtype}")
    return int(dtype == torch.float64)


def _aligned(t: torch.Tensor, align: int) -> torch.Tensor:
    """t contiguous, its first element at a multiple of `align` bytes."""
    t = t.contiguous()
    return t if t.data_ptr() % align == 0 else t.clone()


def rgb_to_ycc420_cuda(rgb: torch.Tensor, dtype=torch.float32):
    """rgb [N, H, W, 3] uint8 (H, W multiples of 16) -> (Y - 128 [N, H, W],
    Cb, Cr [N, H/2, W/2]) int8, colour at `dtype` (float32 or float64),
    equal to rgb_to_ycc420_plain(rgb, dtype).  On the input's device and
    stream."""
    global rgb_to_ycc420_launches
    fn = "rgb_to_ycc420_cuda"
    exact = _exact(dtype)
    if rgb.dim() != 4 or rgb.shape[3] != 3 or rgb.shape[1] % 16 \
            or rgb.shape[2] % 16:
        raise ValueError(f"{fn}: rgb has shape {tuple(rgb.shape)}, want "
                         "[N, H, W, 3] with H, W multiples of 16")
    N, H, W, _ = rgb.shape
    check_tensors(fn, rgb, ("rgb", rgb, torch.uint8, (N, H, W, 3)))
    lib = LIB.get()
    dev = rgb.device
    with torch.cuda.device(dev):
        src = _aligned(rgb, 16)
        y = torch.empty((N, H, W), dtype=torch.int8, device=dev)
        cb, cr = (torch.empty((N, H // 2, W // 2), dtype=torch.int8,
                              device=dev) for _ in range(2))
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jz_colour_rgb_to_ycc420(
            exact, N, H, W, src.data_ptr(), y.data_ptr(), cb.data_ptr(),
            cr.data_ptr(), stream)
    LIB.raise_on(fn, rc)
    if N > 0:
        with _lock:
            rgb_to_ycc420_launches += 1
    return y, cb, cr


def ycc_planes_to_rgb_cuda(planes, dups, *, gray: bool,
                           dtype=torch.float32):
    """planes: one int32 plane [N, rows_c, cols_c] a component (Y, Cb, Cr;
    or Y alone, with gray or a 1-component frame), unclamped; dups: each
    component's (dup_y, dup_x), 1 to 4, with rows_c dup_y and cols_c dup_x
    the same for every component -> [N, rows, cols, 3] uint8 RGB, or
    [N, rows, cols, 1] with gray, colour at `dtype` (float32 or float64),
    equal to planes_to_rgb_plain's.  One launch."""
    global ycc_planes_to_rgb_launches
    fn = "ycc_planes_to_rgb_cuda"
    exact = _exact(dtype)
    ncomp = 1 if gray else 3
    if len(planes) != ncomp or len(dups) < ncomp:
        raise ValueError(f"{fn}: {len(planes)} planes and {len(dups)} "
                         f"upsampling factors, want {ncomp} of each"
                         f"{' (gray)' if gray else ''}")
    p0 = planes[0]
    if p0.dim() != 3:
        raise ValueError(f"{fn}: plane 0 has shape {tuple(p0.shape)}, want "
                         "[N, rows, cols]")
    N = p0.shape[0]
    dups = [(int(dy), int(dx)) for dy, dx in dups[:ncomp]]
    rows, cols = p0.shape[1] * dups[0][0], p0.shape[2] * dups[0][1]
    for c, ((dy, dx), p) in enumerate(zip(dups, planes)):
        if not (1 <= dy <= 4 and 1 <= dx <= 4):
            raise ValueError(f"{fn}: component {c} upsamples by {(dy, dx)}, "
                             "want factors 1 to 4")
        if p.dim() != 3 or p.shape[1] * dy != rows or p.shape[2] * dx != cols:
            raise ValueError(f"{fn}: component {c}'s plane "
                             f"{tuple(p.shape)} upsampled by {(dy, dx)} does "
                             f"not cover {rows}x{cols}")
    if cols % 4:
        raise ValueError(f"{fn}: {cols} columns, want a multiple of 4")
    check_tensors(fn, p0, *((f"plane {c}", p, torch.int32,
                             (N, p.shape[1], p.shape[2]))
                            for c, p in enumerate(planes)))
    lib = LIB.get()
    dev = p0.device
    desc = [N, ncomp, rows, cols]
    for p, (dy, dx) in zip(planes, dups):
        desc += [p.shape[1], p.shape[2], dy, dx]
    desc = np.array(desc + [0] * (4 + 4 * 3 - len(desc)), np.int64)
    with torch.cuda.device(dev):
        src = [_aligned(p, 16) for p in planes]
        out = torch.empty((N, rows, cols, 1 if gray else 3),
                          dtype=torch.uint8, device=dev)
        ptrs = [p.data_ptr() for p in src] + [None] * (3 - ncomp)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jz_colour_planes_to_rgb(exact, desc.ctypes.data, *ptrs,
                                         out.data_ptr(), stream)
    LIB.raise_on(fn, rc)
    if N > 0:
        with _lock:
            ycc_planes_to_rgb_launches += 1
    return out
