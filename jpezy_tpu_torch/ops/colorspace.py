"""Colour conversion over whole planes (torch).

Counterpart of jpezy_tpu/ops/colorspace.py, same expressions in the same
order, each a separate multiply or add (eager torch fuses none into a
multiply-add), so float64 ("exact" mode) reproduces the reference's
double-precision truncation bit for bit.  float32 is the fast path of the
`rgb` transports.

The rgb transport's two colour stages (what XLA fused on the TPU in
jpezy_tpu/parallel/sharded.py:_encode_local and
jpezy_tpu/codec/jax_codec.py:_decode_fused_batch) each have a plain torch
version here (rgb_to_ycc420_plain, planes_to_rgb_plain: the CPU's route
and the reference the kernels are held to on the card) and a dispatcher
(rgb_to_ycc420, planes_to_rgb) that takes the hand-written CUDA kernel
(ops/colour_cuda.py, csrc/colour.cu) for CUDA tensors, which makes the
same roundings, and the plain version for CPU tensors.
"""
from __future__ import annotations

import torch

from . import blocks as B


def rgb_to_ycc(r, g, b, dtype=torch.float32):
    """RGB -> (Y-128, Cb, Cr) int32 with C int() truncation (toward zero)."""
    rf = r.to(dtype)
    gf = g.to(dtype)
    bf = b.to(dtype)
    y = ((0.2990 * rf) + (0.5870 * gf) + (0.1140 * bf) - 128.0).to(torch.int32)
    cb = (-(0.1687 * rf) - (0.3313 * gf) + (0.5000 * bf)).to(torch.int32)
    cr = ((0.5000 * rf) - (0.4187 * gf) - (0.0813 * bf)).to(torch.int32)
    return y, cb, cr


def _clamp_u8(v):
    """Truncate toward zero, clamp to [0, 255], to uint8 (revise_value)."""
    return torch.clamp(torch.trunc(v), 0.0, 255.0).to(torch.uint8)


def ycc_to_rgb(y, cb, cr, dtype=torch.float32):
    """(Y+128-domain, Cb, Cr) int samples -> clamped uint8 RGB."""
    yf = y.to(dtype)
    cbf = cb.to(dtype)
    crf = cr.to(dtype)
    r = yf + (crf - 128.0) * 1.4020
    g = yf - (cbf - 128.0) * 0.3441 - (crf - 128.0) * 0.7139
    b = yf + (cbf - 128.0) * 1.7718
    return _clamp_u8(r), _clamp_u8(g), _clamp_u8(b)


def clamp_gray(y, dtype=torch.float32):
    """GRAY_MODE output: clamp luma directly."""
    return _clamp_u8(y.to(dtype))


def rgb_to_ycc420_plain(rgb: torch.Tensor, dtype=torch.float32):
    """rgb [N, H, W, 3] uint8 -> (Y - 128 [N, H, W], Cb, Cr [N, H/2, W/2])
    int8: rgb_to_ycc at dtype, then 4:2:0 decimation of the chroma (the
    top-left pixel of each 2x2 quad).  Every RGB triple's values fit int8
    (Y -128..127, Cb and Cr -127..127)."""
    y, cb, cr = rgb_to_ycc(rgb[..., 0], rgb[..., 1], rgb[..., 2], dtype)
    return (y.to(torch.int8), B.decimate_420(cb).to(torch.int8),
            B.decimate_420(cr).to(torch.int8))


def rgb_to_ycc420(rgb: torch.Tensor, dtype=torch.float32):
    """rgb_to_ycc420_plain's planes, bit for bit.  A CUDA tensor goes
    through the hand-written kernel (colour_cuda.rgb_to_ycc420_cuda, one
    launch), a CPU tensor through the plain version; a kernel that fails
    to build or launch raises."""
    if rgb.is_cuda:
        from .colour_cuda import rgb_to_ycc420_cuda

        return rgb_to_ycc420_cuda(rgb, dtype)
    if rgb.device.type != "cpu":
        raise ValueError(f"rgb_to_ycc420: unsupported device {rgb.device}")
    return rgb_to_ycc420_plain(rgb, dtype)


def planes_to_rgb_plain(planes, geom, gray: bool, dtype=torch.float32):
    """The rgb transport's decode after the IDCT: planes, one unclamped
    int32 plane [N, rows_c, cols_c] a component (component 0's alone with
    gray), each upsampled by its (dup_y, dup_x) = geom[c][4:6] (nearest),
    then colour conversion at dtype -> [N, rows, cols, 3] uint8, or the
    gray clamp -> [N, rows, cols, 1]."""
    up = [B.upsample_nearest(p, g[4], g[5]) for p, g in zip(planes, geom)]
    if gray:
        return clamp_gray(up[0], dtype)[..., None]
    r, g, b = ycc_to_rgb(up[0], up[1], up[2], dtype)
    return torch.stack([r, g, b], dim=-1)


def planes_to_rgb(planes, geom, gray: bool, dtype=torch.float32):
    """planes_to_rgb_plain's pixels, bit for bit.  CUDA planes go through
    the hand-written kernel (colour_cuda.ycc_planes_to_rgb_cuda: the planes
    read in place at their upsampling factors, one launch), CPU planes
    through the plain version; a kernel that fails to build or launch
    raises."""
    if planes[0].is_cuda:
        from .colour_cuda import ycc_planes_to_rgb_cuda

        return ycc_planes_to_rgb_cuda(planes, [g[4:6] for g in geom],
                                      gray=gray, dtype=dtype)
    if planes[0].device.type != "cpu":
        raise ValueError(f"planes_to_rgb: unsupported device "
                         f"{planes[0].device}")
    return planes_to_rgb_plain(planes, geom, gray, dtype)
