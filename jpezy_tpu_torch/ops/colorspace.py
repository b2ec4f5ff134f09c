"""Colour conversion over whole planes (torch).

Counterpart of jpezy_tpu/ops/colorspace.py, same expressions in the same
order, each a separate multiply or add (eager torch fuses none into a
multiply-add), so float64 ("exact" mode) reproduces the reference's
double-precision truncation bit for bit.  float32 is the fast path of the
`rgb` transports.
"""
from __future__ import annotations

import torch


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
