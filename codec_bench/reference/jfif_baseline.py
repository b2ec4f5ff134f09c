"""Plain NumPy reference of the baseline JFIF codec the benchmark holds the
port to.  It imports nothing of the port, of `jax` or of `jpezy_tpu`.

Semantics, as the configurations state them (the settings of the upstream
jpezy codec, ISO/IEC 10918-1 baseline, JFIF 1.02):

- colour: BT.601 with C truncation toward zero in jpezy's expression order,
  luma level-shifted by -128 inline; 4:2:0 decimation takes the top-left
  sample of each 2x2 quad;
- forward DCT: F[i, j] = trunc(cu cv / 4 * sum), quantised by truncating
  integer division by the Annex K tables (or their libjpeg-style scaling);
- entropy coding: the Annex K Huffman tables, DC predictors reset at every
  restart marker, each segment padded with 1-bits;
- decode: dequantise, sample = trunc(sum / 4 + 128) clamped to [0, 255]
  (T.81 A.3.3), nearest upsampling, inverse BT.601 with jpezy's constants,
  truncated and clamped.

The transforms are float64 products with a basis rounded once from extended
precision, so the reference sits on the exact sums but for ties within about
1e-13 of an integer.  `precision="tf32"` computes them instead as float32
sums of operands rounded to TF32's 10-bit mantissa: the control, one
precision below the float32 the configurations state.

Encode is vectorised over blocks.  The decoder that judges the port's
streams is a serial Huffman walk in plain Python over 32-bit windows; it
checks every marker, the restart cycle and the padding as it goes and
raises StreamError on anything a baseline decoder must refuse.
"""
from __future__ import annotations

import functools

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int64)

# Annex K.1 and K.2, natural (row-major) order
Y_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int64)
C_QUANT = np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4
                   + [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38,
                   dtype=np.int64)

# Annex K.3 to K.6: (BITS, HUFFVAL)
DC_LUMA = (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]),
           bytes(range(12)))
DC_CHROMA = (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]),
             bytes(range(12)))
AC_LUMA = (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]), bytes([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA]))
AC_CHROMA = (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), bytes([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA]))

class StreamError(ValueError):
    """A stream that a baseline decoder must refuse, or that breaks a
    setting the configuration states."""


def quant_tables(quality: int | None) -> tuple[np.ndarray, np.ndarray]:
    """(luma, chroma) tables in natural order: Annex K for None, else the
    libjpeg scaling of them, clamped to [1, 255]."""
    if quality is None:
        return Y_QUANT, C_QUANT
    if not 1 <= quality <= 100:
        raise ValueError("quality must be in 1..100")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t * scale + 50) // 100, 1, 255)
                 for t in (Y_QUANT, C_QUANT))


# ---------------------------------------------------------------------------
# Transforms
# ---------------------------------------------------------------------------

def _basis() -> np.ndarray:
    """M[p, f] = cu cv / 4 cos((2x+1) u pi / 16) cos((2y+1) v pi / 16) for
    sample p = y*8+x and frequency f = v*8+u, rounded once to float64 from
    extended precision.  The forward transform is X @ M, the inverse
    D @ M.T."""
    ld = np.longdouble
    k = np.arange(8, dtype=ld)
    cos = np.cos((2 * k[None, :] + 1) * k[:, None] * np.arccos(ld(-1)) / 16)
    c = np.ones(8, dtype=ld)
    c[0] = 1 / np.sqrt(ld(2))
    m = np.einsum("vy,ux,v,u->yxvu", cos, cos, c, c) / 4
    return m.reshape(64, 64).astype(np.float64)


_M = _basis()


def tf32(a: np.ndarray) -> np.ndarray:
    """Round float32 values to TF32's 10 explicit mantissa bits (nearest,
    ties away from zero), as a float32 array."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _product(x: np.ndarray, m: np.ndarray, precision: str) -> np.ndarray:
    if precision == "float64":
        return x.astype(np.float64) @ m
    if precision == "tf32":
        return (tf32(x.astype(np.float32)) @ tf32(m.astype(np.float32))
                ).astype(np.float64)
    raise ValueError(f"unknown precision {precision!r}")


def quantise(v: np.ndarray, q: np.ndarray) -> np.ndarray:
    """[B, 64] DCT coefficients -> quantised (natural order, int32): the
    value truncated, then its magnitude divided by the step, truncated."""
    f = np.trunc(v).astype(np.int64)
    return (np.sign(f) * (np.abs(f) // q)).astype(np.int32)


def quantised_interval(c: np.ndarray, q: np.ndarray):
    """(lo, hi): the DCT values that `quantise` takes to c lie in [lo, hi)
    for c > 0, in (lo, hi] for c < 0, in (lo, hi) for c = 0."""
    c = c.astype(np.float64)
    lo = np.where(c > 0, c * q, np.where(c < 0, (c - 1) * q, -q))
    hi = np.where(c > 0, (c + 1) * q, np.where(c < 0, c * q, q))
    return lo, hi


def fdct_quantize(blocks: np.ndarray, q: np.ndarray,
                  precision: str = "float64") -> np.ndarray:
    """[B, 64] level-shifted samples -> [B, 64] quantised coefficients
    (natural order, int32)."""
    return quantise(_product(blocks, _M, precision), q)


def idct_samples(coefs: np.ndarray, q: np.ndarray,
                 precision: str = "float64") -> np.ndarray:
    """[B, 64] quantised coefficients -> [B, 64] samples in [0, 255]."""
    d = coefs.astype(np.int64) * q
    s = _product(d, _M.T, precision)
    return np.clip(np.trunc(s + 128.0), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Colour and geometry (4:2:0, width and height multiples of 16)
# ---------------------------------------------------------------------------

def rgb_to_ycc420(rgb: np.ndarray):
    """[H, W, 3] uint8 -> (y [H, W], cb [H/2, W/2], cr [H/2, W/2]) int32,
    luma level-shifted, chroma decimated to the top-left of each quad."""
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    y = np.trunc((0.2990 * r) + (0.5870 * g) + (0.1140 * b) - 128.0)
    r, g, b = r[::2, ::2], g[::2, ::2], b[::2, ::2]
    cb = np.trunc(-(0.1687 * r) - (0.3313 * g) + (0.5000 * b))
    cr = np.trunc((0.5000 * r) - (0.4187 * g) - (0.0813 * b))
    return y.astype(np.int32), cb.astype(np.int32), cr.astype(np.int32)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Full-resolution uint8 planes -> [H, W, 3] uint8."""
    yf, cbf, crf = (p.astype(np.float64) for p in (y, cb, cr))
    r = yf + (crf - 0x80) * 1.4020
    g = yf - (cbf - 0x80) * 0.3441 - (crf - 0x80) * 0.7139
    b = yf + (cbf - 0x80) * 1.7718
    return np.stack([np.clip(np.trunc(v), 0, 255).astype(np.uint8)
                     for v in (r, g, b)], axis=-1)


def luma_blocks(y: np.ndarray) -> np.ndarray:
    """[H, W] -> [nmcu*4, 64], MCU order, TL TR BL BR within an MCU."""
    my, mx = y.shape[0] // 16, y.shape[1] // 16
    return y.reshape(my, 2, 8, mx, 2, 8).transpose(0, 3, 1, 4, 2, 5) \
        .reshape(my * mx * 4, 64)


def chroma_blocks(c: np.ndarray) -> np.ndarray:
    my, mx = c.shape[0] // 8, c.shape[1] // 8
    return c.reshape(my, 8, mx, 8).transpose(0, 2, 1, 3).reshape(my * mx, 64)


def luma_plane(blocks: np.ndarray, my: int, mx: int) -> np.ndarray:
    return blocks.reshape(my, mx, 2, 2, 8, 8).transpose(0, 2, 4, 1, 3, 5) \
        .reshape(my * 16, mx * 16)


def chroma_plane(blocks: np.ndarray, my: int, mx: int) -> np.ndarray:
    return blocks.reshape(my, mx, 8, 8).transpose(0, 2, 1, 3) \
        .reshape(my * 8, mx * 8)


def dct_blocks(rgb: np.ndarray, precision: str = "float64"):
    """[H, W, 3] uint8 -> (y [nmcu*4, 64], cb [nmcu, 64], cr [nmcu, 64])
    DCT coefficients before quantisation, natural order, float64."""
    if rgb.shape[0] % 16 or rgb.shape[1] % 16:
        raise ValueError("the reference takes multiple-of-16 images")
    y, cb, cr = rgb_to_ycc420(rgb)
    return tuple(_product(b, _M, precision) for b in
                 (luma_blocks(y), chroma_blocks(cb), chroma_blocks(cr)))


def quantised_blocks(rgb: np.ndarray, quality: int | None = None,
                     precision: str = "float64"):
    """[H, W, 3] uint8 -> (y [nmcu*4, 64], cb [nmcu, 64], cr [nmcu, 64])
    quantised coefficients, natural order."""
    yq, cq = quant_tables(quality)
    return tuple(quantise(v, q) for v, q in
                 zip(dct_blocks(rgb, precision), (yq, cq, cq)))


def pixels(coefs, height: int, width: int, quality: int | None = None,
           precision: str = "float64") -> np.ndarray:
    """Quantised (y, cb, cr) blocks -> [H, W, 3] uint8."""
    yq, cq = quant_tables(quality)
    my, mx = height // 16, width // 16
    y = luma_plane(idct_samples(coefs[0], yq, precision), my, mx)
    cb, cr = (chroma_plane(idct_samples(c, cq, precision), my, mx)
              .repeat(2, 0).repeat(2, 1) for c in coefs[1:])
    return ycc_to_rgb(y, cb, cr)


# ---------------------------------------------------------------------------
# Huffman tables, header and entropy coding
# ---------------------------------------------------------------------------

def canonical(table) -> dict[int, tuple[int, int]]:
    """HUFFVAL symbol -> (code, length) of a (BITS, HUFFVAL) table."""
    bits, vals = table
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def header(width: int, height: int, restart_interval: int,
           quality: int | None) -> bytes:
    """SOI, APP0 (JFIF 1.02), DQT, SOF0 (4:2:0), DHT (Annex K), DRI where
    restart_interval > 0, SOS."""
    yq, cq = quant_tables(quality)
    out = b"\xff\xd8" + _segment(0xE0, b"JFIF\x00\x01\x02\x00\x00\x01\x00\x01"
                                 b"\x00\x00")
    for tid, qt in ((0, yq), (1, cq)):
        out += _segment(0xDB, bytes([tid]) + bytes(int(v) for v in qt[ZIGZAG]))
    out += _segment(0xC0, bytes([8]) + height.to_bytes(2, "big")
                    + width.to_bytes(2, "big")
                    + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for tc, th, (bits, vals) in ((0, 0, DC_LUMA), (0, 1, DC_CHROMA),
                                 (1, 0, AC_LUMA), (1, 1, AC_CHROMA)):
        out += _segment(0xC4, bytes([tc << 4 | th]) + bits + vals)
    if restart_interval:
        out += _segment(0xDD, restart_interval.to_bytes(2, "big"))
    return out + _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))


def _code_arrays(table) -> tuple[np.ndarray, np.ndarray]:
    codes = np.zeros(256, np.int64)
    lens = np.zeros(256, np.int64)
    for sym, (c, n) in canonical(table).items():
        codes[sym], lens[sym] = c, n
    return codes, lens


def _block_emissions(q: np.ndarray, pred: np.ndarray, order: np.ndarray,
                     dc_table, ac_table):
    """Emissions of [B, 64] quantised blocks with [B] DC predictors, block
    i written as the order[i]-th block of the scan: (keys, values,
    lengths), keys ordering every emission of the scan.  Per block: the
    DC code and bits, then for each nonzero zigzag coefficient its ZRLs
    and code (one value) and its bits, then EOB unless position 63 is
    nonzero."""
    dcc, dcl = _code_arrays(dc_table)
    acc, acl = _code_arrays(ac_table)
    base = order.astype(np.int64) * _SLOTS
    diff = q[:, 0].astype(np.int64) - pred
    s = _size(diff)
    zz = q[:, ZIGZAG[1:]].astype(np.int64)
    blk, pos = np.nonzero(zz)
    v = zz[blk, pos]
    pos = pos + 1
    prev = np.concatenate([[0], pos[:-1]])
    prev[np.concatenate([[True], blk[1:] != blk[:-1]])] = 0
    run = pos - prev - 1
    nzrl = run >> 4
    sa = _size(v)
    sym = ((run & 15) << 4) | sa
    zc, zl = acc[0xF0], acl[0xF0]
    zrl_bits = np.zeros_like(v)
    for k in range(3):
        zrl_bits = np.where(nzrl > k, (zrl_bits << zl) | zc, zrl_bits)
    eob = np.flatnonzero(zz[:, -1] == 0)
    keys = np.concatenate([base, base + 1, base[blk] + 2 * pos,
                           base[blk] + 2 * pos + 1, base[eob] + _SLOTS - 1])
    vals = np.concatenate([dcc[s], np.where(diff < 0, diff - 1, diff)
                           & ((1 << s) - 1), (zrl_bits << acl[sym]) | acc[sym],
                           np.where(v < 0, v - 1, v) & ((1 << sa) - 1),
                           np.full(eob.size, acc[0x00])])
    lens = np.concatenate([dcl[s], s, acl[sym] + nzrl * zl, sa,
                           np.full(eob.size, acl[0x00])])
    return keys, vals, lens


_SLOTS = 2 * 64 + 1


def _size(v: np.ndarray) -> np.ndarray:
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _pack(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """Emissions, MSB first, padded with 1-bits to a byte, stuffed."""
    keep = lens > 0
    v, n = vals[keep], lens[keep]
    total = int(n.sum())
    if total == 0:
        return b""
    start = np.cumsum(n) - n
    rep = np.repeat(np.arange(v.size), n)
    shift = n[rep] - 1 - (np.arange(total) - start[rep])
    bits = ((v[rep] >> shift) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])
    return np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")


def encode(coefs, width: int, height: int, restart_interval: int = 0,
           quality: int | None = None) -> bytes:
    """Quantised (y, cb, cr) blocks -> a baseline JFIF stream."""
    yb, cbb, crb = coefs
    nmcu = cbb.shape[0]
    ri = restart_interval or nmcu
    parts = []
    # scan order: each MCU's 4 luma blocks, then its Cb and Cr block
    for q, per, first, dct, act in ((yb, 4, 0, DC_LUMA, AC_LUMA),
                                    (cbb, 1, 4, DC_CHROMA, AC_CHROMA),
                                    (crb, 1, 5, DC_CHROMA, AC_CHROMA)):
        i = np.arange(q.shape[0])
        pred = np.concatenate([[0], q[:-1, 0]]).astype(np.int64)
        pred[(i % per == 0) & (i // per % ri == 0)] = 0
        parts.append(_block_emissions(q, pred, i // per * 6 + first + i % per,
                                      dct, act))
    keys, vals, lens = (np.concatenate(x) for x in zip(*parts))
    order = np.argsort(keys, kind="stable")
    keys, vals, lens = keys[order], vals[order], lens[order]
    cuts = np.searchsorted(keys, np.arange(0, nmcu, ri) * 6 * _SLOTS)
    body = bytearray()
    for s, (a, b) in enumerate(zip(cuts, list(cuts[1:]) + [keys.size])):
        if s:
            body += bytes([0xFF, 0xD0 + (s - 1) % 8])
        body += _pack(vals[a:b], lens[a:b])
    return header(width, height, restart_interval, quality) + bytes(body) \
        + b"\xff\xd9"


# ---------------------------------------------------------------------------
# Parse and decode (judging the port's streams)
# ---------------------------------------------------------------------------

def parse(stream: bytes) -> dict:
    """Marker walk from SOI to the first SOS.  Returns the frame, tables,
    restart interval and the offset of the entropy-coded data."""
    if stream[:2] != b"\xff\xd8":
        raise StreamError("no SOI")
    if stream[-2:] != b"\xff\xd9":
        raise StreamError("no EOI at the end")
    out = dict(quant={}, huff={}, ri=0, frame=None)
    p = 2
    while True:
        if p + 4 > len(stream) or stream[p] != 0xFF:
            raise StreamError(f"no marker at byte {p}")
        m = stream[p + 1]
        n = int.from_bytes(stream[p + 2:p + 4], "big")
        body = stream[p + 4:p + 2 + n]
        if len(body) != n - 2:
            raise StreamError("segment runs past the stream")
        p += 2 + n
        if m == 0xDB:
            k = 0
            while k < len(body):
                if body[k] >> 4:
                    raise StreamError("16-bit DQT in a baseline stream")
                t = np.zeros(64, np.int64)
                t[ZIGZAG] = np.frombuffer(body[k + 1:k + 65], np.uint8)
                out["quant"][body[k] & 15] = t
                k += 65
        elif m == 0xC4:
            k = 0
            while k < len(body):
                bits = bytes(body[k + 1:k + 17])
                nv = sum(bits)
                out["huff"][(body[k] >> 4, body[k] & 15)] = (
                    bits, bytes(body[k + 17:k + 17 + nv]))
                k += 17 + nv
        elif m == 0xC0:
            nc = body[5]
            out["frame"] = dict(
                precision=body[0], height=int.from_bytes(body[1:3], "big"),
                width=int.from_bytes(body[3:5], "big"),
                comps=[(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                        body[7 + 3 * i] & 15, body[8 + 3 * i])
                       for i in range(nc)])
        elif m == 0xDD:
            out["ri"] = int.from_bytes(body[:2], "big")
        elif m == 0xDA:
            ns = body[0]
            out["scan"] = [(body[1 + 2 * i], body[2 + 2 * i] >> 4,
                            body[2 + 2 * i] & 15) for i in range(ns)]
            out["spectral"] = tuple(body[1 + 2 * ns:4 + 2 * ns])
            out["data"] = p
            return out
        elif m in (0xC1, 0xC2, 0xC3) or 0xC5 <= m <= 0xCF and m != 0xC8:
            raise StreamError(f"not a baseline frame (SOF {m:#x})")
        elif not (0xE0 <= m <= 0xEF or m == 0xFE):
            raise StreamError(f"unexpected marker {m:#x} before SOS")


def check_settings(info: dict, width: int, height: int, restart_interval: int,
                   quality: int | None) -> None:
    """Raise StreamError where a parsed header departs from what the
    configuration states: the size, 8-bit 4:2:0 in one interleaved scan,
    the quantisation tables, the Annex K Huffman tables and the DRI."""
    f = info["frame"]
    if f is None or f["precision"] != 8:
        raise StreamError("no 8-bit SOF0")
    if (f["width"], f["height"]) != (width, height):
        raise StreamError(f"size {f['width']}x{f['height']}")
    comps = f["comps"]
    if [(h, v) for _, h, v, _ in comps] != [(2, 2), (1, 1), (1, 1)]:
        raise StreamError("not 4:2:0")
    yq, cq = quant_tables(quality)
    for (_, _, _, tq), want in zip(comps, (yq, cq, cq)):
        if tq not in info["quant"] or not np.array_equal(info["quant"][tq],
                                                         want):
            raise StreamError("quantisation tables differ")
    if [c for c, _, _ in info["scan"]] != [c for c, _, _, _ in comps] \
            or info["spectral"] != (0, 63, 0):
        raise StreamError("not one interleaved baseline scan")
    for (_, td, ta), (dc, ac) in zip(info["scan"],
                                     ((DC_LUMA, AC_LUMA),) + 2 * ((DC_CHROMA,
                                                                  AC_CHROMA),)):
        if info["huff"].get((0, td)) != dc or info["huff"].get((1, ta)) != ac:
            raise StreamError("Huffman tables differ from Annex K")
    if info["ri"] != restart_interval:
        raise StreamError(f"restart interval {info['ri']}")


@functools.cache
def _lut(table) -> list[int]:
    """16-bit window -> symbol << 5 | length, -1 where no code starts."""
    lut = [-1] * 65536
    for sym, (code, n) in canonical(table).items():
        lo = code << (16 - n)
        lut[lo:lo + (1 << (16 - n))] = [sym << 5 | n] * (1 << (16 - n))
    return lut


def _segments(stream: bytes, start: int, count: int) -> list[bytes]:
    """The entropy-coded data after SOS split at RSTn, destuffed; the RSTn
    must cycle 0..7 and nothing else may follow but EOI."""
    data = stream[start:-2]
    pieces, p, k = [], 0, 0
    while True:
        q = data.find(b"\xff", p)
        while q >= 0 and q + 1 < len(data) and data[q + 1] == 0:
            q = data.find(b"\xff", q + 2)
        if q < 0:
            pieces.append(data[p:])
            break
        if q + 1 >= len(data) or data[q + 1] != 0xD0 + k % 8:
            raise StreamError(f"unexpected marker in the entropy data at "
                              f"{start + q}")
        pieces.append(data[p:q])
        p, k = q + 2, k + 1
    if len(pieces) != count:
        raise StreamError(f"{len(pieces)} entropy segments, want {count}")
    return [s.replace(b"\xff\x00", b"\xff") for s in pieces]


def _decode_segment(seg: bytes, blocks, luts, out, first: int) -> None:
    """Decode `blocks` (component index per block, in stream order) from
    one segment into out[c]: flat lists of 64 coefficients a block
    (natural order), starting at block first[c]."""
    n = len(seg)
    pad = seg + b"\xff" * 8
    arr = np.frombuffer(pad, np.uint8).astype(np.int64)
    win = ((arr[:-3] << 24) | (arr[1:-2] << 16) | (arr[2:-1] << 8)
           | arr[3:]).tolist()
    zz = ZIGZAG.tolist()
    pos = 0
    pred = [0, 0, 0]
    nxt = list(first)
    for c in blocks:
        dlut, alut = luts[c]
        o = out[c]
        base = nxt[c] * 64
        nxt[c] += 1
        e = dlut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
        if e < 0:
            raise StreamError("bad DC code")
        pos += e & 31
        s = e >> 5
        v = 0
        if s:
            v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
            if v < 1 << (s - 1):
                v -= (1 << s) - 1
            pos += s
        pred[c] += v
        o[base] = pred[c]
        k = 1
        while k < 64:
            e = alut[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
            if e < 0:
                raise StreamError("bad AC code")
            pos += e & 31
            rs = e >> 5
            s = rs & 15
            if not s:
                if rs == 0xF0:
                    k += 16
                    if k > 63:
                        raise StreamError("ZRL past the block")
                    continue
                if rs:
                    raise StreamError("bad AC symbol")
                break
            k += rs >> 4
            if k > 63:
                raise StreamError("AC run past the block")
            v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
            if v < 1 << (s - 1):
                v -= (1 << s) - 1
            pos += s
            o[base + zz[k]] = v
            k += 1
    rest = 8 * n - pos
    if rest < 0:
        raise StreamError("entropy segment ends inside a code")
    if rest >= 8 or (rest and ~seg[-1] & ((1 << rest) - 1)):
        raise StreamError("entropy segment not padded with 1-bits to a byte")


def decode_coefficients(stream: bytes, width: int, height: int,
                        restart_interval: int, quality: int | None):
    """A stream the configuration describes -> quantised (y, cb, cr)
    blocks [B, 64] int32, natural order.  Raises StreamError."""
    info = parse(stream)
    check_settings(info, width, height, restart_interval, quality)
    my, mx = height // 16, width // 16
    nmcu = my * mx
    ri = restart_interval or nmcu
    nseg = -(-nmcu // ri)
    segs = _segments(stream, info["data"], nseg)
    luts = [(_lut(DC_LUMA), _lut(AC_LUMA))] \
        + 2 * [(_lut(DC_CHROMA), _lut(AC_CHROMA))]
    out = [[0] * (64 * 4 * nmcu), [0] * (64 * nmcu), [0] * (64 * nmcu)]
    for s, seg in enumerate(segs):
        m = min(ri, nmcu - s * ri)
        try:
            _decode_segment(seg, [0, 0, 0, 0, 1, 2] * m, luts, out,
                            [4 * s * ri, s * ri, s * ri])
        except IndexError:
            raise StreamError("entropy segment runs past its end") from None
    return tuple(np.asarray(o, np.int32).reshape(-1, 64) for o in out)
