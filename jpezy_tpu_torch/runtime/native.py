"""ctypes loader for the C++ host runtime (csrc/jpezy_host.cpp).

Builds lazily with g++ on first import (cached in build/), falls back with
ImportError so every caller has a numpy path.  Covers the host-side hot
loops: PPM ASCII tokenizing, P3 serialization, bitstring splice, byte
stuffing, and the serial Huffman decode frontend.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "csrc", "jpezy_host.cpp")
_BUILD_DIR = os.path.join(_REPO, "build")
_SO = os.path.join(_BUILD_DIR, "libjpezy_host.so")

_lock = threading.Lock()
_lib = None


class NativeUnavailable(ImportError):
    pass


def _build() -> None:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # -ffp-contract=off: the host-codec DCT/IDCT must round exactly like
    # numpy float64 (no a*b+c FMA fusion) to stay bit-identical to the
    # oracle's reference semantics
    cmd = [
        "g++", "-O3", "-march=native", "-ffp-contract=off", "-std=c++17",
        "-shared", "-fPIC", _SRC, "-o", _SO + ".tmp",
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(_SO + ".tmp", _SO)


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                _build()
            lib = ctypes.CDLL(_SO)
        except (OSError, subprocess.CalledProcessError) as e:
            raise NativeUnavailable(f"native host lib unavailable: {e}") from e

        c_i32p = ctypes.POINTER(ctypes.c_int32)
        c_u8p = ctypes.POINTER(ctypes.c_uint8)
        c_u32p = ctypes.POINTER(ctypes.c_uint32)

        lib.jz_scan_ints_i32.restype = ctypes.c_long
        lib.jz_scan_ints_i32.argtypes = [ctypes.c_char_p, ctypes.c_long, c_i32p, ctypes.c_long]
        lib.jz_serialize_p3_pixels.restype = ctypes.c_long
        lib.jz_serialize_p3_pixels.argtypes = [c_u8p, ctypes.c_long, ctypes.c_char_p]
        lib.jz_byte_stuff.restype = ctypes.c_long
        lib.jz_byte_stuff.argtypes = [c_u8p, ctypes.c_long, c_u8p]
        lib.jz_splice_bits.restype = ctypes.c_long
        lib.jz_splice_bits.argtypes = [c_u32p, c_i32p, ctypes.c_long, ctypes.c_int, c_u8p]
        lib.jz_entropy_decode.restype = ctypes.c_int64
        c_i16p = ctypes.POINTER(ctypes.c_int16)
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        lib.jz_entropy_decode.argtypes = [
            c_u8p, ctypes.c_long,
            ctypes.POINTER(c_i32p), ctypes.POINTER(c_i32p),
            c_i32p, ctypes.c_int, c_i32p, c_i32p,
            ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(c_i16p),
        ]
        lib.jz_find_restarts.restype = ctypes.c_long
        lib.jz_find_restarts.argtypes = [c_u8p, ctypes.c_long, c_i64p, ctypes.c_long]
        lib.jz_destuff.restype = ctypes.c_long
        lib.jz_destuff.argtypes = [c_u8p, ctypes.c_long, c_u8p, ctypes.POINTER(ctypes.c_long)]
        lib.jz_sparsify.restype = ctypes.c_long
        lib.jz_sparsify.argtypes = [
            c_i16p, ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            c_i16p, c_i64p, ctypes.c_long,
        ]
        c_i8p_ = ctypes.POINTER(ctypes.c_int8)
        lib.jz_sparsify_i8.restype = ctypes.c_long
        lib.jz_sparsify_i8.argtypes = [
            c_i16p, ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            c_i8p_, c_i64p, ctypes.c_long,
        ]
        lib.jz_ycc420_to_rgb.restype = None
        lib.jz_ycc420_to_rgb.argtypes = [
            c_u8p, c_u8p, c_u8p, ctypes.c_long, ctypes.c_long, c_u8p,
        ]
        lib.jz_ycc_to_rgb_i32.restype = None
        lib.jz_ycc_to_rgb_i32.argtypes = [
            c_i32p, c_i32p, c_i32p, ctypes.c_long, ctypes.c_long, c_u8p,
            ctypes.c_int,
        ]
        lib.jz_ycc420_to_rgb_batch.restype = None
        lib.jz_ycc420_to_rgb_batch.argtypes = [
            c_u8p, c_u8p, c_u8p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            c_u8p, ctypes.c_int,
        ]
        c_i8p = ctypes.POINTER(ctypes.c_int8)
        lib.jz_rgb_to_ycc420.restype = None
        lib.jz_rgb_to_ycc420.argtypes = [
            c_u8p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            c_i8p, c_i8p, c_i8p, ctypes.c_int,
        ]
        lib.jz_destuff_segments.restype = ctypes.c_long
        lib.jz_destuff_segments.argtypes = [
            c_u8p, ctypes.c_long, c_i64p, ctypes.c_long,
            c_u8p, ctypes.c_long, c_i64p, ctypes.c_int,
        ]
        lib.jz_entropy_decode_mt.restype = ctypes.c_int64
        lib.jz_entropy_decode_mt.argtypes = [
            c_u8p, ctypes.c_long, c_i64p, ctypes.c_long,
            ctypes.POINTER(c_i32p), ctypes.POINTER(c_i32p),
            c_i32p, ctypes.c_int, c_i32p, c_i32p,
            ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(c_i16p), ctypes.c_int,
        ]
        lib.jz_index_scan.restype = ctypes.c_int64
        lib.jz_index_scan.argtypes = [
            c_u8p, ctypes.c_long,
            ctypes.POINTER(c_i32p), ctypes.POINTER(c_i32p),
            ctypes.c_int, c_i32p, c_i32p,
            ctypes.c_int64, ctypes.c_int64,
            c_i64p, c_i32p,
        ]
        lib.jz_copy_bit_windows.restype = ctypes.c_long
        lib.jz_copy_bit_windows.argtypes = [
            c_u8p, ctypes.c_long, c_i64p, ctypes.c_long,
            c_u8p, ctypes.c_long,
        ]
        c_dp = ctypes.POINTER(ctypes.c_double)
        lib.jz_fdct_quant.restype = None
        lib.jz_fdct_quant.argtypes = [
            ctypes.POINTER(ctypes.c_int8), ctypes.c_long,
            c_dp, c_dp, c_dp, c_i32p, c_i32p, ctypes.c_int,
        ]
        lib.jz_idct_dequant.restype = None
        lib.jz_idct_dequant.argtypes = [
            c_i16p, ctypes.c_long, c_i32p,
            c_dp, c_dp, c_dp, ctypes.c_int, c_i32p, ctypes.c_int,
        ]
        lib.jz_entropy_encode.restype = ctypes.c_int64
        lib.jz_entropy_encode.argtypes = [
            c_i32p, c_i32p, c_i32p, ctypes.c_long, ctypes.c_int, c_i32p,
            c_u32p, c_u32p, c_u32p, c_u32p,
            c_u8p, ctypes.c_long, c_u32p,
        ]
        lib.jz_entropy_decode_fast.restype = ctypes.c_int64
        lib.jz_entropy_decode_fast.argtypes = [
            c_u8p, ctypes.c_long,
            ctypes.POINTER(c_i32p), ctypes.POINTER(c_i32p),
            c_i32p, ctypes.c_int, c_i32p, c_i32p,
            ctypes.c_int64,
            ctypes.POINTER(c_i16p),
        ]
        _lib = lib
        return _lib


def _i32p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def scan_ints(data: bytes, cap: int) -> np.ndarray:
    """All whitespace-separated ints in data (comments skipped)."""
    lib = get_lib()
    out = np.empty(cap, dtype=np.int32)
    n = lib.jz_scan_ints_i32(data, len(data), _i32p(out), cap)
    return out[:n]


def serialize_p3_pixels(rgb: np.ndarray) -> bytes:
    """rgb [H, W, 3] uint8 -> b'r g b\\n' per pixel."""
    lib = get_lib()
    flat = np.ascontiguousarray(rgb, dtype=np.uint8)
    npix = flat.size // 3
    buf = ctypes.create_string_buffer(npix * 12)
    n = lib.jz_serialize_p3_pixels(_u8p(flat), npix, buf)
    return buf.raw[:n]


def byte_stuff(data: bytes) -> bytes:
    lib = get_lib()
    arr = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(2 * len(arr) + 1, dtype=np.uint8)
    n = lib.jz_byte_stuff(_u8p(arr), len(arr), _u8p(out))
    return out[:n].tobytes()


def splice_bits(words: np.ndarray, bits: np.ndarray) -> tuple[bytes, int]:
    """Per-block words [B, W] uint32 + bit counts [B] -> packed bytes."""
    lib = get_lib()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    bits_arr = np.ascontiguousarray(bits, dtype=np.int32)
    total = int(bits_arr.sum())
    out = np.zeros((total + 7) // 8 + 8, dtype=np.uint8)  # +slack for 5-byte OR
    n = lib.jz_splice_bits(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        _i32p(bits_arr), words.shape[0], words.shape[1], _u8p(out),
    )
    assert n == total
    return out[: (total + 7) // 8].tobytes(), total


def _huff_lut(tbl) -> np.ndarray:
    """16-bit window -> (HUFFVAL << 8) | code_length, -1 invalid."""
    lut = np.full(1 << 16, -1, dtype=np.int32)
    for size, code, value in zip(tbl.sizes, tbl.codes, tbl.values):
        size = int(size); code = int(code)
        lo = code << (16 - size)
        lut[lo : lo + (1 << (16 - size))] = (int(value) << 8) | size
    return lut


def sparsify(dense: np.ndarray, k: int = 10):
    """[B, 64] int16 blocks -> (mask_lo, mask_hi [B] uint32, vals [B, k]
    int16, overflow_idx int64, overflow_rows [n, 64] int16).

    Compact host->device coefficient transport (~5x smaller than dense for
    Annex-K quality streams)."""
    lib = get_lib()
    dense = np.ascontiguousarray(dense, dtype=np.int16)
    B = dense.shape[0]
    mask_lo = np.empty(B, dtype=np.uint32)
    mask_hi = np.empty(B, dtype=np.uint32)
    vals = np.zeros((B, k), dtype=np.int16)
    cap = max(16, B // 8)
    ovf = np.zeros(cap, dtype=np.int64)
    P16 = ctypes.POINTER(ctypes.c_int16)
    n = lib.jz_sparsify(
        dense.ctypes.data_as(P16), B, k,
        mask_lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        mask_hi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        vals.ctypes.data_as(P16),
        ovf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
    )
    if n > cap:  # extremely dense content: re-run with a bigger overflow list
        cap = B
        ovf = np.zeros(cap, dtype=np.int64)
        n = lib.jz_sparsify(
            dense.ctypes.data_as(P16), B, k,
            mask_lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            mask_hi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            vals.ctypes.data_as(P16),
            ovf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
        )
    idx = ovf[:n]
    return mask_lo, mask_hi, vals, idx, dense[idx]


def sparsify8(dense: np.ndarray, k: int = 10):
    """[B, 64] int16 blocks -> (mask_lo, mask_hi [B] uint32, vals [B, k]
    INT8, overflow_idx int64, overflow_rows [n, 64] int16).

    One byte per value (~35% fewer upload bytes than sparsify); blocks
    with any |coef| > 127 or more than k nonzeros go whole to the overflow
    rows (their masks are cleared, the dense scatter row replaces them)."""
    lib = get_lib()
    dense = np.ascontiguousarray(dense, dtype=np.int16)
    B = dense.shape[0]
    mask_lo = np.empty(B, dtype=np.uint32)
    mask_hi = np.empty(B, dtype=np.uint32)
    vals = np.zeros((B, k), dtype=np.int8)
    cap = max(16, B // 8)
    P16 = ctypes.POINTER(ctypes.c_int16)
    P8 = ctypes.POINTER(ctypes.c_int8)
    for _ in range(2):
        ovf = np.zeros(cap, dtype=np.int64)
        n = lib.jz_sparsify_i8(
            dense.ctypes.data_as(P16), B, k,
            mask_lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            mask_hi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            vals.ctypes.data_as(P8),
            ovf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap,
        )
        if n <= cap:
            break
        cap = B  # extremely dense content: one retry with full capacity
    idx = ovf[:n]
    return mask_lo, mask_hi, vals, idx, dense[idx]


def find_restart_offsets(data: np.ndarray, n_mcus: int,
                         restart_interval: int) -> np.ndarray:
    """Segment start offsets [nseg] int64 into entropy `data` (segment 0 at
    0, then one per RSTn marker).  Raises on a marker-count mismatch."""
    lib = get_lib()
    nseg = -(-n_mcus // restart_interval)
    marks = np.zeros(nseg + 1, dtype=np.int64)
    nmarks = lib.jz_find_restarts(
        _u8p(data), len(data),
        marks.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), nseg + 1)
    if nmarks != nseg - 1:
        raise ValueError(
            f"expected {nseg - 1} restart markers, found {nmarks}")
    offsets = np.zeros(nseg, dtype=np.int64)
    offsets[1:] = marks[: nseg - 1]
    return offsets


def destuff_segments(data: np.ndarray, seg_offsets: np.ndarray,
                     out_rows: np.ndarray, out_lens: np.ndarray | None = None,
                     nthreads: int = 0) -> int:
    """Destuff each restart segment into zero-padded rows of out_rows
    [nseg, L] uint8 (caller-zeroed).  out_lens [nseg] int64 (optional)
    receives per-segment destuffed byte lengths (the device decoder's
    bit-consumption corruption check).  Returns max destuffed length."""
    lib = get_lib()
    data = np.ascontiguousarray(data, np.uint8)
    seg_offsets = np.ascontiguousarray(seg_offsets, np.int64)
    nseg, L = out_rows.shape
    P64 = ctypes.POINTER(ctypes.c_int64)
    rc = lib.jz_destuff_segments(
        _u8p(data), len(data),
        seg_offsets.ctypes.data_as(P64), nseg,
        _u8p(out_rows), L,
        None if out_lens is None else out_lens.ctypes.data_as(P64),
        nthreads)
    if rc < 0:
        raise ValueError(f"segment {-rc - 1} overflowed the row stride {L}")
    return int(rc)


def rgb_to_ycc420(rgbs: np.ndarray, nthreads: int = 0):
    """[N, H, W, 3] u8 -> (y [N,H,W] i8, cb, cr [N,H/2,W/2] i8), the
    reference's double-precision color math (multithreaded).

    Bit-identical to jax_codec.host_rgb_to_ycc420's numpy path and ~20x
    faster: this is the encode pipeline's host bottleneck stage."""
    lib = get_lib()
    rgbs = np.ascontiguousarray(rgbs, dtype=np.uint8)
    N, H, W = rgbs.shape[:3]
    y = np.empty((N, H, W), dtype=np.int8)
    cb = np.empty((N, H // 2, W // 2), dtype=np.int8)
    cr = np.empty((N, H // 2, W // 2), dtype=np.int8)
    P8 = ctypes.POINTER(ctypes.c_int8)
    lib.jz_rgb_to_ycc420(
        _u8p(rgbs), N, H, W,
        y.ctypes.data_as(P8), cb.ctypes.data_as(P8), cr.ctypes.data_as(P8),
        nthreads,
    )
    return y, cb, cr


def ycc420_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Native-resolution planes -> interleaved RGB (reference color tail)."""
    lib = get_lib()
    H, W = y.shape
    y = np.ascontiguousarray(y, dtype=np.uint8)
    cb = np.ascontiguousarray(cb, dtype=np.uint8)
    cr = np.ascontiguousarray(cr, dtype=np.uint8)
    out = np.empty((H, W, 3), dtype=np.uint8)
    lib.jz_ycc420_to_rgb(_u8p(y), _u8p(cb), _u8p(cr), H, W, _u8p(out))
    return out


def ycc_to_rgb_i32(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                   nthreads: int = 0) -> np.ndarray:
    """Full-resolution int32 planes -> [H, W, 3] u8 RGB, the reference's
    exact double-precision tail (clamp AFTER color; bit-identical to
    codec/oracle.ycc_to_rgb)."""
    lib = get_lib()
    H, W = y.shape
    y = np.ascontiguousarray(y, np.int32)
    cb = np.ascontiguousarray(cb, np.int32)
    cr = np.ascontiguousarray(cr, np.int32)
    out = np.empty((H, W, 3), np.uint8)
    lib.jz_ycc_to_rgb_i32(_i32p(y), _i32p(cb), _i32p(cr), H, W,
                          _u8p(out), nthreads)
    return out


def ycc420_to_rgb_batch(ys: np.ndarray, cbs: np.ndarray, crs: np.ndarray,
                        nthreads: int = 0) -> np.ndarray:
    """[N, H, W] + 2x [N, H/2, W/2] u8 planes -> [N, H, W, 3] RGB,
    multithreaded (the batched decode pipeline's host color tail)."""
    lib = get_lib()
    N, H, W = ys.shape
    ys = np.ascontiguousarray(ys, dtype=np.uint8)
    cbs = np.ascontiguousarray(cbs, dtype=np.uint8)
    crs = np.ascontiguousarray(crs, dtype=np.uint8)
    out = np.empty((N, H, W, 3), dtype=np.uint8)
    lib.jz_ycc420_to_rgb_batch(
        _u8p(ys), _u8p(cbs), _u8p(crs), N, H, W, _u8p(out), nthreads)
    return out


def index_scan(pj, n_mcus: int, k_mcus: int):
    """Pass 1 of the index-assisted restart-free parallel decode: destuff,
    then a serial LENGTH-ONLY scan recording every k_mcus MCUs the bit
    offset + absolute DC predictors (SURVEY 2.7 option (b)).

    Returns (destuffed [n+8] u8 zero-padded, bitoffs [nseg] i64,
    preds [nseg, 3] i32)."""
    lib = get_lib()
    dc_luts = [_huff_lut(pj.huff[0][sc.Td]) for sc in pj.scan_components]
    ac_luts = [_huff_lut(pj.huff[1][sc.Ta]) for sc in pj.scan_components]
    ncomp = len(pj.scan_components)
    comp_h = np.array([fc.H for fc in pj.frame_components], np.int32)
    comp_v = np.array([fc.V for fc in pj.frame_components], np.int32)
    data = np.ascontiguousarray(
        np.frombuffer(pj.data, np.uint8)[pj.entropy_start:])
    destuffed = np.zeros(len(data) + 8, np.uint8)
    consumed = ctypes.c_long(0)
    nd = lib.jz_destuff(_u8p(data), len(data), _u8p(destuffed),
                        ctypes.byref(consumed))
    nseg = -(-n_mcus // k_mcus)
    bitoffs = np.zeros(nseg, np.int64)
    preds = np.zeros((nseg, 3), np.int32)
    P = ctypes.POINTER(ctypes.c_int32)
    dc_arr = (P * ncomp)(*[_i32p(a) for a in dc_luts])
    ac_arr = (P * ncomp)(*[_i32p(a) for a in ac_luts])
    rc = lib.jz_index_scan(
        _u8p(destuffed), int(nd), dc_arr, ac_arr,
        ncomp, _i32p(comp_h), _i32p(comp_v),
        n_mcus, k_mcus,
        bitoffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _i32p(preds))
    if rc != nseg:
        raise ValueError(f"index scan failed: rc={rc}")
    return destuffed[: int(nd) + 8], bitoffs, preds


def copy_bit_windows(destuffed: np.ndarray, bitoffs: np.ndarray,
                     out_rows: np.ndarray) -> int:
    """Pass-2 prep: copy each pseudo-segment's byte window into
    zero-padded rows of out_rows [nseg, L] (caller-zeroed)."""
    lib = get_lib()
    destuffed = np.ascontiguousarray(destuffed, np.uint8)
    bitoffs = np.ascontiguousarray(bitoffs, np.int64)
    nseg, L = out_rows.shape
    rc = lib.jz_copy_bit_windows(
        _u8p(destuffed), len(destuffed),
        bitoffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), nseg,
        _u8p(out_rows), L)
    if rc < 0:
        raise ValueError(f"window {-rc - 1} overflowed the row stride {L}")
    return int(rc)


def fdct_quant(pic: np.ndarray, c1: np.ndarray, c2: np.ndarray,
               cu8: np.ndarray, qt: np.ndarray,
               nthreads: int = 0) -> np.ndarray:
    """[B, 64] int8 spatial blocks -> [B, 64] int32 quantized coefficients,
    the oracle's exact float64 term order (bit-identical; see
    codec/host_codec.py)."""
    lib = get_lib()
    pic = np.ascontiguousarray(pic, np.int8)
    B = pic.shape[0]
    out = np.empty((B, 64), np.int32)
    PD = ctypes.POINTER(ctypes.c_double)
    lib.jz_fdct_quant(
        pic.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), B,
        np.ascontiguousarray(c1).ctypes.data_as(PD),
        np.ascontiguousarray(c2).ctypes.data_as(PD),
        np.ascontiguousarray(cu8).ctypes.data_as(PD),
        _i32p(np.ascontiguousarray(qt, np.int32)), _i32p(out), nthreads)
    return out


def idct_dequant(coeffs: np.ndarray, qt: np.ndarray, cucv: np.ndarray,
                 c1: np.ndarray, c2: np.ndarray, level: int,
                 nthreads: int = 0) -> np.ndarray:
    """[B, 64] int16 coefficients -> [B, 64] int32 spatial (+level),
    the oracle's exact float64 term order."""
    lib = get_lib()
    coeffs = np.ascontiguousarray(coeffs, np.int16)
    B = coeffs.shape[0]
    out = np.empty((B, 64), np.int32)
    PD = ctypes.POINTER(ctypes.c_double)
    lib.jz_idct_dequant(
        coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), B,
        _i32p(np.ascontiguousarray(qt, np.int32)),
        np.ascontiguousarray(cucv).ctypes.data_as(PD),
        np.ascontiguousarray(c1).ctypes.data_as(PD),
        np.ascontiguousarray(c2).ctypes.data_as(PD),
        level, _i32p(out), nthreads)
    return out


def entropy_encode(yq: np.ndarray, cbq: np.ndarray, crq: np.ndarray,
                   restart_interval: int,
                   ydc: np.ndarray, yac: np.ndarray,
                   cdc: np.ndarray, cac: np.ndarray) -> bytes:
    """Serial Huffman encode -> stuffed entropy bytes incl. RSTn markers.

    Tables: packed ``(code << 8) | size`` uint32 keyed by DC category /
    AC symbol byte (see codec/host_codec._packed_tables)."""
    from ..core import tables as T

    lib = get_lib()
    nmcu = cbq.shape[0]
    yq = np.ascontiguousarray(yq, np.int32)
    cbq = np.ascontiguousarray(cbq, np.int32)
    crq = np.ascontiguousarray(crq, np.int32)
    zz = np.ascontiguousarray(T.ZIGZAG, np.int32)
    PU = ctypes.POINTER(ctypes.c_uint32)
    cap = nmcu * 6 * 64 * 4 + 4096  # worst case ~2 bytes/coeff + margin
    out = np.empty(cap, np.uint8)
    n = lib.jz_entropy_encode(
        _i32p(yq), _i32p(cbq), _i32p(crq), nmcu, restart_interval,
        _i32p(zz),
        np.ascontiguousarray(ydc, np.uint32).ctypes.data_as(PU),
        np.ascontiguousarray(yac, np.uint32).ctypes.data_as(PU),
        np.ascontiguousarray(cdc, np.uint32).ctypes.data_as(PU),
        np.ascontiguousarray(cac, np.uint32).ctypes.data_as(PU),
        _u8p(out), cap, None)
    if n < 0:
        raise RuntimeError("entropy encode overflowed its output budget")
    return out[:n].tobytes()


def entropy_histograms(yq: np.ndarray, cbq: np.ndarray, crq: np.ndarray,
                       restart_interval: int) -> np.ndarray:
    """Pass-1 symbol counts [4, 256] (Y-DC, Y-AC, C-DC, C-AC) for the
    -optimize table derivation."""
    from ..core import tables as T

    lib = get_lib()
    nmcu = cbq.shape[0]
    yq = np.ascontiguousarray(yq, np.int32)
    cbq = np.ascontiguousarray(cbq, np.int32)
    crq = np.ascontiguousarray(crq, np.int32)
    zz = np.ascontiguousarray(T.ZIGZAG, np.int32)
    hist = np.zeros(4 * 256, np.uint32)
    PU = ctypes.POINTER(ctypes.c_uint32)
    rc = lib.jz_entropy_encode(
        _i32p(yq), _i32p(cbq), _i32p(crq), nmcu, restart_interval,
        _i32p(zz), None, None, None, None, None, 0,
        hist.ctypes.data_as(PU))
    assert rc == 0
    return hist.reshape(4, 256)


def entropy_decode(pj, n_mcus: int) -> list[np.ndarray]:
    """Serial Huffman decode of a parsed JPEG -> per-component [B, 64] blocks.

    pj: jpezy_tpu.bitstream.reader.ParsedJpeg
    """
    from ..core import tables as T

    lib = get_lib()
    ncomp = len(pj.scan_components)
    dc_luts = [_huff_lut(pj.huff[0][sc.Td]) for sc in pj.scan_components]
    ac_luts = [_huff_lut(pj.huff[1][sc.Ta]) for sc in pj.scan_components]

    comp_h = np.array([fc.H for fc in pj.frame_components], dtype=np.int32)
    comp_v = np.array([fc.V for fc in pj.frame_components], dtype=np.int32)
    outs = [
        np.zeros((n_mcus * int(comp_h[i] * comp_v[i]), 64), dtype=np.int16)
        for i in range(ncomp)
    ]

    P = ctypes.POINTER(ctypes.c_int32)
    P16 = ctypes.POINTER(ctypes.c_int16)
    dc_arr = (P * ncomp)(*[_i32p(a) for a in dc_luts])
    ac_arr = (P * ncomp)(*[_i32p(a) for a in ac_luts])
    out_arr = (P16 * ncomp)(
        *[a.ctypes.data_as(P16) for a in outs]
    )

    data = np.frombuffer(pj.data, dtype=np.uint8)[pj.entropy_start :]
    data = np.ascontiguousarray(data)
    zz = np.ascontiguousarray(T.ZIGZAG, dtype=np.int32)

    ri = pj.restart_interval
    if ri > 0:
        # thread-parallel decode over restart segments
        max_seg = n_mcus // ri + 2
        marks = np.zeros(max_seg, dtype=np.int64)
        nmarks = lib.jz_find_restarts(
            _u8p(data), len(data),
            marks.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_seg,
        )
        seg_offsets = np.zeros(nmarks + 1, dtype=np.int64)
        seg_offsets[1:] = marks[:nmarks]
        rc = lib.jz_entropy_decode_mt(
            _u8p(data), len(data),
            seg_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(seg_offsets),
            dc_arr, ac_arr, _i32p(zz),
            ncomp, _i32p(comp_h), _i32p(comp_v),
            n_mcus, ri, out_arr,
            # thread-spawn overhead ~ a few hundred us: only fan out wide
            # when there is real work
            0 if n_mcus >= 8192 else (4 if n_mcus >= 2048 else 1),
        )
    else:
        # restart-free fast path: destuff once (memcpy-speed), then the
        # branchless-refill decoder.  +8 ZERO pad bytes: the reader's
        # refill reads past the end unconditionally (zero-fill-at-EOF
        # semantics, same as the general decoder).
        destuffed = np.zeros(len(data) + 8, dtype=np.uint8)
        consumed = ctypes.c_long(0)
        nd = lib.jz_destuff(
            _u8p(data), len(data), _u8p(destuffed), ctypes.byref(consumed))
        rc = lib.jz_entropy_decode_fast(
            _u8p(destuffed), int(nd), dc_arr, ac_arr, _i32p(zz),
            ncomp, _i32p(comp_h), _i32p(comp_v),
            n_mcus, out_arr,
        )
    if rc != n_mcus:
        raise RuntimeError(f"native entropy decode failed: rc={rc}")
    return outs
