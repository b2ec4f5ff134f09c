"""Pure-host C++ codec path: no accelerator, no XLA, no jax import.

Why this exists: a one-shot CLI run on a small image must beat the
reference's end-to-end numbers (0.567 s encode / 0.055 s decode for lena,
/root/reference/README.md:56,76), and any accelerator path pays backend
initialization + compilation that dwarfs the compute at that scale
(VERDICT r4: 90x70 encode took ~6-16 s through the XLA CPU backend, while
the numpy oracle produced the byte-identical stream in 16 ms).  This module
is the production small-image path: the hot loops (DCT/IDCT, quantize,
serial Huffman encode/decode) run in the C++ runtime (csrc/jpezy_host.cpp)
with the numpy oracle's exact float64 semantics, so its streams are
byte-identical to `oracle.encode` / the jax `precision="exact"` path, and
its decodes bit-identical to `oracle.decode`.

Referents: encoder pipeline jpezy_encoder.hpp:38-242, decoder pipeline
jpezy_decoder.hpp:76-134,583-670.  Layering: this is the L3 codec core on
the host axis; the CLI (L4) auto-picks it below a size threshold
(cli._pick_backend) and the TPU transports above it.
"""
from __future__ import annotations

import contextlib

import numpy as np

from ..core import tables as T
from ..core.geometry import ComponentGeometry, EncodeGeometry
from ..core.props import ImageProps, make_encode_props
from ..bitstream import writer
from ..bitstream.reader import parse
from . import oracle

_CU8 = np.where(np.arange(8) == 0, 1.0 / np.sqrt(2.0), 1.0)


def _packed_dc(size_tb, code_tb) -> np.ndarray:
    """DC table -> [16] uint32 packed (code << 8) | size, keyed by category."""
    out = np.zeros(16, np.uint32)
    n = len(size_tb)
    out[:n] = ((np.asarray(code_tb, np.uint32) << 8)
               | np.asarray(size_tb, np.uint32))
    return out


def _packed_ac(size_tb, code_tb) -> np.ndarray:
    """AC flat table (162 entries keyed by ac_symbol_index) -> [256] uint32
    packed (code << 8) | size keyed by the T.81 symbol byte run<<4 | s."""
    out = np.zeros(256, np.uint32)
    for run in range(16):
        for s in range(11):
            if s == 0 and run not in (0, 15):
                continue  # only EOB (0,0) and ZRL (15,0) have s == 0
            idx = run * 10 + s + (1 if run == 15 else 0)
            out[(run << 4) | s] = (int(code_tb[idx]) << 8) | int(size_tb[idx])
    return out


_DEFAULT_PACKED = None


def _default_packed():
    global _DEFAULT_PACKED
    if _DEFAULT_PACKED is None:
        _DEFAULT_PACKED = (
            _packed_dc(T.Y_DC_SIZE, T.Y_DC_CODE),
            _packed_ac(T.Y_AC_SIZE, T.Y_AC_CODE),
            _packed_dc(T.C_DC_SIZE, T.C_DC_CODE),
            _packed_ac(T.C_AC_SIZE, T.C_AC_CODE),
        )
    return _DEFAULT_PACKED


def encode(r: np.ndarray, g: np.ndarray, b: np.ndarray,
           props: ImageProps | None = None, *, gray: bool = False,
           quality: int | None = None, restart_interval: int = 0,
           optimize: bool = False) -> bytes:
    """RGB planes [H, W] uint8 -> baseline JFIF bytes, entirely on host.

    Byte-identical to oracle.encode (same extensions as jax_codec.encode:
    quality / restart_interval / optimize / gray).  Raises
    runtime.native.NativeUnavailable when the C++ runtime cannot build.
    """
    from ..runtime import native

    native.get_lib()
    h, w = r.shape
    if restart_interval < 0:
        raise ValueError(
            f"restart_interval must be >= 0, got {restart_interval}")
    geo = EncodeGeometry(width=w, height=h)
    ph, pw = geo.padded_height, geo.padded_width
    stacked = np.stack([np.asarray(r), np.asarray(g), np.asarray(b)],
                       axis=-1).astype(np.uint8)
    if (h, w) != (ph, pw):
        # edge-replicate on RGB: pointwise color conversion commutes with
        # the pad, so streams match the pad-after-convert oracle exactly
        stacked = np.pad(
            stacked, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    y, cb, cr = native.rgb_to_ycc420(stacked[None])
    yb = oracle.blockify_luma(y[0])
    cbb = oracle.blockify_chroma(cb[0])
    crb = oracle.blockify_chroma(cr[0])
    if gray:
        cbb = np.zeros_like(cbb)
        crb = np.zeros_like(crb)

    yqt, cqt = (T.scale_quant_tables(quality) if quality is not None
                else (T.Y_QUANT, T.C_QUANT))
    yq = native.fdct_quant(yb, oracle._FWD_C1, oracle._FWD_C2, _CU8, yqt)
    cbq = native.fdct_quant(cbb, oracle._FWD_C1, oracle._FWD_C2, _CU8, cqt)
    crq = native.fdct_quant(crb, oracle._FWD_C1, oracle._FWD_C2, _CU8, cqt)

    ri = restart_interval
    huff_blobs = None
    if optimize:
        hist = native.entropy_histograms(yq, cbq, crq, ri)
        ydc_bv, yac_bv, ydc_s, ydc_c, yac_s, yac_c = T.optimal_flat_tables(
            hist[0], hist[1])
        cdc_bv, cac_bv, cdc_s, cdc_c, cac_s, cac_c = T.optimal_flat_tables(
            hist[2], hist[3])
        huff_blobs = (ydc_bv, cdc_bv, yac_bv, cac_bv)
        packed = (_packed_dc(ydc_s, ydc_c), _packed_ac(yac_s, yac_c),
                  _packed_dc(cdc_s, cdc_c), _packed_ac(cac_s, cac_c))
    else:
        packed = _default_packed()
    body = native.entropy_encode(yq, cbq, crq, ri, *packed)

    if props is None:
        props = make_encode_props(w, h, gray=gray)
    header = writer.write_header(
        props, restart_interval=ri,
        quant_tables=(yqt, cqt) if quality is not None else None,
        huff_tables=huff_blobs)
    return header + body + writer.EOI


def decode(data: bytes, *, gray: bool = False, verbose: bool = False
           ) -> tuple[np.ndarray, np.ndarray, np.ndarray, ImageProps]:
    """Baseline JPEG bytes -> (r, g, b [H, W] uint8, props), entirely on
    host.  Bit-identical to oracle.decode (the reference's double-precision
    semantics); C++ entropy frontend + C++ exact IDCT."""
    from ..bitstream.reader import check_decodable
    from ..runtime import native
    from ..utils.timing import SectionTimer

    native.get_lib()
    phase = (lambda msg: SectionTimer(msg, indent="\t")) if verbose \
        else (lambda msg: contextlib.nullcontext())

    with phase("analyzing header..."):
        pj = parse(data)
        check_decodable(pj)
    props = pj.props
    geos = [
        ComponentGeometry(fc.H, fc.V, pj.hmax, pj.vmax,
                          props.width, props.height)
        for fc in pj.frame_components
    ]
    mcus_x, mcus_y = geos[0].mcus_x, geos[0].mcus_y
    level = 128 if props.sample_precision == 8 else 2048

    with phase("decoding huffman (entropy frontend)..."):
        blocks = native.entropy_decode(pj, mcus_x * mcus_y)
    with phase("dequant + inverse DCT + color (host C++)..."):
        planes = []
        for i, fc in enumerate(pj.frame_components):
            spat = native.idct_dequant(
                blocks[i], pj.quant[fc.Tq], oracle._INV_CUCV,
                oracle._INV_C1, oracle._INV_C2, level)
            plane = oracle.deblockify(spat, mcus_y, mcus_x, fc.V, fc.H)
            plane = plane.repeat(geos[i].dup_y, axis=0).repeat(
                geos[i].dup_x, axis=1)
            planes.append(plane)

        H, W = props.height, props.width
        ymat = planes[0][:H, :W]
        ncomp = len(pj.frame_components)
        if gray or ncomp == 1:
            gval = np.clip(np.trunc(ymat.astype(np.float64)), 0,
                           255).astype(np.uint8)
            return gval, gval.copy(), gval.copy(), props
        # C++ color tail: bit-identical to oracle.ycc_to_rgb and ~10x
        # faster (the numpy float64 tail was 0.64 s of a 0.75 s 1 MP CLI
        # decode)
        rgb = native.ycc_to_rgb_i32(
            np.ascontiguousarray(ymat),
            np.ascontiguousarray(planes[1][:H, :W]),
            np.ascontiguousarray(planes[2][:H, :W]))
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return r, g, b, props
