"""Batched encode and decode over uniform image batches, and the
single-image entry points (torch).

Counterpart of jpezy_tpu.codec.jax_codec:

Encode, `ycc420` transport (the default): host C++ RGB -> YCC 4:2:0 int8
planes (float64, the reference's exact truncation) -> ONE packed int8
upload -> the CUDA fDCT+quantize kernel (blockify, float32 DCT, quantize,
one launch for the three components, ops/block_transform.py), the CUDA
entropy kernel (DC predictors, Huffman emissions and bit packing, one
launch for the three components), the CUDA stream concat (one launch, the
blocks read where the entropy kernel wrote them) -> ONE fetch of
`combined` [N, 1 + maxw] ->
host header + byte stuffing.
`rgb` transport: ONE [N, H, W, 3] u8 upload, the CUDA colour kernel
(colour conversion and 4:2:0 decimation into int8 planes, float32 in fast
mode, float64 in exact mode), then the same program.
Exact mode takes the exact fDCT+quantize kernel in place of the fast one
(the oracle's ordered float64 sums, ops/exact_cuda.py) on either
transport.
optimize=True (two passes, per-image optimal Huffman tables): the
quantized blocks stay on the device, the CUDA histogram kernel counts each
image's symbols (one launch for the three components), ONE [N, 4, 256]
fetch, the host derives two table pairs per image (T.81 K.2), ONE upload
of the table sets, and the entropy kernel codes every image with its own
set in one launch; each stream carries its own DHT.

Decode: marker parse (every stream must be decodable), then one of four
transports.  `ycc420`: host C++ Huffman frontend + sparsify -> ONE uint8
upload -> the CUDA IDCT-to-planes kernel, which reads the upload in place
(densify, dequantize, float32 IDCT, deblockify, clamp to u8 planes) ->
ONE fetch -> C++ upsample + colour.  `device` (restart streams): host
destuff of the segments -> upload of the raw entropy words -> the CUDA
Huffman scan, one lane per segment (ops/entropy_decode.py) -> the same
IDCT kernel on the scan's blocks (per-image dequantize, IDCT, planes plus
one corruption flag per image) -> ONE fetch.  `indexed` gives restart-free streams the same device decode
after a length-only host scan.  `rgb`, for any frame: host Huffman
frontend -> ONE upload of the coefficients -> the CUDA IDCT kernel
(dequantize, IDCT, deblockify into unclamped int32 planes: float32, or
exact mode's float64 ordered sums, one launch), then the CUDA colour
kernel (upsample by the sampling factors, colour or gray clamp, one
launch) -> ONE fetch of RGB.

precision:
  "fast"  - float32 transforms at IEEE precision (TF32 refused); on the
            card the fDCT and the ycc420/device IDCT sum in the kernels'
            fixed ascending order, so card and CPU may differ by 1 at
            truncation ties
  "exact" - float64 ordered sums, byte-identical to the oracle (encode)
            and pixel-identical to the JAX package (decode, rgb)
"""
from __future__ import annotations

import numpy as np
import torch

from ..bitstream import writer
from ..bitstream.reader import check_decodable, parse
from ..bitstream.splice import splice_blocks
from ..constants import codec_constants
from ..core import tables as T
from ..core.geometry import ComponentGeometry, EncodeGeometry
from ..core.props import ImageProps, make_encode_props
from ..device import resolve
from ..ops import block_transform as BT
from ..ops import colorspace as C
from ..ops import entropy as E
from ..ops import entropy_decode as ED
from . import host_glue as HG

def _dtype(precision: str):
    if precision == "exact":
        return torch.float64
    if precision == "fast":
        return torch.float32
    raise ValueError(f"precision must be 'fast' or 'exact', got {precision!r}")


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------


def _quantize_local_ycc(y, cb, cr, *, gray: bool, dtype, rounded: bool,
                        qtables=None):
    """YCC planes -> per-component quantized blocks [N, B, 64] int32
    (parallel/sharded.py:_quantize_local_ycc).

    y: [N, H, W] int (Y-128); cb/cr: [N, H/2, W/2] int.  qtables: optional
    (yqt, cqt) quant tables; None = the fixed Annex K tables.  float32:
    BT.fdct_quantize; float64: BT.fdct_quantize_exact, the oracle's
    ordered sums; each the hand-written kernel on CUDA tensors."""
    if dtype == torch.float32:
        return BT.fdct_quantize(y, cb, cr, gray=gray, rounded=rounded,
                                qtables=qtables)
    return BT.fdct_quantize_exact(y, cb, cr, gray=gray, rounded=rounded,
                                  qtables=qtables)


def _emit_local(yq, cbq, crq, restart_interval: int = 0,
                tables=(None, None), carry=None):
    """Quantized blocks -> per-component (words, bits), component order
    (jpezy_tpu/parallel/sharded.py:_emit_local with interleave=False, the
    carry given in place of its ppermute): E.encode_blocks_batch, one
    entropy kernel launch for the three components on CUDA tensors, the
    per-image DC predictor chains found in the kernel.
    restart_interval > 0 resets each component's predictor chain every
    that many MCUs (4 blocks of Y, 1 of Cb and of Cr per MCU).
    tables: (luma, chroma) Huffman tables in the JAX order, each None (the
    fixed tables) or one set, or one set per image with a leading [N]
    axis; on CUDA tensors also the kernel's rows (E.kernel_tables).
    carry: [N, 3] first DC predictor of each image's Y, Cb and Cr chain (a
    tile shard's carry-in, jpezy_tpu_torch/parallel/sharded.py); None for
    0, a whole image."""
    return E.encode_blocks_batch(yq, cbq, crq, restart_interval, carry,
                                 tables)


def stream_budget_words_batch(nblocks: int) -> int:
    """Batched-path stream budget: 2 words/block = 1 bit/pixel equivalent
    (jax_codec.stream_budget_words_batch).  Overflowing images fall back
    to a per-image host splice in encode_batch_finish."""
    return max(4096, nblocks * 2)


def _concat_batch_combined_comp(wc, bc, restart_interval: int = 0,
                                maxw: int | None = None):
    """Batched stream concat from PER-COMPONENT packed words
    (jax_codec._concat_batch_combined_comp; with the caller's maxw, also
    the per-shard concat of jpezy_tpu/parallel/sharded.py, i.e. the JAX
    concat_device_batch and concat_device_restart_batch).

    wc, bc: per component (Y, Cb, Cr) the words [N, B_c, 64] and bits
    [N, B_c] of _emit_local.  Returns (combined [N, 1 + S + maxw] int64:
    column 0 = total bits, then with restart_interval the S per-segment
    bit counts (each segment starts byte-aligned in the stream), then the
    stream; wc; bc): E.concat_streams, the hand-written kernel on CUDA
    tensors.  The JAX function returns the words concatenated in
    component order and the bits in MCU order; here they stay per
    component, and only an image that overflows has its rows put in MCU
    order, on the host (_image_words_bits).  maxw: the stream's words,
    None for stream_budget_words_batch; writes past it are dropped and
    the caller checks total <= 32 * maxw."""
    if maxw is None:
        maxw = stream_budget_words_batch(bc[1].shape[1] * 6)
    return E.concat_streams(wc, bc, restart_interval, maxw), wc, bc


def _image_words_bits(wc, bc, i: int):
    """Image i's packed words [nm*6, 64] uint32 and bits [nm*6] int32 in
    MCU order, on the host, from the per-component tuples of
    _concat_batch_combined_comp: what a host splice of that image takes."""
    nm = bc[1].shape[1]
    words = np.concatenate([w[i].cpu().numpy() for w in wc]).astype(
        np.uint32)
    bits = np.concatenate([b[i].cpu().numpy() for b in bc]).astype(np.int32)
    return (HG._words_comp_to_mcu(words, nm),
            HG._words_comp_to_mcu(bits[:, None], nm)[:, 0])


def _qtables(quality: int | None, dev):
    """(luma, chroma) quant tables on dev; None = the fixed Annex K."""
    if quality is None:
        return None
    c = codec_constants(dev, quality)
    return (c["y_quant"], c["c_quant"])


def _unpack_ycc(packed: torch.Tensor, h: int, w: int):
    """packed [N, H*W + 2*(H/2)*(W/2)] int8 -> (y, cb, cr) planes."""
    N = packed.shape[0]
    ny, nc = h * w, (h // 2) * (w // 2)
    return (packed[:, :ny].reshape(N, h, w),
            packed[:, ny:ny + nc].reshape(N, h // 2, w // 2),
            packed[:, ny + nc:].reshape(N, h // 2, w // 2))


def _encode_batch_blocks_packed(packed: torch.Tensor, *, h: int, w: int,
                                gray: bool = False, precision: str = "fast",
                                rounded: bool = False,
                                quality: int | None = None,
                                restart_interval: int = 0):
    """Device program of the ycc420 transport: packed [N, H*W +
    2*(H/2)*(W/2)] int8 holds Y then Cb then Cr per image
    (jax_codec._encode_batch_blocks_packed)."""
    yq, cbq, crq = _quantize_batch_ycc(packed, h=h, w=w, gray=gray,
                                       precision=precision, rounded=rounded,
                                       quality=quality)
    wc, bc = _emit_local(yq, cbq, crq, restart_interval)
    return _concat_batch_combined_comp(wc, bc, restart_interval)


def _quantize_batch_rgb(rgb: torch.Tensor, *, gray: bool = False,
                        precision: str = "fast", rounded: bool = False,
                        quality: int | None = None):
    """rgb [N, H, W, 3] uint8 on the device -> per-component quantized
    blocks [N, B, 64] (jax_codec._encode_batch_blocks up to the entropy
    coding, via parallel/sharded.py:_encode_local): colour conversion at
    the precision's dtype and 4:2:0 decimation into int8 planes
    (C.rgb_to_ycc420, the hand-written kernel on a CUDA tensor), then the
    fDCT and quantize of the ycc420 transport."""
    dt = _dtype(precision)
    y, cb, cr = C.rgb_to_ycc420(rgb, dt)
    return _quantize_local_ycc(y, cb, cr, gray=gray, dtype=dt,
                               rounded=rounded,
                               qtables=_qtables(quality, rgb.device))


def _encode_batch_blocks(rgb: torch.Tensor, *, gray: bool = False,
                         precision: str = "fast", rounded: bool = False,
                         quality: int | None = None,
                         restart_interval: int = 0):
    """Device program of the rgb transport (jax_codec._encode_batch_blocks):
    rgb [N, H, W, 3] uint8 -> (combined, words, bits) of
    _concat_batch_combined_comp, as _encode_batch_blocks_packed returns
    them."""
    yq, cbq, crq = _quantize_batch_rgb(rgb, gray=gray, precision=precision,
                                       rounded=rounded, quality=quality)
    wc, bc = _emit_local(yq, cbq, crq, restart_interval)
    return _concat_batch_combined_comp(wc, bc, restart_interval)


def _quantize_batch_ycc(packed: torch.Tensor, *, h: int, w: int,
                        gray: bool = False, precision: str = "fast",
                        rounded: bool = False, quality: int | None = None):
    """ycc420 upload -> per-component quantized blocks [N, B, 64]
    (jax_codec._quantize_batch_ycc)."""
    return _quantize_local_ycc(
        *_unpack_ycc(packed, h, w), gray=gray, dtype=_dtype(precision),
        rounded=rounded, qtables=_qtables(quality, packed.device))


def _symbol_histograms_batch(yq, cbq, crq, *, restart_interval: int = 0,
                             carry=None):
    """Per-image Huffman symbol counts [N, 4, 256] int32: Y-DC, Y-AC, C-DC,
    C-AC, chroma summed over Cb and Cr (jax_codec._symbol_histograms_batch):
    E.symbol_histograms_batch, one histogram kernel for the three
    components on CUDA tensors.  carry: as in _emit_local."""
    return E.symbol_histograms_batch(yq, cbq, crq, restart_interval, carry)


def _encode_batch_custom(yq, cbq, crq, ytables, ctables, *,
                         restart_interval: int = 0):
    """Entropy-code a batch with PER-IMAGE Huffman tables
    (jax_codec._encode_batch_custom): ytables/ctables are (dc_size,
    dc_code, ac_size, ac_code) with a leading [N] axis, on the host.  One
    entropy kernel launch codes every image with its own set; the
    stream matches the JAX package's; returns what
    _encode_batch_blocks_packed returns."""
    if yq.is_cuda:  # the kernel's rows, laid out on the host: one upload each
        ytables, ctables = (E.kernel_tables(t, yq.device)
                            for t in (ytables, ctables))
    wc, bc = _emit_local(yq, cbq, crq, restart_interval,
                         tables=(ytables, ctables))
    return _concat_batch_combined_comp(wc, bc, restart_interval)


def _optimal_tables(hists: np.ndarray):
    """Host half of optimize: [N, 4, 256] counts -> per image the DHT
    (bits, vals) blobs, and the per-image flat tables of luma and chroma
    (JAX order, numpy with a leading [N] axis)."""
    huffs, flats = [], []
    for i in range(hists.shape[0]):
        ydc_bv, yac_bv, *yflat = T.optimal_flat_tables(hists[i, 0],
                                                       hists[i, 1])
        cdc_bv, cac_bv, *cflat = T.optimal_flat_tables(hists[i, 2],
                                                       hists[i, 3])
        huffs.append((ydc_bv, cdc_bv, yac_bv, cac_bv))
        flats.append((yflat, cflat))
    ytables, ctables = (tuple(np.stack([f[g][k] for f in flats])
                              for k in range(4)) for g in range(2))
    return huffs, ytables, ctables


def encode_batch_dispatch(rgbs: np.ndarray, *, gray: bool = False,
                          precision: str = "fast", rounded: bool = False,
                          transport: str | None = None,
                          quality: int | None = None,
                          restart_interval: int = 0,
                          optimize: bool = False,
                          device: str | torch.device = "cuda",
                          _size: tuple[int, int] | None = None,
                          _props: ImageProps | None = None):
    """Colour conversion, one upload and the device program for a uniform
    batch [N, H, W, 3] uint8 (H, W multiples of 16).

    transport: "ycc420" (default) converts colour on the host (C++,
    float64) and uploads int8 planes, half the bytes of "rgb", which
    uploads the RGB samples and converts on the device (float32 in fast
    mode; exact mode gives identical streams).  optimize derives per-image
    optimal Huffman tables: it waits for one [N, 4, 256] histogram fetch
    and runs the table derivation on the host, on the ycc420 transport
    (transport="rgb" with optimize raises ValueError).  _size (width,
    height) and _props carry an image's true size and properties into the
    header when encode() padded it to the MCU grid.

    Returns a ticket for encode_batch_finish.  CUDA work is queued on the
    current stream; nothing here waits for it, except optimize's fetch."""
    dev = resolve(device)
    n, h, w = rgbs.shape[:3]
    if h % 16 or w % 16:
        raise ValueError("encode_batch needs multiple-of-16 dims")
    if restart_interval < 0:
        raise ValueError(
            f"restart_interval must be >= 0, got {restart_interval}")
    if transport not in (None, "ycc420", "rgb"):
        raise ValueError(f"unknown encode transport {transport!r}")
    if optimize and transport == "rgb":
        raise ValueError("optimize=True runs on the ycc420 transport; "
                         "transport='rgb' with optimize is not supported")
    _dtype(precision)
    if quality is not None:
        T.scale_quant_tables(quality)  # validate before any device work
    ri = restart_interval
    ticket = dict(n=n, h=h, w=w, gray=gray, quality=quality, ri=ri,
                  huff=None, size=_size, props=_props)
    if transport == "rgb":
        combined, words, bits = _encode_batch_blocks(
            torch.from_numpy(np.ascontiguousarray(rgbs, np.uint8)).to(dev),
            gray=gray, precision=precision, rounded=rounded, quality=quality,
            restart_interval=ri)
        return dict(ticket, combined=combined, words=words, bits=bits)
    y, cb, cr = HG.host_rgb_to_ycc420(rgbs)
    packed = torch.from_numpy(np.concatenate(
        [y.reshape(n, -1), cb.reshape(n, -1), cr.reshape(n, -1)],
        axis=1)).to(dev)
    if not optimize:
        combined, words, bits = _encode_batch_blocks_packed(
            packed, h=h, w=w, gray=gray, precision=precision,
            rounded=rounded, quality=quality, restart_interval=ri)
        return dict(ticket, combined=combined, words=words, bits=bits)
    yq, cbq, crq = _quantize_batch_ycc(packed, h=h, w=w, gray=gray,
                                       precision=precision, rounded=rounded,
                                       quality=quality)
    hists = _symbol_histograms_batch(yq, cbq, crq,
                                     restart_interval=ri).cpu().numpy()
    huffs, ytables, ctables = _optimal_tables(hists)
    combined, words, bits = _encode_batch_custom(
        yq, cbq, crq, ytables, ctables, restart_interval=ri)
    return dict(ticket, combined=combined, words=words, bits=bits,
                huff=huffs)


def encode_batch_finish(ticket) -> list[bytes]:
    """Fetch `combined` once and assemble the JFIF streams on the host
    (with optimize, each with its own DHT)."""
    combined = ticket["combined"].cpu().numpy().astype(np.uint32)
    n, h, w = ticket["n"], ticket["h"], ticket["w"]
    quality, ri, huff = ticket["quality"], ticket["ri"], ticket["huff"]
    geo = EncodeGeometry(width=w, height=h)
    S = -(-geo.num_mcus // ri) if ri else 0
    maxw = combined.shape[1] - 1 - S
    qt = T.scale_quant_tables(quality) if quality is not None else None
    # headers carry the TRUE dims when encode() padded to the MCU grid;
    # the grid is unchanged by the pad, so only the SOF0 W/H differ
    tw, th = ticket["size"] or (w, h)
    props = ticket["props"] or make_encode_props(tw, th, gray=ticket["gray"])
    header = writer.write_header(props, restart_interval=ri, quant_tables=qt)

    def overflowed(i):
        """Image i's words and bits in MCU order, fetched only when its
        stream outgrew the budget (host splice of this image only)."""
        return _image_words_bits(ticket["words"], ticket["bits"], i)

    out = []
    for i in range(n):
        if huff is not None:  # per-image optimal tables
            header = writer.write_header(props, restart_interval=ri,
                                         quant_tables=qt, huff_tables=huff[i])
        total = int(combined[i, 0])
        if ri:
            seg_bits = combined[i, 1:1 + S]
            if total <= 32 * maxw:
                raw = combined[i, 1 + S:].astype(">u4").tobytes()
            else:
                raw = HG._splice_restart_raw(*overflowed(i), S, ri, seg_bits)
            out.append(header + HG._assemble_restart_segments(raw, seg_bits)
                       + writer.EOI)
            continue
        if total <= 32 * maxw:
            packed = HG._stream_to_bytes(combined[i, 1:], total)
        else:
            packed, _ = splice_blocks(*overflowed(i))
        out.append(writer.assemble(header, packed))
    return out


def encode_batch(rgbs: np.ndarray, *, gray: bool = False,
                 precision: str = "fast", rounded: bool = False,
                 transport: str | None = None, quality: int | None = None,
                 restart_interval: int = 0, optimize: bool = False,
                 device: str | torch.device = "cuda") -> list[bytes]:
    """Encode a uniform batch [N, H, W, 3] uint8 -> list of JFIF streams."""
    return encode_batch_finish(encode_batch_dispatch(
        rgbs, gray=gray, precision=precision, rounded=rounded,
        transport=transport, quality=quality,
        restart_interval=restart_interval, optimize=optimize, device=device))


def encode(r: np.ndarray, g: np.ndarray, b: np.ndarray,
           props: ImageProps | None = None, *, gray: bool = False,
           precision: str = "fast", rounded: bool = False,
           quality: int | None = None, restart_interval: int = 0,
           optimize: bool = False,
           device: str | torch.device = "cuda") -> bytes:
    """Full encode: RGB planes [H, W] uint8 -> baseline JFIF bytes
    (jax_codec.encode).

    Runs the batch path at N=1 on the ycc420 transport: the planes are
    edge-replicated to the MCU grid on the host (padding commutes with the
    pointwise colour conversion, so streams are those of the reference),
    and the header carries the true size.  quality, restart_interval and
    optimize are the extensions of encode_batch."""
    h, w = r.shape
    geo = EncodeGeometry(width=w, height=h)
    stacked = np.stack([np.asarray(r), np.asarray(g), np.asarray(b)])
    ph_, pw_ = geo.padded_height, geo.padded_width
    if (h, w) != (ph_, pw_):
        stacked = np.pad(
            stacked, ((0, 0), (0, ph_ - h), (0, pw_ - w)), mode="edge")
    ticket = encode_batch_dispatch(
        np.moveaxis(stacked, 0, -1)[None], gray=gray, precision=precision,
        rounded=rounded, quality=quality, restart_interval=restart_interval,
        optimize=optimize, device=device, _props=props,
        _size=None if (h, w) == (ph_, pw_) else (w, h))
    return encode_batch_finish(ticket)[0]


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _decode_fused_batch_ycc420(flat: torch.Tensor, *, geom, level, shapes,
                               K, N, caps, qtuple):
    """Sparse coefficients in, packed native-resolution u8 YCC planes out
    (jax_codec._decode_fused_batch_ycc420, same flat layout):
    BT.idct_planes_sparse, the hand-written kernel on a CUDA buffer.

    flat: ONE uint8 buffer.  First N*X bytes are per-image rows holding,
    per component, mask_lo [N,B] u32 | mask_hi [N,B] u32 | vals [N,B,K]
    int8; then, per component, the overflow data oidx [cap] i32 | orows
    [cap, 64] i16, padded with the out-of-range sentinel N*B_i.  Returns
    [N, H*W*1.5] uint8 for 4:2:0.
    """
    return BT.idct_planes_sparse(flat, geom=geom, level=level, shapes=shapes,
                                 K=K, N=N, caps=caps, qtuple=qtuple)


def _decode_fused_batch_device(words, nblk, lut, tsel, rawlen, qarr,
                               skip0=None, preds0=None, *, N, nseg, ri,
                               geom, level):
    """FULL device decode of restart-interval 4:2:0 streams: destuffed
    entropy bytes in, packed native-resolution u8 YCC planes out
    (jax_codec._decode_fused_batch_device).

    The Huffman frontend runs on the device (ops.entropy_decode
    .decode_segments: one lane per segment), so the upload is the raw
    entropy bytes instead of sparse coefficients.
    words: [N*nseg, Lw] int32 bit patterns of the BE segment words; nblk:
    [N*nseg] int32; lut: [T, 6, 65536] with tsel [N*nseg] selecting each
    lane's table set (per-image DHT tables); rawlen: [N*nseg] destuffed
    byte lengths feeding the corruption check (None on the indexed
    transport); qarr: [N, 3, 64] int32 PER-IMAGE quant tables; skip0,
    preds0: the indexed transport's start phase and DC predictors.
    Output layout = _decode_fused_batch_ycc420 plus ONE trailing bad-flag
    byte per image (still a single fetch): BT.idct_planes_dense, the
    hand-written kernel on CUDA tensors, after the scan.
    """
    blocks, bad = ED.decode_segments(words, nblk, lut, tsel, rawlen, skip0,
                                     preds0, max_blocks=ri * 6)
    return BT.idct_planes_dense(blocks, bad, qarr, N=N, nseg=nseg, ri=ri,
                                geom=geom, level=level)


def _parse_batch(streams: list[bytes], *, gray: bool = False,
                 precision: str = "fast", transport: str | None = None):
    """Marker parse of a uniform batch, with the decodability check on
    every stream (on every transport).  Any frame the JAX package decodes
    is taken: 1 or 3 components, any sampling factors.

    Returns (pjs, geom, level): geom is the per-component tuple of
    (mcus_y, mcus_x, v, h, dup_y, dup_x) the device programs take."""
    if transport not in (None, "ycc420", "device", "indexed", "rgb"):
        raise ValueError(f"unknown decode transport {transport!r}")
    _dtype(precision)
    pjs = [parse(s) for s in streams]
    for pj in pjs:
        check_decodable(pj)
    p0 = pjs[0]
    for pj in pjs[1:]:
        if (pj.props.width, pj.props.height) != (p0.props.width, p0.props.height) \
           or len(pj.frame_components) != len(p0.frame_components):
            raise ValueError("decode_batch needs uniform stream geometry")
    geos = [
        ComponentGeometry(fc.H, fc.V, p0.hmax, p0.vmax, p0.props.width,
                          p0.props.height)
        for fc in p0.frame_components
    ]
    mcus_x, mcus_y = geos[0].mcus_x, geos[0].mcus_y
    geom = tuple(
        (mcus_y, mcus_x, fc.V, fc.H, geos[i].dup_y, geos[i].dup_x)
        for i, fc in enumerate(p0.frame_components))
    level = 128 if p0.props.sample_precision == 8 else 2048
    return pjs, geom, level


def _std420(pj) -> bool:
    """3-component 4:2:0 with the standard sampling factors."""
    return (len(pj.frame_components) == 3
            and [(fc.H, fc.V) for fc in pj.frame_components]
            == [(2, 2), (1, 1), (1, 1)])


def _pick_transport(pjs, *, gray: bool, precision: str,
                    transport: str | None) -> str:
    """The decode transport (jax_codec.decode_batch_dispatch's policy).

    None: "ycc420" for fast standard 4:2:0 colour, and for restart streams
    "device" when the batch is eligible (uniform DRI, decided from the
    headers before any device work: no error of the device path is ever
    caught); "rgb" otherwise.  "ycc420", "device" and "indexed" take fast
    standard 4:2:0 colour only and raise ValueError on anything else (the
    JAX package moves an ineligible "ycc420" request to "rgb" without a
    word); "rgb" takes every frame."""
    p0 = pjs[0]
    fast420 = precision == "fast" and _std420(p0) and not gray
    if transport is None:
        if not fast420:
            return "rgb"
        if p0.restart_interval > 0:
            try:
                _check_device_eligible(pjs)
                return "device"
            except ValueError:
                pass
        return "ycc420"
    if transport != "rgb" and not fast420:
        raise ValueError(
            f"transport={transport!r} supports fast-precision standard "
            "4:2:0 color streams only")
    return transport


def _ycc420_host_prep(pjs, geom, level):
    """Host half of the ycc420 transport: the C++ entropy frontend and
    sparsify into one flat upload buffer.  Returns (flat_host uint8,
    kwargs of _decode_fused_batch_ycc420)."""
    p0 = pjs[0]
    HG._check_uniform_quant(pjs, p0)
    K = 10
    flat_host, shapes, caps = HG._ycc420_host_frontend(pjs, K)
    kwargs = dict(
        geom=geom, level=level, shapes=shapes, K=K, N=len(pjs), caps=caps,
        qtuple=tuple(tuple(int(x) for x in p0.quant[fc.Tq])
                     for fc in p0.frame_components))
    return flat_host, kwargs


def _decode_host_prep(streams: list[bytes], *, gray: bool, precision: str,
                      transport: str | None):
    """Host half of the ycc420 decode of `streams`: _parse_batch, then
    _ycc420_host_prep.

    Returns (flat_host uint8, device-program kwargs, props, mcus_x,
    mcus_y)."""
    if transport not in (None, "ycc420"):
        raise ValueError("_decode_host_prep is the ycc420 transport's")
    pjs, geom, level = _parse_batch(streams, gray=gray, precision=precision,
                                    transport=transport)
    _pick_transport(pjs, gray=gray, precision=precision,
                    transport="ycc420")  # raises unless eligible
    flat_host, kwargs = _ycc420_host_prep(pjs, geom, level)
    return flat_host, kwargs, pjs[0].props, geom[0][1], geom[0][0]


def _rgb_host_prep(pjs, geom, level, *, gray: bool, precision: str):
    """Host half of the rgb transport: the Huffman frontend of every image
    (C++, thread-parallel across images) into ONE coefficient array
    [N, sum(B_i), 64].  Returns (coeff_all, kwargs of
    _decode_fused_batch)."""
    p0 = pjs[0]
    HG._check_uniform_quant(pjs, p0)
    per_image = HG._decode_entropy_batch(pjs)
    ncomp = len(p0.frame_components)
    sizes = tuple(int(per_image[0][c].shape[0]) for c in range(ncomp))
    dt0 = np.result_type(*[cb.dtype for cb in per_image[0]])
    coeff_all = np.concatenate(
        [np.stack([np.asarray(pi[c], dt0) for pi in per_image])
         for c in range(ncomp)], axis=1)
    qtuple = tuple(tuple(int(x) for x in p0.quant[fc.Tq])
                   for fc in p0.frame_components)
    return coeff_all, dict(geom=geom, level=level,
                           gray=gray or ncomp == 1, precision=precision,
                           sizes=sizes, qtuple=qtuple)


def _decode_fused_batch(coeff_all: torch.Tensor, *, geom, level, gray,
                        precision, sizes, qtuple):
    """Device program of the rgb transport (jax_codec.
    _decode_fused_batch_packed): coefficients [N, sum(B_i), 64] of every
    component in one array -> [N, H_mcu, W_mcu, 3] uint8 RGB, or
    [N, H_mcu, W_mcu, 1] for gray or a 1-component frame.  Dequantize,
    IDCT at the precision, deblockify into unclamped int32 planes
    (BT.idct_planes_rgb), then nearest upsampling by the sampling factors
    with colour or the gray clamp (C.planes_to_rgb): on CUDA tensors two
    hand-written kernels, one launch each.  Gray needs the luma only, so
    the chroma components are not transformed."""
    spats = BT.idct_planes_rgb(coeff_all, geom=geom, level=level, gray=gray,
                               sizes=sizes, qtuple=qtuple,
                               precision=precision)
    return C.planes_to_rgb(spats, geom, gray, _dtype(precision))


def _i32(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)


def _check_device_eligible(pjs) -> None:
    """transport='device' takes restart-interval streams that share one
    DRI; raises ValueError otherwise.  Reads the parsed headers only."""
    ri = pjs[0].restart_interval
    if ri <= 0:
        raise ValueError("transport='device' needs restart-interval streams")
    if any(pj.restart_interval != ri for pj in pjs[1:]):
        raise ValueError("transport='device' needs uniform DRI")


def _decode_batch_device_dispatch(pjs, geom, level, dev):
    """Host prep and device program of the full device decode
    (transport='device', jax_codec._decode_batch_device_dispatch): restart
    offsets and per-segment destuff (C++), uploads of the big-endian words
    and the per-lane block counts, table selects and destuffed lengths.
    Every stream must share the restart interval; Huffman AND quant tables
    may differ per image (deduplicated LUT sets with a per-lane select,
    [N, 3, 64] quant tables)."""
    from ..runtime import native

    native.get_lib()
    _check_device_eligible(pjs)
    p0 = pjs[0]
    ri = p0.restart_interval
    N = len(pjs)
    mcus_y, mcus_x = geom[0][0], geom[0][1]
    nmcu = mcus_x * mcus_y
    nseg = -(-nmcu // ri)
    words, nblk, rawlen = HG._device_host_frontend(pjs, nmcu, ri, nseg)
    lut, tsel = HG._device_luts(pjs, nseg)
    packed = _decode_fused_batch_device(
        ED.words_tensor(words).to(dev), _i32(nblk, dev),
        ED.device_lut(lut, dev), _i32(tsel, dev), _i32(rawlen, dev),
        _i32(HG._quant_arr(pjs), dev),
        N=N, nseg=nseg, ri=ri, geom=geom, level=level)
    # ycc420 layout + one bad-flag byte per image
    return ("device", packed, p0.props, N, mcus_x, mcus_y)


def _decode_batch_indexed_dispatch(pjs, geom, level, dev, k_mcus: int = 8):
    """Index-assisted two-pass decode of RESTART-FREE streams
    (transport='indexed', jax_codec._decode_batch_indexed_dispatch): a
    serial LENGTH-ONLY host scan (C++) records every k_mcus MCUs the bit
    offset and absolute DC predictors, then all pseudo-segments decode in
    parallel on the device through the same scan as the restart transport
    (per-lane skip0 bit phase and preds0).  The upload is raw entropy
    bytes, as for transport='device'."""
    from ..runtime import native

    native.get_lib()
    p0 = pjs[0]
    if any(pj.restart_interval for pj in pjs):
        raise ValueError("transport='indexed' is for restart-FREE streams"
                         " (restart streams use transport='device')")
    N = len(pjs)
    mcus_y, mcus_x = geom[0][0], geom[0][1]
    nmcu = mcus_x * mcus_y
    nseg = -(-nmcu // k_mcus)
    words, nblk, skip0, preds0 = HG._indexed_host_frontend(
        pjs, nmcu, k_mcus, nseg)
    lut, tsel = HG._device_luts(pjs, nseg)
    packed = _decode_fused_batch_device(
        ED.words_tensor(words).to(dev), _i32(nblk, dev),
        ED.device_lut(lut, dev), _i32(tsel, dev), None,
        _i32(HG._quant_arr(pjs), dev), _i32(skip0, dev), _i32(preds0, dev),
        N=N, nseg=nseg, ri=k_mcus, geom=geom, level=level)
    return ("device", packed, p0.props, N, mcus_x, mcus_y)


def _dispatch(pjs, geom, level, transport: str, dev, *, gray: bool,
              precision: str):
    """Host prep, uploads and device program of one transport; a ticket
    for decode_batch_finish."""
    if transport == "device":
        return _decode_batch_device_dispatch(pjs, geom, level, dev)
    if transport == "indexed":
        return _decode_batch_indexed_dispatch(pjs, geom, level, dev)
    if transport == "ycc420":
        flat_host, kwargs = _ycc420_host_prep(pjs, geom, level)
        packed = _decode_fused_batch_ycc420(
            torch.from_numpy(flat_host).to(dev), **kwargs)
        return ("ycc420", packed, pjs[0].props, kwargs["N"], geom[0][1],
                geom[0][0])
    coeff_all, kwargs = _rgb_host_prep(pjs, geom, level, gray=gray,
                                       precision=precision)
    return ("rgb", _decode_fused_batch(torch.from_numpy(coeff_all).to(dev),
                                       **kwargs), pjs[0].props)


def decode_batch_dispatch(streams: list[bytes], *, gray: bool = False,
                          precision: str = "fast",
                          transport: str | None = None,
                          device: str | torch.device = "cuda"):
    """Marker parse, host frontend, uploads and the device program for a
    uniform batch.

    transport: "ycc420" runs the Huffman frontend on the host (C++) and
    uploads sparse coefficients; "device" uploads the destuffed entropy
    bytes of restart-interval streams and runs the Huffman decode on the
    device, one lane per restart segment; "indexed" does the same for
    restart-FREE streams after a length-only host scan; "rgb" uploads
    the host frontend's coefficients and fetches RGB, for any frame, gray
    and precision="exact".  None picks as _pick_transport says.  The
    first three give the same pixels.

    Returns a ticket for decode_batch_finish."""
    dev = resolve(device)
    pjs, geom, level = _parse_batch(streams, gray=gray, precision=precision,
                                    transport=transport)
    transport = _pick_transport(pjs, gray=gray, precision=precision,
                                transport=transport)
    return _dispatch(pjs, geom, level, transport, dev, gray=gray,
                     precision=precision)


def decode_batch_finish(ticket):
    """Fetch the result once and finish on the host -> ([N,H,W,3] u8,
    props).  ycc420/device tickets: C++ upsample + colour; a "device"
    ticket carries one corruption flag per image and raises ValueError
    naming the streams whose entropy data is corrupt.  rgb tickets: crop
    to the true size, gray repeated to 3 channels."""
    kind = ticket[0]
    if kind == "rgb":
        _, out, props = ticket
        out = out.cpu().numpy()[:, :props.height, :props.width]
        if out.shape[-1] == 1:
            out = np.repeat(out, 3, axis=-1)
        return out, props
    _, packed, props, N, mcus_x, mcus_y = ticket
    finish = (HG._decode_batch_device_finish if kind == "device"
              else HG._decode_batch_ycc420_finish)
    return finish((kind, packed.cpu().numpy(), props, N, mcus_x, mcus_y))


def decode_batch(streams: list[bytes], *, gray: bool = False,
                 precision: str = "fast", transport: str | None = None,
                 device: str | torch.device = "cuda"):
    """Decode a batch of same-geometry JPEGs -> ([N, H, W, 3] uint8,
    props).  Every stream must be decodable (DHT, DQT and SOS present);
    raises ValueError otherwise."""
    return decode_batch_finish(decode_batch_dispatch(
        streams, gray=gray, precision=precision, transport=transport,
        device=device))


def decode(data: bytes, *, gray: bool = False, precision: str = "fast",
           verbose: bool = False, transport: str | None = None,
           device: str | torch.device = "cuda"):
    """Decode baseline JPEG bytes -> (r, g, b [H, W] uint8, ImageProps)
    (jax_codec.decode): the batch transports at N=1, same choices and
    default policy as decode_batch.

    verbose: per-phase section timers on stdout, the decoder<Debug>
    analog of the reference."""
    import contextlib

    from ..utils.timing import SectionTimer

    phase = (lambda msg: SectionTimer(msg, indent="\t")) if verbose \
        else (lambda msg: contextlib.nullcontext())
    dev = resolve(device)
    with phase("analyzing header..."):
        pjs, geom, level = _parse_batch([data], gray=gray,
                                        precision=precision,
                                        transport=transport)
    transport = _pick_transport(pjs, gray=gray, precision=precision,
                                transport=transport)
    with phase("entropy frontend + sparse upload (dispatch)..."):
        ticket = _dispatch(pjs, geom, level, transport, dev, gray=gray,
                           precision=precision)
    with phase("device backend + fetch + color tail..."):
        out, props = decode_batch_finish(ticket)
    out = out[0]
    return out[..., 0], out[..., 1], out[..., 2], props
