"""Batched encode and decode over uniform image batches (torch).

Counterpart of the ycc420-transport paths of jpezy_tpu.codec.jax_codec:

Encode: host C++ RGB -> YCC 4:2:0 int8 planes (float64, the reference's
exact truncation) -> ONE packed int8 upload -> blockify, DCT, quantize,
the CUDA entropy kernel (Huffman emissions and bit packing in one launch
per component), stream concat -> ONE fetch of `combined` [N, 1 + maxw] ->
host header + byte stuffing.

Decode: marker parse (every stream must be decodable) -> host C++ Huffman
frontend + sparsify -> ONE uint8 upload -> densify, dequantize, float32
IDCT, deblockify, clamp to u8 planes -> ONE fetch -> C++ upsample + color.

precision:
  "fast"  - float32 transforms at IEEE precision (TF32 refused)
  "exact" - float64 ordered sums, byte-identical to the oracle (encode)

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
restart_interval > 0, optimize=True, the "rgb" encode transport, and on
decode the "rgb"/"device"/"indexed" transports, exact-mode decode, gray
decode and non-4:2:0 streams.
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
from ..core.props import make_encode_props
from ..device import resolve
from ..ops import blocks as B
from ..ops import dct as D
from ..ops import entropy as E
from ..ops import quantize as Q
from . import host_glue as HG

_TODO = "not ported to jpezy_tpu_torch yet (ROADMAP.md, Queue 1: {})"


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
    (yqt, cqt) quant tables; None = the fixed Annex K tables."""
    yqt, cqt = qtables if qtables is not None else (None, None)
    yb = B.blockify_luma(y)
    cbb = B.blockify_chroma(cb)
    crb = B.blockify_chroma(cr)
    if gray:
        cbb = torch.zeros_like(cbb)
        crb = torch.zeros_like(crb)
    out = []
    for blk, chroma, qt in ((yb, False, yqt), (cbb, True, cqt),
                            (crb, True, cqt)):
        n, b, _ = blk.shape
        out.append(Q.quantize(
            D.forward_dct(blk.reshape(-1, 64), dtype), chroma,
            rounded=rounded, qtable=qt,
        ).reshape(n, b, 64))
    return tuple(out)


def _emit_local(yq, cbq, crq):
    """Quantized blocks -> per-component (words, bits), component order
    (parallel/sharded.py:_emit_local with tile_axis=None, interleave=False).

    Images are flattened into the block axis: emissions are block-local
    once the per-image DC chains are captured in the predictors.  One
    entropy kernel per component (E.encode_block_words)."""
    words, bits = [], []
    for q, chroma in ((yq, False), (cbq, True), (crq, True)):
        n, b, _ = q.shape
        pred = E.dc_predictors(q[:, :, 0])
        w_c, b_c = E.encode_block_words(q.reshape(-1, 64), pred.reshape(-1),
                                        chroma)
        words.append(w_c.reshape(n, b, w_c.shape[-1]))
        bits.append(b_c.reshape(n, b))
    return tuple(words), tuple(bits)


def stream_budget_words_batch(nblocks: int) -> int:
    """Batched-path stream budget: 2 words/block = 1 bit/pixel equivalent
    (jax_codec.stream_budget_words_batch).  Overflowing images fall back
    to a per-image host splice in encode_batch_finish."""
    return max(4096, nblocks * 2)


def _concat_batch_combined_comp(wc, bc):
    """Batched stream concat from PER-COMPONENT packed words
    (jax_codec._concat_batch_combined_comp without restarts).

    The scatter is order-independent, so blocks scatter from component
    order with MCU-ordered global bit offsets; only the small [N, nm*6]
    bits array is interleaved.  Returns (combined [N, 1 + maxw] int64 with
    column 0 = total bits, words_comp [N, nm*6, W] in component order,
    bits_mcu [N, nm*6] in MCU order)."""
    N, nm = bc[1].shape
    bits_mcu = torch.cat(
        [bc[0].reshape(N, nm, 4), bc[1].reshape(N, nm, 1),
         bc[2].reshape(N, nm, 1)], dim=2).reshape(N, nm * 6)
    maxw = stream_budget_words_batch(nm * 6)
    goff, total = E.stream_offsets_batch(bits_mcu)
    g6 = goff.reshape(N, nm, 6)
    goff_c = torch.cat(
        [g6[:, :, :4].reshape(N, nm * 4), g6[:, :, 4], g6[:, :, 5]], dim=1)
    words_c = torch.cat(wc, dim=1)
    stream = E._concat_batch_scatter(words_c, goff_c, maxw)
    combined = torch.cat([total[:, None], stream], dim=1)
    return combined, words_c, bits_mcu


def _encode_batch_blocks_packed(packed: torch.Tensor, *, h: int, w: int,
                                gray: bool = False, precision: str = "fast",
                                rounded: bool = False,
                                quality: int | None = None):
    """Device program of the ycc420 transport: packed [N, H*W +
    2*(H/2)*(W/2)] int8 holds Y then Cb then Cr per image
    (jax_codec._encode_batch_blocks_packed)."""
    N = packed.shape[0]
    ny, nc = h * w, (h // 2) * (w // 2)
    y = packed[:, :ny].reshape(N, h, w)
    cb = packed[:, ny:ny + nc].reshape(N, h // 2, w // 2)
    cr = packed[:, ny + nc:].reshape(N, h // 2, w // 2)
    qtables = None
    if quality is not None:
        c = codec_constants(packed.device, quality)
        qtables = (c["y_quant"], c["c_quant"])
    yq, cbq, crq = _quantize_local_ycc(
        y, cb, cr, gray=gray, dtype=_dtype(precision), rounded=rounded,
        qtables=qtables)
    wc, bc = _emit_local(yq, cbq, crq)
    return _concat_batch_combined_comp(wc, bc)


def encode_batch_dispatch(rgbs: np.ndarray, *, gray: bool = False,
                          precision: str = "fast", rounded: bool = False,
                          transport: str | None = None,
                          quality: int | None = None,
                          restart_interval: int = 0,
                          optimize: bool = False,
                          device: str | torch.device = "cuda"):
    """Host colour conversion, one upload and the device program for a
    uniform batch [N, H, W, 3] uint8 (H, W multiples of 16).

    Returns a ticket for encode_batch_finish.  CUDA work is queued on the
    current stream; nothing here waits for it."""
    dev = resolve(device)
    n, h, w = rgbs.shape[:3]
    if h % 16 or w % 16:
        raise ValueError("encode_batch needs multiple-of-16 dims")
    if restart_interval < 0:
        raise ValueError(
            f"restart_interval must be >= 0, got {restart_interval}")
    if restart_interval > 0:
        raise NotImplementedError("restart_interval > 0 is " + _TODO.format(
            "restart encode and stream_offsets_restart_batch"))
    if optimize:
        raise NotImplementedError("optimize=True is " + _TODO.format(
            "optimize (symbol_histograms, _encode_batch_custom)"))
    if transport not in (None, "ycc420"):
        raise NotImplementedError(f"transport={transport!r} is " + _TODO.format(
            "the rgb transports"))
    _dtype(precision)
    if quality is not None:
        T.scale_quant_tables(quality)  # validate before any device work
    y, cb, cr = HG.host_rgb_to_ycc420(rgbs)
    packed = np.concatenate(
        [y.reshape(n, -1), cb.reshape(n, -1), cr.reshape(n, -1)], axis=1)
    combined, words, bits = _encode_batch_blocks_packed(
        torch.from_numpy(packed).to(dev), h=h, w=w, gray=gray,
        precision=precision, rounded=rounded, quality=quality)
    return dict(combined=combined, words=words, bits=bits, n=n, h=h, w=w,
                gray=gray, quality=quality)


def encode_batch_finish(ticket) -> list[bytes]:
    """Fetch `combined` once and assemble the JFIF streams on the host."""
    combined = ticket["combined"].cpu().numpy().astype(np.uint32)
    n, h, w = ticket["n"], ticket["h"], ticket["w"]
    quality = ticket["quality"]
    geo = EncodeGeometry(width=w, height=h)
    maxw = combined.shape[1] - 1
    qt = T.scale_quant_tables(quality) if quality is not None else None
    props = make_encode_props(w, h, gray=ticket["gray"])
    header = writer.write_header(props, quant_tables=qt)
    out = []
    for i in range(n):
        total = int(combined[i, 0])
        if total <= 32 * maxw:
            packed = HG._stream_to_bytes(combined[i, 1:], total)
        else:  # overflow: host splice of this image's words only
            wi = ticket["words"][i].cpu().numpy().astype(np.uint32)
            packed, _ = splice_blocks(
                HG._words_comp_to_mcu(wi, geo.num_mcus),
                ticket["bits"][i].cpu().numpy().astype(np.int32))
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


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _densify(mask_lo, mask_hi, vals):
    """Sparse coefficient transport -> dense [B, 64] int32 blocks.

    mask_lo/hi: [B] uint32 nonzero masks (int64 values; natural index j);
    vals: [B, K] nonzero values in index order.  Each set bit's rank
    (exclusive cumsum) indexes its value; plain gather in place of the JAX
    package's K-way select chain."""
    dev = vals.device
    j = torch.arange(32, dtype=torch.int64, device=dev)[None, :]
    blo = (mask_lo.to(torch.int64)[:, None] >> j) & 1
    bhi = (mask_hi.to(torch.int64)[:, None] >> j) & 1
    bits = torch.cat([blo, bhi], dim=1)                     # [B, 64]
    rank = torch.cumsum(bits, dim=1) - bits
    K = vals.shape[1]
    picked = vals.to(torch.int32).gather(1, rank.clamp(max=K - 1))
    return torch.where((bits == 1) & (rank < K), picked, 0)


def _bytes_as(buf: torch.Tensor, dtype) -> torch.Tensor:
    """Reinterpret a 1-D uint8 slice as `dtype` (little-endian, as the
    host wrote it); the clone gives the view an aligned base."""
    return buf.clone().view(dtype)


def _decode_fused_batch_ycc420(flat: torch.Tensor, *, geom, level, shapes,
                               K, N, caps, qtuple):
    """Sparse coefficients in, packed native-resolution u8 YCC planes out
    (jax_codec._decode_fused_batch_ycc420, same flat layout).

    flat: ONE uint8 buffer.  First N*X bytes are per-image rows holding,
    per component, mask_lo [N,B] u32 | mask_hi [N,B] u32 | vals [N,B,K]
    int8; then, per component, the overflow data oidx [cap] i32 | orows
    [cap, 64] i16, padded with the out-of-range sentinel N*B_i.  Returns
    [N, H*W*1.5] uint8 for 4:2:0.
    """
    dev = flat.device
    X = sum((4 + 4 + K) * Bn for Bn in shapes)
    packed = flat[: N * X].reshape(N, X)
    ooff = N * X
    outs = []
    off = 0
    for Bn, cap, qt, (mcus_y, mcus_x, v, h, _, _) in zip(
            shapes, caps, qtuple, geom):
        ml = _bytes_as(packed[:, off:off + 4 * Bn], torch.int32)
        off += 4 * Bn
        mh = _bytes_as(packed[:, off:off + 4 * Bn], torch.int32)
        off += 4 * Bn
        vv = packed[:, off:off + Bn * K].reshape(N * Bn, K).view(torch.int8)
        off += Bn * K
        dense = _densify(ml.reshape(-1).to(torch.int64) & E.M32,
                         mh.reshape(-1).to(torch.int64) & E.M32, vv)
        if cap:
            oidx = _bytes_as(flat[ooff:ooff + 4 * cap], torch.int32)
            ooff += 4 * cap
            orows = _bytes_as(flat[ooff:ooff + 128 * cap],
                              torch.int16).reshape(cap, 64)
            ooff += 128 * cap
            # Padding carries the sentinel N*Bn.  It is filtered into one
            # extra row that is dropped afterwards, so it can never wrap
            # onto a real block (and the host need not be waited on).
            drop = N * Bn
            idx = torch.where(oidx.to(torch.int64) < drop,
                              oidx.to(torch.int64), drop)
            ext = torch.cat([dense, torch.zeros((1, 64), dtype=dense.dtype,
                                                device=dev)])
            ext.index_copy_(0, idx, orows.to(dense.dtype))
            dense = ext[:drop]
        qtab = torch.tensor(qt, dtype=torch.int32, device=dev)
        deq = Q.dequantize(dense, qtab)
        spat = D.inverse_dct(deq, level, torch.float32).reshape(N, Bn, 64)
        plane = B.deblockify(spat, mcus_y, mcus_x, v, h)
        outs.append(plane.clamp(0, 255).to(torch.uint8).reshape(N, -1))
    return torch.cat(outs, dim=1)


def _decode_host_prep(streams: list[bytes], *, gray: bool, precision: str,
                      transport: str | None):
    """Host half of decode_batch_dispatch: marker parse with the
    decodability check on every stream, then the C++ entropy frontend and
    sparsify into one flat upload buffer.

    Returns (flat_host uint8, device-program kwargs, props, mcus_x,
    mcus_y)."""
    if transport not in (None, "ycc420"):
        raise NotImplementedError(f"transport={transport!r} is " + _TODO.format(
            "the device Huffman decode and the rgb transports"))
    if _dtype(precision) != torch.float32:
        raise NotImplementedError("precision='exact' decode is " + _TODO.format(
            "the rgb transports and the exact-mode decode"))
    if gray:
        raise NotImplementedError("gray decode is " + _TODO.format(
            "the rgb transports and the exact-mode decode"))
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
    std420 = (
        len(p0.frame_components) == 3
        and [(fc.H, fc.V) for fc in p0.frame_components] == [(2, 2), (1, 1), (1, 1)]
    )
    if not std420:
        raise NotImplementedError(
            "decode of streams other than 3-component 4:2:0 is "
            + _TODO.format("the rgb transports and the exact-mode decode"))
    HG._check_uniform_quant(pjs, p0)
    K = 10
    flat_host, shapes, caps = HG._ycc420_host_frontend(pjs, K)
    kwargs = dict(
        geom=tuple(
            (mcus_y, mcus_x, fc.V, fc.H, geos[i].dup_y, geos[i].dup_x)
            for i, fc in enumerate(p0.frame_components)),
        level=128 if p0.props.sample_precision == 8 else 2048,
        shapes=shapes, K=K, N=len(pjs), caps=caps,
        qtuple=tuple(tuple(int(x) for x in p0.quant[fc.Tq])
                     for fc in p0.frame_components))
    return flat_host, kwargs, p0.props, mcus_x, mcus_y


def decode_batch_dispatch(streams: list[bytes], *, gray: bool = False,
                          precision: str = "fast",
                          transport: str | None = None,
                          device: str | torch.device = "cuda"):
    """Marker parse, host entropy frontend, one upload and the device
    program for a uniform batch of 3-component 4:2:0 streams.

    Returns a ticket for decode_batch_finish."""
    dev = resolve(device)
    flat_host, kwargs, props, mcus_x, mcus_y = _decode_host_prep(
        streams, gray=gray, precision=precision, transport=transport)
    packed = _decode_fused_batch_ycc420(
        torch.from_numpy(flat_host).to(dev), **kwargs)
    return ("ycc420", packed, props, kwargs["N"], mcus_x, mcus_y)


def decode_batch_finish(ticket):
    """Fetch the planes once; C++ upsample + colour -> ([N,H,W,3] u8, props)."""
    kind, packed, props, N, mcus_x, mcus_y = ticket
    return HG._decode_batch_ycc420_finish(
        (kind, packed.cpu().numpy(), props, N, mcus_x, mcus_y))


def decode_batch(streams: list[bytes], *, gray: bool = False,
                 precision: str = "fast", transport: str | None = None,
                 device: str | torch.device = "cuda"):
    """Decode a batch of same-geometry 4:2:0 JPEGs ->
    ([N, H, W, 3] uint8, props).  Every stream must be decodable (DHT, DQT
    and SOS present); raises ValueError otherwise."""
    return decode_batch_finish(decode_batch_dispatch(
        streams, gray=gray, precision=precision, transport=transport,
        device=device))
