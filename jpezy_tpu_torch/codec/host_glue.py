"""Host helpers of the batch transports, copied from jpezy_tpu.codec.jax_codec.

jax_codec imports jax at module level, and the port must not, so the
numpy/C++ host halves of the ycc420 encode and decode transports are
copied here verbatim (only imports adjusted).  Each copy names its
original; tests/test_torch_pipeline.py asserts that copy and original give
identical outputs.  A later change can move them into one shared jax-free
module that both packages import.
"""
from __future__ import annotations

import numpy as np

from ..bitstream.reader import ParsedJpeg, split_entropy_segments
from ..core.geometry import ComponentGeometry


def host_rgb_to_ycc420(rgbs: np.ndarray):
    """Copy of jpezy_tpu.codec.jax_codec.host_rgb_to_ycc420.

    Host-side RGB -> level-shifted YCC 4:2:0 int8 planes.

    Same float64 expression order / int truncation as ops.colorspace.rgb_to_ycc
    (= the reference's double math, jpezy_encoder.hpp:245-256), with the 4:2:0
    top-left decimation (jpezy_encoder.hpp:116-143) applied BEFORE the chroma
    arithmetic (pointwise, so the order is equivalent and 4x cheaper).

    Returns (y [N,H,W] int8, cb, cr [N,H/2,W/2] int8): 1.5 bytes/pixel on the
    host->device link vs 3 for RGB.

    Uses the multithreaded C++ runtime when available (bit-identical; this
    stage is the encode pipeline's host bottleneck), else numpy float64.
    """
    try:
        from ..runtime import native

        return native.rgb_to_ycc420(np.ascontiguousarray(rgbs, np.uint8))
    except ImportError:
        pass
    rf = rgbs[..., 0].astype(np.float64)
    gf = rgbs[..., 1].astype(np.float64)
    bf = rgbs[..., 2].astype(np.float64)
    y = ((0.2990 * rf) + (0.5870 * gf) + (0.1140 * bf) - 128.0).astype(
        np.int32).astype(np.int8)
    sub = rgbs[:, 0::2, 0::2, :].astype(np.float64)
    rs, gs, bs = sub[..., 0], sub[..., 1], sub[..., 2]
    cb = (-(0.1687 * rs) - (0.3313 * gs) + (0.5000 * bs)).astype(
        np.int32).astype(np.int8)
    cr = ((0.5000 * rs) - (0.4187 * gs) - (0.0813 * bs)).astype(
        np.int32).astype(np.int8)
    return y, cb, cr


def _stream_to_bytes(stream: np.ndarray, total: int) -> bytes:
    """Copy of jpezy_tpu.codec.jax_codec._stream_to_bytes: uint32 stream
    words -> entropy bytes, final partial byte 1-padded."""
    nbytes = (total + 7) // 8
    raw = bytearray(stream.astype(">u4").tobytes()[:nbytes])
    pad = (-total) % 8
    if pad:
        raw[-1] |= (1 << pad) - 1  # T.81 F.1.2.3 one-padding
    return bytes(raw)


def _words_comp_to_mcu(w: np.ndarray, nm: int) -> np.ndarray:
    """Copy of jpezy_tpu.codec.jax_codec._words_comp_to_mcu.

    Host-side reorder of one image's component-ordered packed words
    [nm*6, ...] to MCU order (overflow fallback only)."""
    return np.concatenate(
        [w[: nm * 4].reshape(nm, 4, -1),
         w[nm * 4: nm * 5].reshape(nm, 1, -1),
         w[nm * 5:].reshape(nm, 1, -1)], axis=1).reshape(nm * 6, -1)


def decode_entropy_host(pj: ParsedJpeg) -> list[np.ndarray]:
    """Copy of jpezy_tpu.codec.jax_codec.decode_entropy_host.

    Host entropy frontend: Huffman decode -> [B, 64] blocks/component.

    Native C++ paths: restart-segment thread-parallel decode when the
    stream has DRI/RSTn; the destuffed branchless-refill serial LUT decode
    otherwise (the referent being the strictly serial bit chain at
    jpezy_decoder.hpp:583-642).  Restart-free single streams are
    irreducibly serial per stream on a narrow host (docs/DESIGN.md section
    5 records the retired speculative-resync experiment); batches decode
    thread-parallel ACROSS images instead.  Numpy LUT decoder as the
    no-native fallback.
    """
    from . import oracle as _o

    hmax, vmax = pj.hmax, pj.vmax
    geos = [
        ComponentGeometry(fc.H, fc.V, hmax, vmax, pj.props.width, pj.props.height)
        for fc in pj.frame_components
    ]
    mcus_x, mcus_y = geos[0].mcus_x, geos[0].mcus_y
    n_mcus = mcus_x * mcus_y

    try:
        from ..runtime import native

        return native.entropy_decode(pj, n_mcus)
    except (ImportError, OSError, RuntimeError):
        pass

    dc_lut = [_o._huff_lut(pj.huff[0][sc.Td]) for sc in pj.scan_components]
    ac_lut = [_o._huff_lut(pj.huff[1][sc.Ta]) for sc in pj.scan_components]
    comp_order = [(i, geos[i].blocks_per_mcu) for i in range(len(pj.scan_components))]
    segments, _ = split_entropy_segments(pj.data, pj.entropy_start)
    out: list[list[np.ndarray]] = [[] for _ in pj.frame_components]
    pred = np.zeros(3, dtype=np.int64)
    n_total = mcus_x * mcus_y
    ri = pj.restart_interval if pj.restart_interval else n_total
    done = 0
    for seg in segments:
        if done >= n_total:
            break
        todo = min(ri, n_total - done)
        br = _o._BitReader(seg)
        _o.decode_segment_blocks(br, todo, comp_order, dc_lut, ac_lut, pred, out)
        done += todo
        pred[:] = 0
    if done < n_total:
        raise ValueError("truncated entropy data")
    return [np.stack(o) for o in out]


def _ycc420_host_frontend(pjs, K: int = 10):
    """Copy of jpezy_tpu.codec.jax_codec._ycc420_host_frontend.

    Host half of the ycc420 transport: entropy decode + sparsify per
    image, thread-parallel, -> ONE flat uint8 upload buffer + static metas.

    Split out so the bench can attribute frontend / upload / device / fetch
    separately (VERDICT r3 #4)."""
    from ..runtime import native

    native.get_lib()  # raise ImportError-family early if unavailable
    N = len(pjs)

    # entropy decode + sparsify per image, thread-parallel (both stages are
    # GIL-releasing C++ calls; images are independent)
    def _front(pj):
        blocks = decode_entropy_host(pj)
        return blocks, [native.sparsify8(b, K) for b in blocks]

    if N > 1:
        import concurrent.futures as cf
        import os as _os

        with cf.ThreadPoolExecutor(min(N, _os.cpu_count() or 1)) as ex:
            fronts = list(ex.map(_front, pjs))
    else:
        fronts = [_front(pjs[0])]

    # ONE uint8 upload buffer: per-image rows (per comp mask_lo | mask_hi |
    # vals), then per-comp overflow tails (see _decode_fused_batch_ycc420)
    shapes = tuple(fronts[0][0][c].shape[0] for c in range(3))
    pieces = []
    tails = []
    caps = []
    for c in range(3):
        Bn = shapes[c]
        mls, mhs, vvs, oidx_all, orows_all = [], [], [], [], []
        for i, (_, sp) in enumerate(fronts):
            ml, mh, vv, oidx, orows = sp[c]
            mls.append(ml); mhs.append(mh); vvs.append(vv)
            oidx_all.append(oidx + i * Bn)
            orows_all.append(orows)
        pieces.append(np.stack(mls).view(np.uint8).reshape(N, -1))
        pieces.append(np.stack(mhs).view(np.uint8).reshape(N, -1))
        pieces.append(np.stack(vvs).view(np.uint8).reshape(N, -1))
        oi = np.concatenate(oidx_all).astype(np.int32)
        orw = (np.concatenate(orows_all) if oidx_all
               else np.zeros((0, 64), np.int16))
        # pad to a bucket so jit shapes stay stable across batches; the
        # sentinel must be OUT OF BOUNDS (>= N*Bn) so mode="drop" discards
        # it -- a negative index would WRAP to a real block (ADVICE r2)
        cap = max(16, 1 << (len(oi) - 1).bit_length()) if len(oi) else 0
        if cap:
            oi = np.concatenate(
                [oi, np.full(cap - len(oi), N * Bn, np.int32)])
            orw = np.concatenate(
                [orw, np.zeros((cap - orw.shape[0], 64), np.int16)])
            tails.append(oi.view(np.uint8).reshape(-1))
            tails.append(orw.view(np.uint8).reshape(-1))
        caps.append(cap)

    flat_host = np.concatenate(
        [np.concatenate(pieces, axis=1).reshape(-1)] + tails)
    return flat_host, shapes, tuple(caps)


def _check_uniform_quant(pjs, p0) -> None:
    """Copy of jpezy_tpu.codec.jax_codec._check_uniform_quant.

    The host-frontend transports dequantize every image with p0's
    tables; a mixed-quality batch would silently decode garbage.  (The
    device transport carries per-image quant and has no such limit.)"""
    for pj in pjs[1:]:
        for fc, fc0 in zip(pj.frame_components, p0.frame_components):
            if not np.array_equal(pj.quant[fc.Tq], p0.quant[fc0.Tq]):
                raise ValueError(
                    "decode_batch needs uniform quant tables on this "
                    "transport (mixed-quality batches decode on "
                    "transport='device'/'indexed')")


def _decode_batch_ycc420_finish(ticket):
    """Copy of jpezy_tpu.codec.jax_codec._decode_batch_ycc420_finish.

    ticket: ("ycc420", packed u8 planes [N, H*W*1.5], props, N, mcus_x,
    mcus_y) -> ([N, H, W, 3] u8 RGB, props) via the C++ color tail."""
    from ..runtime import native

    _, packed, props, N, mcus_x, mcus_y = ticket
    packed = np.asarray(packed)  # ONE fetch
    H, W = props.height, props.width
    Hm, Wm = mcus_y * 16, mcus_x * 16
    ny = Hm * Wm
    nc = (Hm // 2) * (Wm // 2)
    # multithreaded batch color tail on the padded planes, crop after
    # (the pad is <= 15 px per axis; the chroma indexing is identical
    # because Hm, Wm are even and the crop only drops rows/cols)
    ys = packed[:, :ny].reshape(N, Hm, Wm)
    cbs = packed[:, ny : ny + nc].reshape(N, Hm // 2, Wm // 2)
    crs = packed[:, ny + nc :].reshape(N, Hm // 2, Wm // 2)
    out = native.ycc420_to_rgb_batch(ys, cbs, crs)[:, :H, :W]
    return out, props
