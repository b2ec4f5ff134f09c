"""Host helpers of the batch transports, copied from jpezy_tpu.codec.jax_codec.

jax_codec imports jax at module level, and the port must not, so the
numpy/C++ host halves of the encode and decode transports (ycc420,
restart segments, device, indexed and rgb) are copied here verbatim (only
imports adjusted; _device_luts keeps the LUT mode only, and
_device_host_frontend destuffs on the calling thread).  Each copy names
its original; tests/test_torch_pipeline.py and tests/test_torch_restart.py
assert that copy and original give identical outputs.  A later change can
move them into one shared jax-free module that both packages import.
"""
from __future__ import annotations

import numpy as np

from ..bitstream import writer
from ..bitstream.reader import ParsedJpeg, split_entropy_segments
from ..bitstream.splice import splice_blocks
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


def _splice_restart_raw(nw: np.ndarray, nb: np.ndarray, S: int,
                        ri: int, seg_bits: np.ndarray) -> bytes:
    """Copy of jpezy_tpu.codec.jax_codec._splice_restart_raw.

    Host splice of per-block words into byte-aligned restart segments
    (the overflow fallback mirroring concat_device_restart's layout)."""
    raw_parts = []
    for s in range(S):
        sl = slice(s * 6 * ri, (s + 1) * 6 * ri)
        seg_raw, sb = splice_blocks(
            np.ascontiguousarray(nw[sl]), np.ascontiguousarray(nb[sl]))
        # splice 1-pads the tail; _assemble_restart_segments re-ORs the
        # same bits
        raw_parts.append(seg_raw)
        assert sb == int(seg_bits[s])
    return b"".join(raw_parts)


def _assemble_restart_segments(raw: bytes, seg_bits: np.ndarray) -> bytes:
    """Copy of jpezy_tpu.codec.jax_codec._assemble_restart_segments.

    Join byte-aligned segments with 1-padding, stuffing and RSTn markers.

    raw: device stream bytes where segment s sits at byte offset
    sum(ceil(seg_bits[:s]/8)) (concat_device_restart layout).  RSTn markers
    are emitted between segments, indices cycling 0..7 (T.81 E.1.2), and are
    NOT byte-stuffed (they are markers, not entropy data).
    """
    parts = []
    base = 0
    S = len(seg_bits)
    for s in range(S):
        sb = int(seg_bits[s])
        nb = (sb + 7) // 8
        seg = bytearray(raw[base : base + nb])
        pad = (-sb) % 8
        if pad:
            seg[-1] |= (1 << pad) - 1  # T.81 F.1.2.3 one-padding
        parts.append(writer.byte_stuff(bytes(seg)))
        if s != S - 1:
            parts.append(bytes([0xFF, 0xD0 + (s % 8)]))
        base += nb
    return b"".join(parts)


def _words_comp_to_mcu(w: np.ndarray, nm: int) -> np.ndarray:
    """Copy of jpezy_tpu.codec.jax_codec._words_comp_to_mcu.

    Host-side reorder of one image's component-ordered packed words
    [nm*6, ...] to MCU order (overflow fallback only)."""
    return np.concatenate(
        [w[: nm * 4].reshape(nm, 4, -1),
         w[nm * 4: nm * 5].reshape(nm, 1, -1),
         w[nm * 5:].reshape(nm, 1, -1)], axis=1).reshape(nm * 6, -1)


def _decode_entropy_batch(pjs: list[ParsedJpeg]) -> list[list[np.ndarray]]:
    """Copy of jpezy_tpu.codec.jax_codec._decode_entropy_batch.

    Entropy-decode a batch of parsed streams, thread-parallel across
    images (the C++ frontend releases the GIL during the ctypes call, so
    N images decode on N cores -- the host analog of the data axis)."""
    if len(pjs) <= 1:
        return [decode_entropy_host(pj) for pj in pjs]
    import concurrent.futures as cf
    import os

    workers = min(len(pjs), os.cpu_count() or 1)
    with cf.ThreadPoolExecutor(workers) as ex:
        return list(ex.map(decode_entropy_host, pjs))


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


def _device_host_frontend(pjs, nmcu: int, ri: int, nseg: int):
    """jpezy_tpu.codec.jax_codec._device_host_frontend, with one change:
    each image's segments are destuffed on the calling thread
    (nthreads=1).  The library's default starts a thread per hardware core
    in every call, which for the few kilobytes of one image costs far more
    than the destuffing (measured on an H100 host, PERF.md).

    Host half of the device transport: restart offsets + per-segment
    destuff (C++) -> ([S, Lw] BE uint32 rows, [S] block
    counts, [S] destuffed byte lengths for the corruption check).  Split
    out for bench stage attribution (VERDICT r3 #4)."""
    from ..runtime import native

    N = len(pjs)
    datas = [np.frombuffer(pj.data, np.uint8)[pj.entropy_start:]
             for pj in pjs]
    offs = [native.find_restart_offsets(d, nmcu, ri) for d in datas]
    # row stride: max raw segment length + margin (peek reads <= 4 bytes
    # past the final bit), bucketed so jit shapes are stable across batches
    raw_max = 0
    for d, of in zip(datas, offs):
        ends = np.append(of[1:], len(d))
        raw_max = max(raw_max, int((ends - of).max()))
    L = 64
    while L < raw_max + 8:
        L *= 2
    rows = np.zeros((N * nseg, L), np.uint8)
    lens = np.zeros(N * nseg, np.int64)
    for i, (d, of) in enumerate(zip(datas, offs)):
        native.destuff_segments(d, of, rows[i * nseg: (i + 1) * nseg],
                                lens[i * nseg: (i + 1) * nseg], nthreads=1)
    words = rows.view(">u4").astype("=u4")         # [S, L/4] BE-packed
    nblk = np.minimum(ri, nmcu - np.arange(nseg) * ri) * 6
    nblk = np.tile(nblk.astype(np.int32), N)
    return words, nblk, lens.astype(np.int32)


def _indexed_host_frontend(pjs, nmcu: int, k_mcus: int, nseg: int):
    """Host half of the indexed transport, the numpy/C++ part of
    jpezy_tpu.codec.jax_codec._decode_batch_indexed_dispatch: a serial
    LENGTH-ONLY scan per image (C++ index_scan, thread-parallel across
    images) records every k_mcus MCUs the bit offset and the absolute DC
    predictors; each pseudo-segment's byte window is copied into one row.

    Returns ([S, Lw] BE uint32 rows, [S] block counts, skip0 [S] bit phase
    of each row's first byte, preds0 [S, 3] DC predictors)."""
    from ..runtime import native

    N = len(pjs)

    def _p1(pj):
        return native.index_scan(pj, nmcu, k_mcus)

    if N > 1:
        import concurrent.futures as cf
        import os as _os

        with cf.ThreadPoolExecutor(min(N, _os.cpu_count() or 1)) as ex:
            outs = list(ex.map(_p1, pjs))
    else:
        outs = [_p1(pjs[0])]

    need = 0
    for destuffed, bitoffs, _ in outs:
        ends = np.append((bitoffs[1:] >> 3) + 8, len(destuffed))
        need = max(need, int((ends - (bitoffs >> 3)).max()))
    L = 64
    while L < need + 8:
        L *= 2
    rows = np.zeros((N * nseg, L), np.uint8)
    skip0 = np.zeros(N * nseg, np.int32)
    preds0 = np.zeros((N * nseg, 3), np.int32)
    for i, (destuffed, bitoffs, preds) in enumerate(outs):
        native.copy_bit_windows(destuffed, bitoffs,
                                rows[i * nseg: (i + 1) * nseg])
        skip0[i * nseg: (i + 1) * nseg] = (bitoffs & 7)
        preds0[i * nseg: (i + 1) * nseg] = preds
    words = rows.view(">u4").astype("=u4")
    nblk = np.tile(
        (np.minimum(k_mcus, nmcu - np.arange(nseg) * k_mcus) * 6)
        .astype(np.int32), N)
    return words, nblk, skip0, preds0


def _device_luts(pjs, nseg: int):
    """jpezy_tpu.codec.jax_codec._device_luts in LUT mode (the chain
    tables are a TPU form and are not ported).

    Per-image decode LUTs, deduplicated by table content: [T, 6, 65536]
    stacked sets + a per-lane table index [N*nseg], so one batch may mix
    streams with different DHT tables."""
    from ..ops.entropy_decode import build_decode_lut, lut_content_key

    keys: dict[bytes, int] = {}
    luts = []
    tsel_img = np.empty(len(pjs), np.int32)
    for i, pj in enumerate(pjs):
        k = lut_content_key(pj.huff, pj.scan_components)
        if k not in keys:
            keys[k] = len(luts)
            luts.append(build_decode_lut(pj.huff, pj.scan_components))
        tsel_img[i] = keys[k]
    return np.stack(luts), np.repeat(tsel_img, nseg)


def _quant_arr(pjs) -> np.ndarray:
    """Copy of jpezy_tpu.codec.jax_codec._quant_arr.

    [N, 3, 64] int32 per-image quant tables (device dequant input)."""
    return np.stack([
        np.stack([np.asarray(pj.quant[fc.Tq], np.int32)
                  for fc in pj.frame_components])
        for pj in pjs])


def _decode_batch_device_finish(ticket):
    """Copy of jpezy_tpu.codec.jax_codec._decode_batch_device_finish.

    Validate the per-image corruption flags the device scan appended,
    then reuse the ycc420 color tail.  The reference propagates decode
    failure as an empty optional (jpezy_decoder.hpp:593,635 -> 109-120);
    our host paths raise -- so does the device transport (VERDICT r4 #4)."""
    _, packed, props, N, mcus_x, mcus_y = ticket
    packed = np.asarray(packed)  # ONE fetch (planes + flags)
    bad = packed[:, -1]
    if bad.any():
        raise ValueError(
            "corrupt entropy data in stream(s) "
            f"{np.nonzero(bad)[0].tolist()} (device Huffman scan)")
    return _decode_batch_ycc420_finish(
        ("ycc420", packed[:, :-1], props, N, mcus_x, mcus_y))


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
