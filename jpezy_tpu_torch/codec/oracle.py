"""Numpy oracle codec: faithful float64 reimplementation of the reference math.

This module defines the *canonical numerics* of the framework.  Every device
(JAX/Pallas) pipeline is tested against it.  It follows the reference's exact
integer-truncation semantics:

  - RGB->YCbCr with C `int()` truncation and the same expression order
    (reference: src/encoder/jpezy_encoder.hpp:244-263)
  - forward DCT in float64 with int() truncation of `sum * cu*cv / 4`
    (jpezy_encoder.hpp:146-166)
  - truncating integer division quantization (jpezy_encoder.hpp:168-172)
  - 4:2:0 chroma decimation taking the top-left pixel of each 2x2, no
    averaging (jpezy_encoder.hpp:116-143)
  - edge replication padding for non-multiple-of-16 sizes
    (jpezy_encoder.hpp:101,104)
  - IDCT `int(sum/4 + 128)` with clamp-to-byte truncation on color convert
    (src/decoder/jpezy_decoder.hpp:652-676)
  - nearest-neighbor chroma upsampling (jpezy_decoder.hpp:519-524)

Note on bit-exactness: the reference sums the 64 DCT terms in a scalar quad
loop; we use float64 einsum.  float64 rounding differences between summation
orders are ~1e-10 absolute while decisions happen at integer boundaries, so
disagreement requires a tie to within 1e-10 of an integer --- not observed on
any test corpus (asserted by tests/test_oracle_loops.py against a literal
quad-loop reimplementation).
"""
from __future__ import annotations

import numpy as np

from ..core import tables as T
from ..core.geometry import EncodeGeometry
from ..core.props import ImageProps, make_encode_props
from ..bitstream import writer
from ..bitstream.reader import ParsedJpeg, parse, split_entropy_segments

# --------------------------------------------------------------------------
# DCT basis
# --------------------------------------------------------------------------


def cos_table() -> np.ndarray:
    """COS[u, x] = cos((2x+1) u pi / 16), float64.

    Matches the reference's compile-time table layout
    (src/encoder/jpezy_encoder.hpp:271, cos_table[u*8+x]).
    """
    u = np.arange(8, dtype=np.float64)[:, None]
    x = np.arange(8, dtype=np.float64)[None, :]
    return np.cos((2.0 * x + 1.0) * u * np.pi / 16.0)


def dct_scale() -> np.ndarray:
    """SCALE[u, v] = cu * cv / 4 with c0 = 1/sqrt(2)."""
    c = np.ones(8, dtype=np.float64)
    c[0] = 1.0 / np.sqrt(2.0)
    return np.outer(c, c) / 4.0


_COS = cos_table()
_SCALE = dct_scale()


def trunc_int(x: np.ndarray) -> np.ndarray:
    """C `int()` cast: truncate toward zero."""
    return np.trunc(x).astype(np.int32)


def trunc_div(v: np.ndarray, q: np.ndarray) -> np.ndarray:
    """C integer division: truncates toward zero (jpezy_encoder.hpp:171)."""
    return (np.sign(v) * (np.abs(v) // q)).astype(np.int32)


def bit_length(v: np.ndarray) -> np.ndarray:
    """Magnitude category: number of bits in |v| (0 for v == 0).

    Matches the reference's shift-count loop (jpezy_encoder.hpp:183-185).
    """
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int32)


# --------------------------------------------------------------------------
# Forward path stages
# --------------------------------------------------------------------------


def rgb_to_ycc(r: np.ndarray, g: np.ndarray, b: np.ndarray):
    """BT.601 with C truncation; Y gets the -128 level shift inline.

    Expression order matches jpezy_encoder.hpp:245-256 exactly.
    """
    rf = r.astype(np.float64)
    gf = g.astype(np.float64)
    bf = b.astype(np.float64)
    y = trunc_int((0.2990 * rf) + (0.5870 * gf) + (0.1140 * bf) - 128.0)
    cb = trunc_int(-(0.1687 * rf) - (0.3313 * gf) + (0.5000 * bf))
    cr = trunc_int((0.5000 * rf) - (0.4187 * gf) - (0.0813 * bf))
    return y, cb, cr


def pad_replicate(plane: np.ndarray, ph: int, pw: int) -> np.ndarray:
    """Edge replication to (ph, pw) (jpezy_encoder.hpp:101,104)."""
    h, w = plane.shape
    return np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")


def blockify_luma(y: np.ndarray) -> np.ndarray:
    """[H16, W16] luma plane -> [nmcu*4, 64] blocks in MCU order TL,TR,BL,BR."""
    my, mx = y.shape[0] // 16, y.shape[1] // 16
    b = y.reshape(my, 2, 8, mx, 2, 8)
    b = b.transpose(0, 3, 1, 4, 2, 5)  # (my, mx, by, bx, y, x)
    return b.reshape(my * mx * 4, 64)


def blockify_chroma(c: np.ndarray) -> np.ndarray:
    """[H8, W8] chroma plane (already decimated) -> [nmcu, 64] blocks."""
    my, mx = c.shape[0] // 8, c.shape[1] // 8
    b = c.reshape(my, 8, mx, 8).transpose(0, 2, 1, 3)
    return b.reshape(my * mx, 64)


def _fwd_term_tables():
    """Per-term basis factors for the ordered-sum forward DCT.

    Term k (= y*8+x in the reference's loop order) of output (i, j):
      T_k = (pic[y,x] * COS[j,x]) * COS[i,y]    (jpezy_encoder.hpp:160)
    c1[k, ij] = COS[j, x_k], c2[k, ij] = COS[i, y_k].
    """
    c1 = np.zeros((64, 64), dtype=np.float64)
    c2 = np.zeros((64, 64), dtype=np.float64)
    for k in range(64):
        y, x = k // 8, k % 8
        for ij in range(64):
            i, j = ij // 8, ij % 8
            c1[k, ij] = _COS[j, x]
            c2[k, ij] = _COS[i, y]
    return c1, c2


_FWD_C1, _FWD_C2 = _fwd_term_tables()
_CU_J = np.where(np.arange(8) == 0, 1.0 / np.sqrt(2.0), 1.0)  # over columns j
_CV_I = _CU_J  # over rows i


def forward_dct(blocks: np.ndarray) -> np.ndarray:
    """[B, 64] int blocks -> [B, 64] int DCT coefficients (natural order).

    DCT_data[i*8+j] = int( sum * cu * cv / 4 ) with the 64 terms accumulated
    in the reference's exact (y, x) raster order and its exact operation
    order -- float64 summation-order ties flip ~2% of blocks by +-1 at the
    (i, j) in {0,4} coefficients (whose basis entries are +-1/8), so loop
    order is semantic, not cosmetic.  jpezy_encoder.hpp:146-166.
    """
    pic = blocks.reshape(-1, 64).astype(np.float64)
    B = pic.shape[0]
    s = np.zeros((B, 64), dtype=np.float64)
    for k in range(64):
        s += (pic[:, k : k + 1] * _FWD_C1[k][None, :]) * _FWD_C2[k][None, :]
    s = s.reshape(B, 8, 8)
    res = ((s * _CU_J[None, None, :]) * _CV_I[None, :, None]) / 4.0
    return trunc_int(res).reshape(B, 64)


def quantize(coeffs: np.ndarray, chroma: bool) -> np.ndarray:
    q = (T.C_QUANT if chroma else T.Y_QUANT)[None, :]
    return trunc_div(coeffs, q)


# --------------------------------------------------------------------------
# Entropy encode (vectorized emission -> (codes, lengths) streams)
# --------------------------------------------------------------------------

# Per-block emission slots: [dc_code, dc_extra] + 63*[zrl,zrl,zrl,code,extra] + [eob]
SLOTS_PER_BLOCK = 2 + 63 * 5 + 1


def encode_block_emissions(
    qblocks: np.ndarray, dc_pred_seq: np.ndarray, chroma: bool
) -> tuple[np.ndarray, np.ndarray]:
    """Emit (codes, lengths) per block in a fixed slot layout.

    qblocks: [B, 64] quantized coefficients, natural order.
    dc_pred_seq: [B] predictor (previous block's DC in sequence, 0 for first).
    Returns codes[B, SLOTS_PER_BLOCK] uint32, lengths[B, SLOTS_PER_BLOCK] int32.
    Slots with length 0 emit nothing.
    """
    B = qblocks.shape[0]
    dc_size_tb = T.C_DC_SIZE if chroma else T.Y_DC_SIZE
    dc_code_tb = T.C_DC_CODE if chroma else T.Y_DC_CODE
    ac_size_tb = T.C_AC_SIZE if chroma else T.Y_AC_SIZE
    ac_code_tb = T.C_AC_CODE if chroma else T.Y_AC_CODE
    zrl_size = int(ac_size_tb[T.ZRL_INDEX])
    zrl_code = int(ac_code_tb[T.ZRL_INDEX])
    eob_size = int(ac_size_tb[T.EOB_INDEX])
    eob_code = int(ac_code_tb[T.EOB_INDEX])

    codes = np.zeros((B, SLOTS_PER_BLOCK), dtype=np.uint32)
    lens = np.zeros((B, SLOTS_PER_BLOCK), dtype=np.int32)

    # ---- DC (jpezy_encoder.hpp:179-192)
    dc = qblocks[:, 0]
    diff = dc - dc_pred_seq
    s = bit_length(diff)
    codes[:, 0] = dc_code_tb[s]
    lens[:, 0] = dc_size_tb[s]
    extra = np.where(diff < 0, diff - 1, diff).astype(np.int64) & ((1 << s) - 1)
    codes[:, 1] = extra.astype(np.uint32)
    lens[:, 1] = s  # s == 0 -> nothing emitted

    # ---- AC (jpezy_encoder.hpp:194-224)
    zz = qblocks[:, T.ZIGZAG][:, 1:]  # [B, 63] zigzag positions 1..63
    nz = zz != 0
    pos = np.arange(1, 64, dtype=np.int32)[None, :]
    # previous nonzero zigzag position (0 = "DC", i.e. none)
    marked = np.where(nz, pos, 0)
    prev_incl = np.maximum.accumulate(marked, axis=1)
    prev_excl = np.concatenate(
        [np.zeros((B, 1), np.int32), prev_incl[:, :-1]], axis=1
    )
    run = pos - prev_excl - 1  # zeros between previous nonzero and here

    zrl_count = run >> 4
    rem = run & 15
    s_ac = bit_length(zz)
    idx = rem * 10 + s_ac + (rem == 15)

    ac_slot = slice(2, 2 + 63 * 5)
    acC = codes[:, ac_slot].reshape(B, 63, 5)
    acL = lens[:, ac_slot].reshape(B, 63, 5)
    # ZRL slots (while run > 15: emit ZRL; jpezy_encoder.hpp:198-201)
    for k in range(3):
        on = nz & (zrl_count > k)
        acC[:, :, k] = np.where(on, zrl_code, 0)
        acL[:, :, k] = np.where(on, zrl_size, 0)
    # symbol slot
    acC[:, :, 3] = np.where(nz, ac_code_tb[idx], 0)
    acL[:, :, 3] = np.where(nz, ac_size_tb[idx], 0)
    # extra bits slot (negative encoded as v-1, low s bits)
    v = zz.astype(np.int64)
    extra_ac = np.where(v < 0, v - 1, v) & ((1 << s_ac.astype(np.int64)) - 1)
    acC[:, :, 4] = np.where(nz, extra_ac, 0).astype(np.uint32)
    acL[:, :, 4] = np.where(nz, s_ac, 0)
    codes[:, ac_slot] = acC.reshape(B, 63 * 5)
    lens[:, ac_slot] = acL.reshape(B, 63 * 5)

    # EOB iff zigzag position 63 is zero (jpezy_encoder.hpp:219-220)
    eob = ~nz[:, -1]
    codes[:, -1] = np.where(eob, eob_code, 0)
    lens[:, -1] = np.where(eob, eob_size, 0)
    return codes, lens


def dc_predictors(dc: np.ndarray) -> np.ndarray:
    """Previous DC in sequence (0 for the first block)."""
    pred = np.empty_like(dc)
    pred[0] = 0
    pred[1:] = dc[:-1]
    return pred


def interleave_mcu(yv: np.ndarray, cbv: np.ndarray, crv: np.ndarray) -> np.ndarray:
    """Interleave per-component slot arrays into MCU emission order.

    yv: [nmcu*4, S], cbv/crv: [nmcu, S] -> [nmcu*6, S] ordered
    Y0 Y1 Y2 Y3 Cb Cr per MCU (jpezy_encoder.hpp:227-242).
    """
    nm = cbv.shape[0]
    S = yv.shape[1]
    out = np.concatenate(
        [yv.reshape(nm, 4, S), cbv.reshape(nm, 1, S), crv.reshape(nm, 1, S)],
        axis=1,
    )
    return out.reshape(nm * 6, S)


# --------------------------------------------------------------------------
# Full encode
# --------------------------------------------------------------------------


def segmented_dc_predictors(dc: np.ndarray, blocks_per_mcu: int,
                            restart_interval: int) -> np.ndarray:
    """Per-block DC predictor with resets at restart boundaries.

    The predictor chain restarts (to 0) at every restart_interval MCUs
    (T.81 F.2.1.3.1; reference decode analog jpezy_decoder.hpp:152-163).
    restart_interval == 0 means one unbroken chain.
    """
    pred = dc_predictors(dc)
    if restart_interval:
        seg = blocks_per_mcu * restart_interval
        pred[0::seg] = 0
    return pred


def encode(
    r: np.ndarray,
    g: np.ndarray,
    b: np.ndarray,
    props: ImageProps | None = None,
    *,
    gray: bool = False,
    restart_interval: int = 0,
) -> bytes:
    """Encode RGB planes [H, W] uint8 -> baseline JFIF bytes (4:2:0, Annex K).

    restart_interval > 0 is an extension beyond the reference (its encoder
    never emits DRI/RSTn, README.md:33): emits a DRI segment and RSTn markers
    every `restart_interval` MCUs, enabling parallel entropy decode.
    """
    h, w = r.shape
    if props is None:
        props = make_encode_props(w, h, gray=gray)
    geo = EncodeGeometry(width=w, height=h)

    y, cb, cr = rgb_to_ycc(r, g, b)
    y = pad_replicate(y, geo.padded_height, geo.padded_width)
    cb = pad_replicate(cb, geo.padded_height, geo.padded_width)
    cr = pad_replicate(cr, geo.padded_height, geo.padded_width)
    # 4:2:0 decimation: top-left of each 2x2 (jpezy_encoder.hpp:116-143)
    cb = cb[0::2, 0::2]
    cr = cr[0::2, 0::2]

    yb = blockify_luma(y)
    cbb = blockify_chroma(cb)
    crb = blockify_chroma(cr)
    if gray:
        # chroma blocks zeroed post color-convert (jpezy_encoder.hpp:61-64)
        cbb = np.zeros_like(cbb)
        crb = np.zeros_like(crb)

    yq = quantize(forward_dct(yb), chroma=False)
    cbq = quantize(forward_dct(cbb), chroma=True)
    crq = quantize(forward_dct(crb), chroma=True)

    ri = restart_interval
    y_codes, y_lens = encode_block_emissions(
        yq, segmented_dc_predictors(yq[:, 0], 4, ri), False)
    cb_codes, cb_lens = encode_block_emissions(
        cbq, segmented_dc_predictors(cbq[:, 0], 1, ri), True)
    cr_codes, cr_lens = encode_block_emissions(
        crq, segmented_dc_predictors(crq[:, 0], 1, ri), True)

    codes = interleave_mcu(y_codes, cb_codes, cr_codes)  # [nmcu*6, S]
    lens = interleave_mcu(y_lens, cb_lens, cr_lens)

    header = writer.write_header(props, restart_interval=ri)
    if ri:
        n_mcus = geo.num_mcus
        entropy = bytearray()
        seg_blocks = 6 * ri
        nseg = (n_mcus + ri - 1) // ri
        for s in range(nseg):
            sl = slice(s * seg_blocks, (s + 1) * seg_blocks)
            packed, _ = writer.pack_bits(
                codes[sl].reshape(-1), lens[sl].reshape(-1))
            entropy += writer.byte_stuff(packed)
            if s != nseg - 1:
                entropy += bytes([0xFF, 0xD0 + (s % 8)])  # RSTn
        return header + bytes(entropy) + writer.EOI
    packed, _ = writer.pack_bits(codes.reshape(-1), lens.reshape(-1))
    return writer.assemble(header, packed)


# --------------------------------------------------------------------------
# Decode
# --------------------------------------------------------------------------


def _huff_lut(tbl) -> np.ndarray:
    """Build a 2^16 lookup: 16-bit window -> (value << 8) | code_length.

    Replaces the reference's bit-by-bit canonical walk
    (jpezy_decoder.hpp:626-642) with a table-driven decode.
    """
    lut = np.full(1 << 16, -1, dtype=np.int32)
    for size, code, value in zip(tbl.sizes, tbl.codes, tbl.values):
        size = int(size)
        code = int(code)
        lo = code << (16 - size)
        hi = lo + (1 << (16 - size))
        lut[lo:hi] = (int(value) << 8) | size
    return lut


class _BitReader:
    """MSB-first bit reader over de-stuffed entropy bytes."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
        # pad so 16-bit peeks never run off the end (1-padding like T.81)
        self.bits = np.concatenate([self.bits, np.ones(32, dtype=np.uint8)])
        self.n = len(data) * 8
        self.pos = 0
        self._w16 = (1 << np.arange(15, -1, -1)).astype(np.int64)

    def peek16(self) -> int:
        return int(self.bits[self.pos : self.pos + 16] @ self._w16)

    def read(self, n: int) -> int:
        v = int(self.bits[self.pos : self.pos + n] @ self._w16[16 - n :])
        self.pos += n
        return v

    def exhausted(self) -> bool:
        return self.pos >= self.n


def receive_extend(v: int, s: int) -> int:
    """Sign-extend s extra bits (jpezy_decoder.hpp:590-592)."""
    if s and not (v & (1 << (s - 1))):
        v -= (1 << s) - 1
    return v


def decode_segment_blocks(
    br: _BitReader,
    n_mcus: int,
    comp_order: list[tuple[int, int]],  # (component index, blocks in MCU)
    dc_lut: list[np.ndarray],
    ac_lut: list[np.ndarray],
    pred: np.ndarray,
    out: list[list[np.ndarray]],
) -> None:
    """Serial Huffman decode of one entropy segment (between restarts)."""
    for _ in range(n_mcus):
        for sc, nblocks in comp_order:
            dlut, alut = dc_lut[sc], ac_lut[sc]
            for _ in range(nblocks):
                blk = np.zeros(64, dtype=np.int32)
                # DC
                e = int(dlut[br.peek16()])
                if e < 0:
                    raise ValueError("bad DC huffman code")
                cat = e >> 8
                br.pos += e & 0xFF
                if cat:
                    blk[0] = receive_extend(br.read(cat), cat)
                pred[sc] += blk[0]
                blk[0] = pred[sc]
                # AC
                k = 1
                while k < 64:
                    e = int(alut[br.peek16()])
                    if e < 0:
                        raise ValueError("bad AC huffman code")
                    rs = e >> 8
                    br.pos += e & 0xFF
                    run, s = rs >> 4, rs & 0x0F
                    if s == 0:
                        if run == 15:
                            k += 16  # ZRL
                            continue
                        break  # EOB
                    k += run
                    if k > 63:
                        raise ValueError("AC run overflow")
                    blk[T.ZIGZAG[k]] = receive_extend(br.read(s), s)
                    k += 1
                out[sc].append(blk)


def _inv_term_tables():
    """Per-term factors for the ordered-sum IDCT.

    Term k (= v*8+u, the reference's v-outer/u-inner order) of output (y, x):
      T_k = (((cu*cv) * dct[v,u]) * COS[u,x]) * COS[v,y]
    (jpezy_decoder.hpp:664).  cucv[k] = fl(cu * cv); c1[k, yx] = COS[u, x];
    c2[k, yx] = COS[v, y].
    """
    disqrt2 = 1.0 / np.sqrt(2.0)
    cucv = np.zeros(64, dtype=np.float64)
    c1 = np.zeros((64, 64), dtype=np.float64)
    c2 = np.zeros((64, 64), dtype=np.float64)
    for k in range(64):
        v, u = k // 8, k % 8
        cu = disqrt2 if u == 0 else 1.0
        cv = disqrt2 if v == 0 else 1.0
        cucv[k] = cu * cv
        for yx in range(64):
            y, x = yx // 8, yx % 8
            c1[k, yx] = _COS[u, x]
            c2[k, yx] = _COS[v, y]
    return cucv, c1, c2


_INV_CUCV, _INV_C1, _INV_C2 = _inv_term_tables()


def inverse_dct(coeffs: np.ndarray, level_shift: int = 128) -> np.ndarray:
    """[B, 64] dequantized coefficients -> [B, 64] int spatial samples.

    block[y*8+x] = int(sum/4 + sl) with the reference's exact term and
    accumulation order (v outer, u inner; jpezy_decoder.hpp:652-670) --
    required for bit-exact decode (see forward_dct note on float64 ties).
    """
    d = coeffs.reshape(-1, 64).astype(np.float64)
    B = d.shape[0]
    s = np.zeros((B, 64), dtype=np.float64)
    for k in range(64):
        s += ((_INV_CUCV[k] * d[:, k : k + 1]) * _INV_C1[k][None, :]) \
            * _INV_C2[k][None, :]
    return trunc_int(s / 4.0 + level_shift).reshape(B, 64)


def deblockify(blocks: np.ndarray, mcus_y: int, mcus_x: int, v: int, h: int) -> np.ndarray:
    """[B, 64] blocks in MCU order -> component plane [mcus_y*v*8, mcus_x*h*8].

    Within each MCU the v*h blocks are in raster order
    (jpezy_decoder.hpp:513-514).
    """
    b = blocks.reshape(mcus_y, mcus_x, v, h, 8, 8)
    b = b.transpose(0, 2, 4, 1, 3, 5)
    return b.reshape(mcus_y * v * 8, mcus_x * h * 8)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray):
    """Inverse BT.601 with clamp (jpezy_decoder.hpp:567-578, 672-676)."""
    yf = y.astype(np.float64)
    cbf = cb.astype(np.float64)
    crf = cr.astype(np.float64)
    r = yf + (crf - 0x80) * 1.4020
    g = yf - (cbf - 0x80) * 0.3441 - (crf - 0x80) * 0.7139
    b = yf + (cbf - 0x80) * 1.7718
    return tuple(
        np.clip(np.trunc(v), 0, 255).astype(np.uint8) for v in (r, g, b)
    )


def decode(data: bytes, *, gray: bool = False) -> tuple[np.ndarray, np.ndarray, np.ndarray, ImageProps]:
    """Decode baseline JPEG bytes -> (r, g, b) planes [H, W] uint8 + props."""
    pj = parse(data)
    props = pj.props
    hmax, vmax = pj.hmax, pj.vmax
    from ..core.geometry import ComponentGeometry

    geos = [
        ComponentGeometry(fc.H, fc.V, hmax, vmax, props.width, props.height)
        for fc in pj.frame_components
    ]
    mcus_x, mcus_y = geos[0].mcus_x, geos[0].mcus_y

    dc_lut = [_huff_lut(pj.huff[0][sc.Td]) for sc in pj.scan_components]
    ac_lut = [_huff_lut(pj.huff[1][sc.Ta]) for sc in pj.scan_components]
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
        br = _BitReader(seg)
        decode_segment_blocks(br, todo, comp_order, dc_lut, ac_lut, pred, out)
        done += todo
        pred[:] = 0  # predictors reset at restart (jpezy_decoder.hpp:152-163)
    if done < n_total:
        raise ValueError("truncated entropy data")

    ncomp = len(pj.frame_components)
    planes = []
    for i in range(ncomp):
        blocks = np.stack(out[i])
        q = pj.quant[pj.frame_components[i].Tq][None, :]
        deq = blocks * q
        level = 128 if props.sample_precision == 8 else 2048
        spat = inverse_dct(deq, level)
        plane = deblockify(
            spat, mcus_y, mcus_x, pj.frame_components[i].V, pj.frame_components[i].H
        )
        # nearest-neighbor upsample to MCU resolution (jpezy_decoder.hpp:519-524)
        plane = plane.repeat(geos[i].dup_y, axis=0).repeat(geos[i].dup_x, axis=1)
        planes.append(plane)

    H, W = props.height, props.width
    ymat = planes[0][:H, :W]
    if gray or ncomp == 1:
        if ncomp == 1 or gray:
            gval = np.clip(np.trunc(ymat.astype(np.float64)), 0, 255).astype(np.uint8)
        if ncomp == 1 and not gray:
            # 1-component decode in color mode: chroma = 0x80 -> gray anyway
            # (reference fills chroma planes with 0x80, jpezy_decoder.hpp:103-105)
            return gval, gval, gval, props
        return gval, gval, gval, props
    cbm = planes[1][:H, :W]
    crm = planes[2][:H, :W]
    r, g, b = ycc_to_rgb(ymat, cbm, crm)
    return r, g, b, props
