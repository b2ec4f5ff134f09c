"""The device Huffman decode of jpezy_tpu_torch (ops/entropy_decode.py and
the `device` and `indexed` decode transports) against jpezy_tpu and
against the host C++ frontend.

The path is integer-exact up to the dequantized coefficients: LUTs, the
decoded blocks and the corruption flags must equal the JAX package's
decode_segments (LUT mode) and the host frontend exactly (tolerance 0).
The planes then go through the float32 IDCT, the same operation on the
same values as the port's ycc420 transport, so the transports' pixels are
equal exactly; against the JAX package the IDCT's summation order differs,
and the documented envelope is +-1 on the u8 planes (+-2 after the colour
tail).

One known divergence of jpezy_tpu is not copied: its scan flags a ZRL at
zigzag index 48, which ends the block exactly and is valid.  That case is
held against the host frontend only.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jpezy_tpu.codec import jax_codec as JC
from jpezy_tpu.ops import entropy_decode as JD
from jpezy_tpu_torch.bitstream import writer
from jpezy_tpu_torch.bitstream.reader import JpegFormatError, parse
from jpezy_tpu_torch.codec import host_codec
from jpezy_tpu_torch.codec import host_glue as HG
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.core import tables as T
from jpezy_tpu_torch.core.props import make_encode_props
from jpezy_tpu_torch.ops import entropy_decode as ED
from jpezy_tpu_torch.runtime import native

from test_torch_host_copies import host_runtime  # noqa: F401 (autouse)

CPU = "cpu"


def _img(h, w, seed):
    from imagegen import make_test_image

    return make_test_image(h, w, seed=seed)


def _host_encode(img, **kw):
    return host_codec.encode(img[..., 0], img[..., 1], img[..., 2], **kw)


def _nmcu(pj):
    return ((pj.props.height + 15) // 16) * ((pj.props.width + 15) // 16)


def _segments(streams):
    """Restart streams -> (pjs, words u32 [S, Lw], nblk, rawlen, ri, nseg),
    as the device transport's host frontend makes them."""
    pjs = [parse(s) for s in streams]
    ri, nmcu = pjs[0].restart_interval, _nmcu(pjs[0])
    nseg = -(-nmcu // ri)
    words, nblk, rawlen = HG._device_host_frontend(pjs, nmcu, ri, nseg)
    return pjs, words, nblk, rawlen, ri, nseg


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _plain(words, nblk, lut, tsel=None, rawlen=None, skip0=None, preds0=None,
           *, max_blocks):
    opt = [None if a is None else _t(a) for a in (tsel, rawlen, skip0, preds0)]
    blocks, bad = ED.decode_segments(ED.words_tensor(words), _t(nblk),
                                     _t(lut), *opt, max_blocks=max_blocks)
    assert blocks.dtype == torch.int16 and bad.dtype == torch.bool
    return blocks.numpy(), bad.numpy()


def _jax(words, nblk, lut, tsel=None, rawlen=None, skip0=None, preds0=None,
         *, max_blocks):
    opt = [None if a is None else jnp.asarray(a)
           for a in (tsel, rawlen, skip0, preds0)]
    blocks, bad = JD.decode_segments(jnp.asarray(words), jnp.asarray(nblk),
                                     jnp.asarray(lut), *opt,
                                     max_blocks=max_blocks)
    return np.asarray(blocks), np.asarray(bad)


def _comps(blocks, nmcu):
    """[S, ri*6, 64] lane blocks of ONE image -> per-component blocks."""
    b6 = blocks.reshape(-1, 6, 64)[:nmcu]
    return [b6[:, :4].reshape(nmcu * 4, 64), b6[:, 4], b6[:, 5]]


@pytest.fixture(scope="module")
def restart2():
    """Three 64x64 restart streams (ri=2, standard tables)."""
    batch = np.stack([_img(64, 64, 150 + i) for i in range(3)])
    return batch, TC.encode_batch(batch, restart_interval=2, device=CPU)


@pytest.fixture(scope="module")
def plain3():
    """Three 64x64 restart-free streams."""
    batch = np.stack([_img(64, 64, 160 + i) for i in range(3)])
    return batch, TC.encode_batch(batch, device=CPU)


class TestTables:
    @pytest.mark.parametrize("optimize", [False, True],
                             ids=["annexk", "optimized"])
    def test_build_decode_lut_equals_jax(self, optimize):
        pj = parse(_host_encode(_img(48, 64, 3), optimize=optimize,
                                restart_interval=2))
        for sc in (None, pj.scan_components):
            got = ED.build_decode_lut(pj.huff, sc)
            assert got.dtype == np.int32 and got.shape == (6, 65536)
            assert np.array_equal(got, JD.build_decode_lut(pj.huff, sc))
            assert (ED.lut_content_key(pj.huff, sc)
                    == JD.lut_content_key(pj.huff, sc))

    def test_needs_three_components(self):
        pj = parse(_host_encode(_img(32, 32, 4)))
        with pytest.raises(ValueError, match="3 scan components"):
            ED.build_decode_lut(pj.huff, pj.scan_components[:1])

    def test_device_lut_cached_by_content(self):
        a = parse(_host_encode(_img(32, 32, 5)))
        b = parse(_host_encode(_img(32, 32, 6), optimize=True))
        la, lb = ED.build_decode_lut(a.huff), ED.build_decode_lut(b.huff)
        ta = ED.device_lut(la[None], CPU)
        assert ED.device_lut(la[None].copy(), CPU) is ta
        tb = ED.device_lut(lb[None], CPU)
        assert tb is not ta and np.array_equal(tb.numpy()[0], lb)
        for i in range(ED._LUT_CACHE_SIZE + 2):   # the cache stays bounded
            ED.device_lut(np.full((1, 6, 65536), i, np.int32), CPU)
        assert len(ED._lut_cache) == ED._LUT_CACHE_SIZE

    def test_words_tensor_keeps_bit_patterns(self):
        w = np.array([[0, 2**31 - 1, 2**31, 2**32 - 1]], np.uint32)
        t = ED.words_tensor(w)
        assert t.dtype == torch.int32
        assert np.array_equal(t.numpy().view(np.uint32), w)

    def test_device_luts_copy(self, restart2):
        std = restart2[1]
        opt = [_host_encode(im, optimize=True, restart_interval=2)
               for im in restart2[0]]
        pjs = [parse(s) for s in (std[0], opt[1], std[2], opt[1])]
        got_lut, got_sel = HG._device_luts(pjs, 8)
        ref_lut, ref_sel = JC._device_luts(pjs, 8)      # LUT mode on the CPU
        assert got_lut.shape == (2, 6, 65536)
        assert np.array_equal(got_lut, ref_lut)
        assert np.array_equal(got_sel, ref_sel)


def _table(bits, vals):
    """A parsed-DHT table from BITS counts and HUFFVAL."""
    from jpezy_tpu_torch.bitstream.reader import HuffTable

    sizes, codes = T.build_canonical_codes(bytes(bits))
    return HuffTable(sizes, codes, np.frombuffer(bytes(vals), np.uint8)
                     .astype(np.int32))


def _optimal_lut(seed):
    """[6, 65536] LUT of optimal tables for seeded symbol histograms, a
    different pair of tables per component."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(3):
        dc_freq = np.zeros(256, np.int64)
        dc_freq[:12] = rng.integers(0, 1000, 12) ** 2
        dc_freq[int(rng.integers(0, 12))] += 1
        ac_freq = np.zeros(256, np.int64)
        syms = [r << 4 | s for r in range(16) for s in range(1, 11)]
        ac_freq[syms] = (rng.pareto(0.7, len(syms)) * 50).astype(np.int64)
        ac_freq[[0x00, 0xF0]] = rng.integers(1, 5000, 2)
        (dcb, dcv), (acb, acv), *_ = T.optimal_flat_tables(dc_freq, ac_freq)
        rows += [native._huff_lut(_table(dcb, dcv)),
                 native._huff_lut(_table(acb, acv))]
    return np.stack(rows)


def _long_code_lut():
    """[6, 65536] hand-built LUT: rows with 16-bit codes, with unused
    prefixes (-1 windows), with codes one bit shorter and one bit longer
    than the first-level index, and one row whose codes are all 16 bits
    long, which the first-level table cannot answer at all."""
    from jpezy_tpu_torch.bitstream.reader import HuffTable

    def lut(entries):
        sizes, codes, vals = (np.array(x, np.int32) for x in zip(*entries))
        return native._huff_lut(HuffTable(sizes, codes, vals))

    mixed = [(1, 0b0, 0x01), (9, 0b100000000, 0x12), (10, 0b1000000010, 0x23),
             (11, 0b10000000110, 0x34), (16, 0x8100, 0xF0), (16, 0x8101, 0xFA),
             (16, 0xFFFE, 0x00), (12, 0xC00, 0x45)]
    only16 = [(16, c, v) for c, v in ((0x0000, 0x00), (0x0001, 0x11),
                                      (0x7FFF, 0xF0), (0x8000, 0xA5),
                                      (0xFFFF, 0xFF))]
    sparse = [(3, 0b101, 0x05), (16, 0x0400, 0x77), (11, 0b11100000001, 0x0B)]
    return np.stack([lut(mixed), lut(only16), lut(sparse), lut(mixed[::2]),
                     lut(only16[1:]), np.full(65536, -1, np.int32)])


def _two_level_lookup(lut, first, bits):
    """What the scan kernel reads for each of the 65,536 windows of each
    row: the first-level entry of the window's prefix where it is nonzero,
    else the LUT's own entry."""
    short = first[..., np.arange(65536) >> (16 - bits)].astype(np.int32)
    return np.where(short != 0, short, lut)


class TestFirstLevelTable:
    """The rule the scan kernel builds its shared-memory table by: for each
    of the 65,536 windows of all 6 rows the two-level lookup must equal the
    full LUT, exactly."""

    @pytest.mark.parametrize("bits", [8, 9, 10, 11])
    @pytest.mark.parametrize("source", ["annexk", "optimal-0", "optimal-1",
                                        "optimal-2", "optimal-3", "long"])
    def test_two_level_lookup_equals_lut(self, source, bits):
        if source == "annexk":
            lut = np.stack([native._huff_lut(t) for t in _annexk_tables()])
        elif source == "long":
            lut = _long_code_lut()
            assert (lut == -1).any() and ((lut & 0xFF) == 16).any()
        else:
            lut = _optimal_lut(int(source[-1]))
        first = ED.first_level_table(lut, bits)
        assert first.dtype == np.uint16 and first.shape == (6, 1 << bits)
        assert np.array_equal(_two_level_lookup(lut, first, bits), lut)
        # it answers exactly the windows whose code has at most `bits` bits
        answered = first[:, np.arange(65536) >> (16 - bits)] != 0
        assert np.array_equal(answered, (lut >= 0) & ((lut & 0xFF) <= bits))
        if source == "long":
            assert not first[1].any() and not first[5].any()
        else:
            assert answered.mean() > 0.9

    def test_batched_table_sets(self):
        lut = np.stack([_optimal_lut(7), _long_code_lut()])
        first = ED.first_level_table(lut)
        assert first.shape == (2, 6, 1 << ED.FIRST_LEVEL_BITS)
        assert np.array_equal(_two_level_lookup(lut, first, ED.FIRST_LEVEL_BITS), lut)

    def test_wide_entries_are_left_to_the_lut(self):
        """An entry that does not fit 16 bits, or has length 0, is never
        answered by the first level (no prefix code's LUT holds one)."""
        lut = np.full((6, 65536), (300 << 8) | 4, np.int32)
        lut[1] = 0
        lut[2] = 4
        first = ED.first_level_table(lut)
        assert not first[0].any() and not first[1].any() and first[2].all()
        assert np.array_equal(_two_level_lookup(lut, first, ED.FIRST_LEVEL_BITS), lut)


class TestDecodeSegmentsPlain:
    """decode_segments on CPU tensors (the plain version) against the JAX
    scan and the host C++ frontend."""

    @pytest.mark.parametrize("ri,hw,seed", [
        (2, (64, 48), 0), (4, (64, 80), 1), (3, (48, 48), 2),
    ])
    def test_blocks_bitexact_vs_jax_and_host(self, ri, hw, seed):
        data = TC.encode_batch(_img(*hw, seed)[None], restart_interval=ri,
                               device=CPU)
        pjs, words, nblk, rawlen, ri, nseg = _segments(data)
        lut = ED.build_decode_lut(pjs[0].huff)
        tsel = np.zeros(nseg, np.int32)
        blocks, bad = _plain(words, nblk, lut, tsel, rawlen, max_blocks=ri * 6)
        ref, ref_bad = _jax(words, nblk, lut, tsel, rawlen, max_blocks=ri * 6)
        assert not bad.any() and not ref_bad.any()
        assert np.array_equal(blocks, ref)
        nmcu = _nmcu(pjs[0])
        host = native.entropy_decode(pjs[0], nmcu)
        for c, got in enumerate(_comps(blocks, nmcu)):
            assert np.array_equal(got, host[c]), f"component {c}"

    def test_noise_wide_coefficients(self):
        rng = np.random.default_rng(7)
        img = rng.integers(0, 256, (64, 64, 3), np.uint8)
        data = TC.encode_batch(img[None], restart_interval=1, quality=95,
                               device=CPU)
        pjs, words, nblk, rawlen, ri, nseg = _segments(data)
        lut = ED.build_decode_lut(pjs[0].huff)
        blocks, bad = _plain(words, nblk, lut, None, rawlen, max_blocks=6)
        ref, ref_bad = _jax(words, nblk, lut, None, rawlen, max_blocks=6)
        assert not bad.any()
        assert np.array_equal(blocks, ref)
        assert np.abs(blocks.astype(int)).max() > 127
        host = native.entropy_decode(pjs[0], 16)
        for c, got in enumerate(_comps(blocks, 16)):
            assert np.array_equal(got, host[c]), f"component {c}"

    def test_edge_case_blocks_roundtrip(self):
        """entropy.edge_case_blocks (ZRL runs, a nonzero at zigzag 63,
        category edges, dense blocks) encoded into one segment of luma
        blocks and decoded again."""
        from jpezy_tpu_torch.bitstream.splice import splice_blocks
        from jpezy_tpu_torch.ops import entropy as TE

        q = TE.edge_case_blocks(8)
        q = q[: (q.shape[0] // 6) * 6]
        qt = torch.from_numpy(q)
        # slots 4 and 5 of each group of six are Cb and Cr: own chains
        nb = q.shape[0]
        slot = np.arange(nb) % 6
        comp = np.where(slot < 4, 0, slot - 3)
        pred = np.zeros(nb, np.int32)
        last = [0, 0, 0]
        for i in range(nb):
            pred[i] = last[comp[i]]
            last[comp[i]] = q[i, 0]
        wy, by = TE.encode_block_words(qt, torch.from_numpy(pred), False)
        wc, bc = TE.encode_block_words(qt, torch.from_numpy(pred), True)
        chroma = torch.from_numpy(comp > 0)
        w = torch.where(chroma[:, None], wc, wy).numpy().astype(np.uint32)
        b = torch.where(chroma, bc, by).numpy().astype(np.int32)
        raw, total = splice_blocks(w, b)
        row = np.zeros((1, (len(raw) + 8 + 3) // 4 * 4), np.uint8)
        row[0, :len(raw)] = np.frombuffer(raw, np.uint8)
        words = row.view(">u4").astype("=u4")
        lut = np.stack([native._huff_lut(t) for t in _annexk_tables()])
        blocks, bad = _plain(words, np.array([nb]), lut, None,
                             np.array([len(raw)]), max_blocks=nb)
        assert not bad.any()
        assert np.array_equal(blocks[0], q.astype(np.int16))

    def test_tail_segment_blocks_stay_zero(self):
        data = TC.encode_batch(_img(48, 80, 9)[None], restart_interval=4,
                               device=CPU)               # 15 MCUs
        pjs, words, nblk, rawlen, ri, nseg = _segments(data)
        assert nblk[-1] == 18
        blocks, bad = _plain(words, nblk, ED.build_decode_lut(pjs[0].huff),
                             None, rawlen, max_blocks=24)
        assert not bad.any() and not blocks[-1, 18:].any()
        assert blocks[-1, :18].any()

    def test_indexed_lanes_skip0_preds0(self, plain3):
        """Pseudo-segments of restart-free streams: per-lane bit phase and
        DC predictors, against the JAX scan and the host frontend."""
        pjs = [parse(s) for s in plain3[1]]
        words, nblk, skip0, preds0 = HG._indexed_host_frontend(pjs, 16, 3, 6)
        assert skip0.any() and preds0.any()
        lut = ED.build_decode_lut(pjs[0].huff)
        blocks, bad = _plain(words, nblk, lut, None, None, skip0, preds0,
                             max_blocks=18)
        ref, ref_bad = _jax(words, nblk, lut, None, None, skip0, preds0,
                            max_blocks=18)
        assert not bad.any() and not ref_bad.any()
        assert np.array_equal(blocks, ref)
        for i, pj in enumerate(pjs):
            host = native.entropy_decode(pj, 16)
            for c, got in enumerate(_comps(blocks[i * 6:(i + 1) * 6], 16)):
                assert np.array_equal(got, host[c]), (i, c)

    def test_per_lane_table_select(self, restart2):
        batch, std = restart2
        opt = [_host_encode(im, optimize=True, restart_interval=2)
               for im in batch]
        mixed = [std[0], opt[1], opt[2]]
        pjs, words, nblk, rawlen, ri, nseg = _segments(mixed)
        lut, tsel = HG._device_luts(pjs, nseg)
        assert lut.shape[0] == 3
        blocks, bad = _plain(words, nblk, lut, tsel, rawlen, max_blocks=12)
        ref, ref_bad = _jax(words, nblk, lut, tsel, rawlen, max_blocks=12)
        assert not bad.any() and not ref_bad.any()
        assert np.array_equal(blocks, ref)
        # the wrong table set derails the optimized streams' lanes
        _, bad0 = _plain(words, nblk, lut, np.zeros_like(tsel), rawlen,
                         max_blocks=12)
        assert bad0[nseg:].any() and not bad0[:nseg].any()
        # a table-set index outside the LUT flags the lane
        off = tsel.copy()
        off[0], off[1] = 3, -1
        _, bad1 = _plain(words, nblk, lut, off, rawlen, max_blocks=12)
        assert bad1[0] and bad1[1] and not bad1[2:nseg].any()

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_corrupt_lanes_equal_jax(self, restart2, seed):
        """Bit flips, zeroed, all-ones and truncated rows: the lanes end,
        and blocks and flags equal the JAX scan's (same shapes as the
        per-lane table test, so the JAX program is compiled once)."""
        pjs, words, nblk, rawlen, ri, nseg = _segments(restart2[1])
        lut, tsel = HG._device_luts(pjs, nseg)
        lut = np.concatenate([lut] * 3)[:3]
        words = ED.corrupt_rows(words, rawlen, seed)
        blocks, bad = _plain(words, nblk, lut, tsel, rawlen, max_blocks=12)
        ref, ref_bad = _jax(words, nblk, lut, tsel, rawlen, max_blocks=12)
        assert bad.any() and not bad.all()
        assert np.array_equal(bad, ref_bad)
        assert np.array_equal(blocks, ref)

    def test_all_windows_invalid_terminates(self):
        rng = np.random.default_rng(3)
        words = rng.integers(0, 2**32, (8, 16), np.uint64).astype(np.uint32)
        lut = np.full((6, 65536), -1, np.int32)
        nblk = np.full(8, 6, np.int32)
        blocks, bad = _plain(words, nblk, lut, max_blocks=6)
        ref, ref_bad = _jax(words, nblk, lut, max_blocks=6)
        assert blocks.shape == (8, 6, 64) and bad.all()
        assert np.array_equal(blocks, ref) and np.array_equal(bad, ref_bad)

    def test_wide_dc_symbol_flags_lane(self):
        """A DC symbol above 15 (no baseline table has one) flags the lane
        and is read as category 0; the lane still ends."""
        lut = np.full((6, 65536), (200 << 8) | 4, np.int32)
        lut[1::2] = 4                             # every AC window: an EOB
        words = np.zeros((2, 8), np.uint32)
        blocks, bad = _plain(words, np.array([6, 0]), lut, max_blocks=6)
        assert bad[0] and not bad[1] and not blocks.any()

    def test_cpu_tensors_launch_nothing(self, restart2):
        from jpezy_tpu_torch.ops import scan_cuda

        before = scan_cuda.launches
        pjs, words, nblk, rawlen, ri, nseg = _segments(restart2[1][:1])
        lut = ED.build_decode_lut(pjs[0].huff)
        a = _plain(words, nblk, lut, None, rawlen, max_blocks=12)
        b = ED.decode_segments_plain(ED.words_tensor(words), _t(nblk),
                                     _t(lut), None, _t(rawlen), max_blocks=12)
        assert np.array_equal(a[0], b[0].numpy())
        assert scan_cuda.launches == before
        assert scan_cuda.LIB.handle is None    # nothing was built or loaded

    def test_meta_device_raises(self):
        w = torch.zeros((2, 8), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            ED.decode_segments(w, w[:, 0], w, max_blocks=6)


def _annexk_tables():
    """The six (component, DC/AC) Huffman tables of the standard
    assignment, as the parser holds them."""
    pj = parse(_host_encode(_img(16, 16, 1)))
    return [pj.huff[cls][tid] for tid in (0, 1, 1) for cls in (0, 1)]


def _zrl_stream(run: int) -> bytes:
    """A 16x16 restart-free stream whose first luma block is: DC 0, two
    ZRLs, a +1 after `run` more zeros (zigzag index 33 + run), then a ZRL
    in place of the EOB.  run=14 puts that ZRL at index 48, where its 16
    zeros end the block exactly; run=15 at 49, one past."""
    codes, lens = [], []

    def emit(code, n):
        codes.append(int(code))
        lens.append(int(n))

    emit(T.Y_DC_CODE[0], T.Y_DC_SIZE[0])
    for _ in range(2):
        emit(T.Y_AC_CODE[T.ZRL_INDEX], T.Y_AC_SIZE[T.ZRL_INDEX])
    idx = T.ac_symbol_index(run, 1)
    emit(T.Y_AC_CODE[idx], T.Y_AC_SIZE[idx])
    emit(1, 1)                                         # +1
    emit(T.Y_AC_CODE[T.ZRL_INDEX], T.Y_AC_SIZE[T.ZRL_INDEX])
    for _ in range(3):
        emit(T.Y_DC_CODE[0], T.Y_DC_SIZE[0])
        emit(T.Y_AC_CODE[T.EOB_INDEX], T.Y_AC_SIZE[T.EOB_INDEX])
    for _ in range(2):
        emit(T.C_DC_CODE[0], T.C_DC_SIZE[0])
        emit(T.C_AC_CODE[T.EOB_INDEX], T.C_AC_SIZE[T.EOB_INDEX])
    packed, _ = writer.pack_bits(np.array(codes), np.array(lens))
    return writer.assemble(writer.write_header(make_encode_props(16, 16)),
                           packed)


class TestZrlAtBlockEnd:
    """The port's bound is the reference decoder's, kk + 15 > 63; held
    against the host C++ frontend (the JAX scan flags index 48 too)."""

    def _lane(self, stream):
        pj = parse(stream)
        words, nblk, skip0, preds0 = HG._indexed_host_frontend([pj], 1, 8, 1)
        return _plain(words, nblk, ED.build_decode_lut(pj.huff), None, None,
                      skip0, preds0, max_blocks=48)

    def test_zrl_at_48_is_valid(self):
        stream = _zrl_stream(14)
        blocks, bad = self._lane(stream)
        assert not bad.any()
        host = native.entropy_decode(parse(stream), 1)
        for c, got in enumerate(_comps(blocks[0, :6], 1)):
            assert np.array_equal(got, host[c])
        assert blocks[0, 0, T.ZIGZAG[47]] == 1
        assert np.count_nonzero(blocks) == 1
        a, _ = TC.decode_batch([stream], transport="indexed", device=CPU)
        b, _ = TC.decode_batch([stream], transport="ycc420", device=CPU)
        assert np.array_equal(a, b)

    def test_zrl_at_49_is_flagged(self):
        stream = _zrl_stream(15)
        blocks, bad = self._lane(stream)
        assert bad.all()
        assert blocks[0, 0, T.ZIGZAG[48]] == 1
        with pytest.raises(ValueError, match="corrupt"):
            TC.decode_batch([stream], transport="indexed", device=CPU)


class TestDeviceTransport:
    def test_pixels_equal_ycc420_exactly(self, restart2):
        a, props = TC.decode_batch(restart2[1], transport="device",
                                   device=CPU)
        b, _ = TC.decode_batch(restart2[1], transport="ycc420", device=CPU)
        assert a.shape == (3, 64, 64, 3) and a.dtype == np.uint8
        assert (props.width, props.height) == (64, 64)
        assert np.array_equal(a, b)

    def test_planes_within_one_of_jax(self, restart2):
        pjs, words, nblk, rawlen, ri, nseg = _segments(restart2[1])
        lut, tsel = HG._device_luts(pjs, nseg)
        _, geom, level = TC._parse_batch(restart2[1], gray=False,
                                         precision="fast", transport="device")
        qarr = HG._quant_arr(pjs)
        assert np.array_equal(qarr, JC._quant_arr(pjs))
        kw = dict(N=3, nseg=nseg, ri=ri, geom=geom, level=level)
        got = TC._decode_fused_batch_device(
            ED.words_tensor(words), _t(nblk), _t(lut), _t(tsel), _t(rawlen),
            _t(qarr), **kw).numpy()
        ref = np.asarray(JC._decode_fused_batch_device(
            jnp.asarray(words), jnp.asarray(nblk), jnp.asarray(lut),
            jnp.asarray(tsel), jnp.asarray(rawlen), jnp.asarray(qarr), **kw))
        assert got.shape == ref.shape == (3, 64 * 64 * 3 // 2 + 1)
        assert not got[:, -1].any() and not ref[:, -1].any()
        diff = np.abs(got.astype(int) - ref.astype(int))
        # observed on these images: identical planes
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01

    def test_rgb_within_two_of_jax(self, restart2):
        got, _ = TC.decode_batch(restart2[1], device=CPU)
        ref, _ = JC.decode_batch(restart2[1], transport="device")
        diff = np.abs(got.astype(int) - ref.astype(int))
        assert diff.max() <= 2 and (diff > 0).mean() <= 0.01

    @pytest.mark.parametrize("hw,ri,seed", [
        ((48, 80), 4, 9), ((32, 48), 1, 10), ((80, 32), 5, 11),
        ((64, 64), 7, 12), ((16, 16), 3, 13),
    ])
    def test_geometries_and_tail_segments(self, hw, ri, seed):
        streams = TC.encode_batch(_img(*hw, seed)[None], restart_interval=ri,
                                  device=CPU)
        a, _ = TC.decode_batch(streams, transport="device", device=CPU)
        b, _ = TC.decode_batch(streams, transport="ycc420", device=CPU)
        assert np.array_equal(a, b)

    def test_rejects_restart_free(self, plain3):
        with pytest.raises(ValueError, match="restart-interval"):
            TC.decode_batch(plain3[1], transport="device", device=CPU)

    def test_mixed_quality_batch(self):
        batch = np.stack([_img(64, 64, 90 + i) for i in range(3)])
        streams = [TC.encode_batch(batch[i:i + 1], restart_interval=2,
                                   quality=q, device=CPU)[0]
                   for i, q in enumerate((50, 75, 30))]
        pix, _ = TC.decode_batch(streams, transport="device", device=CPU)
        for i, s in enumerate(streams):
            one, _ = TC.decode_batch([s], transport="ycc420", device=CPU)
            assert np.array_equal(pix[i], one[0]), i
        with pytest.raises(ValueError, match="uniform quant"):
            TC.decode_batch(streams, transport="ycc420", device=CPU)

    def test_mixed_table_sets_one_batch(self, restart2):
        batch, std = restart2
        opt = [_host_encode(im, optimize=True, restart_interval=2)
               for im in batch]
        mixed = [std[0], opt[1], std[2]]
        a, _ = TC.decode_batch(mixed, transport="device", device=CPU)
        for i, s in enumerate(mixed):
            one, _ = TC.decode_batch([s], transport="ycc420", device=CPU)
            assert np.array_equal(a[i], one[0]), i

    def test_missing_dqt_raises(self, restart2):
        """check_decodable runs on every transport."""
        stripped = restart2[1][0]
        sos = stripped.find(b"\xff\xda")
        while (i := stripped.find(b"\xff\xdb", 0, sos)) >= 0:
            seglen = int.from_bytes(stripped[i + 2:i + 4], "big")
            stripped = stripped[:i] + stripped[i + 2 + seglen:]
            sos = stripped.find(b"\xff\xda")
        with pytest.raises(ValueError, match="not decodable"):
            TC.decode_batch([stripped], transport="device", device=CPU)


class TestIndexedTransport:
    @pytest.mark.parametrize("hw,seed", [
        ((64, 64), 1), ((48, 80), 2), ((128, 96), 3), ((16, 32), 4),
    ])
    def test_pixels_equal_ycc420_exactly(self, hw, seed):
        streams = TC.encode_batch(_img(*hw, seed)[None], device=CPU)
        a, _ = TC.decode_batch(streams, transport="indexed", device=CPU)
        b, _ = TC.decode_batch(streams, transport="ycc420", device=CPU)
        assert np.array_equal(a, b)

    def test_batch_and_jax(self, plain3):
        a, _ = TC.decode_batch(plain3[1], transport="indexed", device=CPU)
        b, _ = TC.decode_batch(plain3[1], transport="ycc420", device=CPU)
        assert np.array_equal(a, b)
        ref, _ = JC.decode_batch(plain3[1], transport="indexed")
        diff = np.abs(a.astype(int) - ref.astype(int))
        assert diff.max() <= 2 and (diff > 0).mean() <= 0.01

    def test_noise_stream(self):
        rng = np.random.default_rng(5)
        img = rng.integers(0, 256, (1, 64, 64, 3), np.uint8)
        streams = TC.encode_batch(img, device=CPU)
        a, _ = TC.decode_batch(streams, transport="indexed", device=CPU)
        b, _ = TC.decode_batch(streams, transport="ycc420", device=CPU)
        assert np.array_equal(a, b)

    def test_mixed_quality_and_tables(self):
        imgs = [_img(64, 64, 95 + i) for i in range(2)]
        streams = [_host_encode(imgs[0], quality=85),
                   _host_encode(imgs[1], quality=40, optimize=True)]
        pix, _ = TC.decode_batch(streams, transport="indexed", device=CPU)
        for i, s in enumerate(streams):
            one, _ = TC.decode_batch([s], transport="ycc420", device=CPU)
            assert np.array_equal(pix[i], one[0]), i

    def test_rejects_restart_streams(self, restart2):
        with pytest.raises(ValueError, match="restart-FREE"):
            TC.decode_batch(restart2[1], transport="indexed", device=CPU)


class TestAutoPick:
    def test_restart_streams_default_to_device(self, restart2, monkeypatch):
        calls = []
        orig = TC._decode_batch_device_dispatch

        def spy(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        monkeypatch.setattr(TC, "_decode_batch_device_dispatch", spy)
        auto, _ = TC.decode_batch(restart2[1], device=CPU)
        assert calls, "device dispatch not used for restart streams"
        ref, _ = TC.decode_batch(restart2[1], transport="ycc420", device=CPU)
        assert np.array_equal(auto, ref)

    def test_restart_free_streams_stay_on_ycc420(self, plain3, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("device dispatch on restart-free streams")

        monkeypatch.setattr(TC, "_decode_batch_device_dispatch", boom)
        monkeypatch.setattr(TC, "_decode_batch_indexed_dispatch", boom)
        assert TC.decode_batch(plain3[1], device=CPU)[0].shape[0] == 3

    def test_auto_falls_back_on_mixed_restart_intervals(self):
        batch = np.stack([_img(64, 64, 170 + i) for i in range(2)])
        mixed = [TC.encode_batch(batch[:1], restart_interval=2,
                                 device=CPU)[0],
                 TC.encode_batch(batch[1:], restart_interval=4,
                                 device=CPU)[0]]
        with pytest.raises(ValueError, match="uniform DRI"):
            TC.decode_batch(mixed, transport="device", device=CPU)
        auto, _ = TC.decode_batch(mixed, device=CPU)       # must not raise
        ref, _ = TC.decode_batch(mixed, transport="ycc420", device=CPU)
        assert np.array_equal(auto, ref)

    def test_kernel_failure_is_not_hidden(self, restart2, monkeypatch):
        """Only the ValueError of ineligible input falls back; an error of
        the device program (a kernel that fails to build or launch raises
        RuntimeError) reaches the caller."""
        def boom(*a, **k):
            raise RuntimeError("nvcc failed")

        monkeypatch.setattr(TC.ED, "decode_segments", boom)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            TC.decode_batch(restart2[1], device=CPU)

    @pytest.mark.parametrize("where", ["decode_segments", "words_tensor",
                                       "device_lut"])
    def test_device_path_value_error_is_not_hidden(self, restart2,
                                                   monkeypatch, where):
        """The auto pick decides eligibility from the headers alone: a
        ValueError raised anywhere on the device path (a wrapper refusing a
        dtype, shape or device) reaches the caller and never turns into a
        host decode."""
        def boom(*a, **k):
            raise ValueError("lut must be int32")

        def no_host_decode(*a, **k):
            raise AssertionError("fell back to the ycc420 transport")

        monkeypatch.setattr(TC.ED, where, boom)
        monkeypatch.setattr(TC, "_ycc420_host_prep", no_host_decode)
        with pytest.raises(ValueError, match="lut must be int32"):
            TC.decode_batch(restart2[1], device=CPU)


class TestCorruptionDetection:
    def _first_marker(self, data, pj):
        d = np.frombuffer(data, np.uint8)
        i = pj.entropy_start
        while not (d[i] == 0xFF and 0xD0 <= d[i + 1] <= 0xD7):
            i += 1
        return i

    def test_zeroed_segment_raises(self, restart2):
        data = bytearray(restart2[1][0])
        pj = parse(bytes(data))
        for j in range(pj.entropy_start, self._first_marker(bytes(data), pj)):
            data[j] = 0x00
        with pytest.raises(ValueError, match=r"corrupt.*\[1\]"):
            TC.decode_batch([restart2[1][1], bytes(data)],
                            transport="device", device=CPU)

    def test_deleted_byte_raises(self, restart2):
        data = restart2[1][0]
        i = self._first_marker(data, parse(data))
        trunc = data[: i - 1] + data[i:]    # segment 0 one byte short
        with pytest.raises(ValueError, match="corrupt"):
            TC.decode_batch([trunc], transport="device", device=CPU)

    def test_device_finish_copy(self):
        props = make_encode_props(16, 16)
        packed = np.zeros((3, 16 * 16 * 3 // 2 + 1), np.uint8)
        good = ("device", packed, props, 3, 1, 1)
        a, _ = HG._decode_batch_device_finish(good)
        b, _ = JC._decode_batch_device_finish(good)
        assert np.array_equal(a, b)
        packed = packed.copy()
        packed[[0, 2], -1] = 1
        msgs = []
        for fn in (HG._decode_batch_device_finish,
                   JC._decode_batch_device_finish):
            with pytest.raises(ValueError, match="corrupt") as exc:
                fn(("device", packed, props, 3, 1, 1))
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1] and "[0, 2]" in msgs[0]

    def test_bitflip_sweep_detection(self, restart2):
        """Flip every bit of the first entropy bytes, one at a time.  A
        flip that resynchronises into a valid stream of the same bit
        length cannot be detected by any decoder; such survivors must
        decode to the host frontend's pixels.  Flips that derail the code
        structure must be detected."""
        data = restart2[1][2]
        es = parse(data).entropy_start
        detected = survived = 0
        for byte_off in range(6):
            for bit in range(8):
                corrupt = bytes(
                    data[: es + byte_off]
                    + bytes([data[es + byte_off] ^ (1 << bit)])
                    + data[es + byte_off + 1:])
                try:
                    a, _ = TC.decode_batch([corrupt], transport="device",
                                           device=CPU)
                except ValueError:
                    detected += 1
                    continue
                survived += 1
                b, _ = TC.decode_batch([corrupt], transport="ycc420",
                                       device=CPU)
                assert np.array_equal(a, b)
        assert detected + survived == 48
        assert detected >= 10, (detected, survived)


ACCEPTABLE = (JpegFormatError, ValueError, RuntimeError, IndexError)


class TestFuzz:
    """Corrupted restart streams on the default transport: a typed error
    or pixels of the right shape, never a hang or a crash."""

    def test_truncations(self, restart2):
        stream = restart2[1][0]
        rng = np.random.default_rng(0)
        for cut in sorted(rng.integers(2, len(stream) - 1, size=25).tolist()):
            try:
                px, _ = TC.decode_batch([stream[:cut]], device=CPU)
                assert px.shape == (1, 64, 64, 3)
            except ACCEPTABLE:
                pass

    def test_single_byte_flips(self, restart2):
        stream = restart2[1][1]
        rng = np.random.default_rng(1)
        for _ in range(40):
            data = bytearray(stream)
            data[int(rng.integers(2, len(stream)))] = int(rng.integers(0, 256))
            try:
                px, _ = TC.decode_batch([bytes(data)], device=CPU)
                assert px.shape == (1, 64, 64, 3)
            except ACCEPTABLE:
                pass

    def test_random_entropy_bitflips(self, restart2):
        stream = restart2[1][2]
        es = parse(stream).entropy_start
        rng = np.random.default_rng(11)
        for _ in range(8):
            corrupt = bytearray(stream)
            for _ in range(3):
                i = rng.integers(es, len(stream) - 2)
                corrupt[i] ^= 1 << int(rng.integers(0, 8))
            try:
                px, _ = TC.decode_batch([bytes(corrupt)], device=CPU)
                assert px.shape == (1, 64, 64, 3)
            except ACCEPTABLE:
                pass


class TestHostFrontendCopies:
    def test_device_host_frontend(self, restart2):
        pjs = [parse(s) for s in restart2[1]]
        got = HG._device_host_frontend(pjs, 16, 2, 8)
        ref = JC._device_host_frontend(pjs, 16, 2, 8)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and np.array_equal(g, r)
        assert got[0].dtype == np.uint32

    def test_differential_sweep(self):
        """Device transport against the ycc420 transport (host C++
        frontend) across content, restart intervals and geometries."""
        rng = np.random.default_rng(123)
        for trial in range(5):
            h = int(rng.choice([32, 48, 64, 80]))
            w = int(rng.choice([32, 48, 64]))
            ri = int(rng.choice([1, 2, 3, 5, 7]))
            s = [_host_encode(_img(h, w, 1000 + trial), restart_interval=ri)]
            a, _ = TC.decode_batch(s, transport="device", device=CPU)
            b, _ = TC.decode_batch(s, transport="ycc420", device=CPU)
            assert np.array_equal(a, b), (h, w, ri)


class TestCudaWrapperOnCpu:
    """What of ops/scan_cuda.py runs without a card."""

    def _args(self):
        return (torch.zeros((4, 8), dtype=torch.int32),
                torch.zeros(4, dtype=torch.int32),
                torch.zeros((1, 6, 65536), dtype=torch.int32))

    def test_cpu_tensor_refused(self):
        from jpezy_tpu_torch.ops import scan_cuda

        with pytest.raises(ValueError, match="not a CUDA tensor"):
            scan_cuda.decode_segments_cuda(*self._args(), max_blocks=6)

    @pytest.mark.parametrize("bad", ["words_dtype", "lut_shape", "words_dim",
                                     "tsel_shape", "max_blocks"])
    def test_bad_arguments_refused(self, bad):
        from jpezy_tpu_torch.ops import scan_cuda

        words, nblk, lut = self._args()
        kw = {"max_blocks": 6}
        if bad == "words_dtype":
            words = words.to(torch.int64)
        elif bad == "lut_shape":
            lut = lut[:, :5]
        elif bad == "words_dim":
            words = words[0]
        elif bad == "tsel_shape":
            kw["tsel"] = torch.zeros(3, dtype=torch.int32)
        else:
            kw["max_blocks"] = -1
        with pytest.raises(ValueError, match="decode_segments_cuda"):
            scan_cuda.decode_segments_cuda(words, nblk, lut, **kw)

    def test_kernel_source_zigzag_matches(self):
        import re

        from jpezy_tpu_torch.ops import scan_cuda

        src = open(scan_cuda.LIB.src).read()
        body = re.search(r"kZigzag\[kSlots\] = \{([^}]*)\}", src).group(1)
        assert [int(x) for x in body.split(",")] == list(T.ZIGZAG)
