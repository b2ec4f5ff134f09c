"""Optimized encode (optimize=True) of jpezy_tpu_torch against jpezy_tpu
and the host C++ codec.

Pass 1 counts each image's Huffman symbols, the host derives optimal
tables per image, pass 2 codes every image with its own set.  All of it is
integer-exact: the per-image histograms must equal
jax_codec._symbol_histograms_batch, the emissions with custom tables must
equal the JAX block_emissions(tables=...) slot for slot, and exact-mode
streams must be byte-identical to jax_codec.encode_batch(optimize=True)
and to host_codec.encode(optimize=True) (tolerance 0 throughout).

Optimal tables allow codes of 16 bits, so one slot can need 3 x 16 + 16
+ 10 = 74 bits.  The JAX package's 64-bit accumulator keeps only the low
64 bits of such an emission (ROADMAP.md fault H); the port packs the ZRL
prefix apart and is held to the host C++ encoder there.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jpezy_tpu.codec import jax_codec as JC
from jpezy_tpu.ops import entropy as JE
from jpezy_tpu_torch.bitstream import writer
from jpezy_tpu_torch.bitstream.reader import parse
from jpezy_tpu_torch.bitstream.splice import splice_blocks
from jpezy_tpu_torch.codec import host_codec
from jpezy_tpu_torch.codec import host_glue as HG
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.core import tables as T
from jpezy_tpu_torch.ops import entropy as TE
from jpezy_tpu_torch.runtime import native

from test_torch_host_copies import host_runtime  # noqa: F401 (autouse)

CPU = "cpu"


@pytest.fixture(scope="module")
def batch2():
    from imagegen import make_test_image

    return np.stack([make_test_image(64, 64, seed=200 + i) for i in range(2)])


@pytest.fixture(scope="module")
def quantized(batch2):
    """Exact-mode quantized blocks of batch2, per component [N, B, 64]."""
    y, cb, cr = HG.host_rgb_to_ycc420(batch2)
    return TC._quantize_local_ycc(
        torch.from_numpy(y), torch.from_numpy(cb), torch.from_numpy(cr),
        gray=False, dtype=torch.float64, rounded=False)


def _random_tables(seed: int):
    """Optimal flat tables (JAX order) of a seeded random histogram in
    which every symbol occurs: legal, and unlike the Annex K tables."""
    rng = np.random.default_rng(seed)
    dc = rng.integers(1, 5000, 256) * (np.arange(256) < 12)
    ac = np.zeros(256, np.int64)
    for run in range(16):
        for s in range(1, 11):
            ac[(run << 4) | s] = rng.integers(1, 3000)
    ac[0x00], ac[0xF0] = rng.integers(1, 40000), rng.integers(1, 50)
    return tuple(T.optimal_flat_tables(dc, ac)[2:])


def _jax(t):
    return jnp.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


def _stream_bytes(w, b) -> bytes:
    raw, _ = splice_blocks(w.numpy().astype(np.uint32), b.numpy())
    return writer.byte_stuff(raw)


class TestHistograms:
    @pytest.mark.parametrize("ri", [0, 2])
    def test_batch_equals_jax_and_host(self, quantized, ri):
        got = TC._symbol_histograms_batch(*quantized, restart_interval=ri)
        ref = JC._symbol_histograms_batch(*(_jax(q) for q in quantized),
                                          restart_interval=ri)
        assert got.dtype == torch.int32 and got.shape == (2, 4, 256)
        assert np.array_equal(got.numpy(), np.asarray(ref))
        for i in range(2):
            host = native.entropy_histograms(
                *(q[i].numpy() for q in quantized), ri)
            assert np.array_equal(got[i].numpy(), host.astype(np.int32))

    @pytest.mark.parametrize("which", ["edge", "long"])
    def test_one_chain_equals_jax(self, which):
        q = (TE.edge_case_blocks(201) if which == "edge"
             else TE.long_emission_blocks())
        pred = TE.dc_predictors(torch.from_numpy(q[:, 0]))
        got = TE.symbol_histograms_plain(torch.from_numpy(q), pred)
        dc, ac = JE.symbol_histograms(jnp.asarray(q), _jax(pred))
        assert got.shape == (1, 2, 256)
        assert np.array_equal(got[0, 0].numpy(), np.asarray(dc))
        assert np.array_equal(got[0, 1].numpy(), np.asarray(ac))

    @pytest.mark.parametrize("bpi", [1, 3, 17])
    def test_images_counted_apart(self, bpi):
        q = torch.from_numpy(TE.edge_case_blocks(202)[:51])
        pred = TE.dc_predictors(q[:, 0].reshape(-1, bpi)).reshape(-1)
        got = TE.symbol_histograms_plain(q, pred, bpi)
        assert got.shape == (51 // bpi, 2, 256)
        for i in range(51 // bpi):
            sl = slice(i * bpi, (i + 1) * bpi)
            assert torch.equal(got[i], TE.symbol_histograms_plain(
                q[sl], pred[sl])[0])

    def test_cpu_tensors_launch_nothing(self):
        from jpezy_tpu_torch.ops import pack_cuda

        q = torch.from_numpy(TE.edge_case_blocks(203)[:60]).reshape(2, 30, 64)
        comps = (q, q[:, :10], q[:, 10:20])
        before = pack_cuda.histogram_launches
        got = TE.symbol_histograms_batch(*comps, restart_interval=2)
        assert pack_cuda.histogram_launches == before
        assert torch.equal(got, TE.symbol_histograms_batch_plain(*comps, 2))
        with pytest.raises(ValueError, match="unsupported device"):
            TE.symbol_histograms_batch(*(c.to("meta") for c in comps))
        with pytest.raises(ValueError, match="whole number"):
            TE.symbol_histograms_plain(q[0], q[0, :, 0], 31)

    @pytest.mark.parametrize("ri", [0, 1, 3])
    def test_batch_plain_equals_jax(self, quantized, ri):
        """The three-component plain form is jax_codec's
        _symbol_histograms_batch, with and without restarts."""
        got = TE.symbol_histograms_batch_plain(*quantized, ri)
        ref = JC._symbol_histograms_batch(*(_jax(q) for q in quantized),
                                          restart_interval=ri)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(ref))

    @pytest.mark.parametrize("ri", [0, 2])
    def test_carry_is_each_chains_first_predictor(self, quantized, ri):
        """With a carry, the batch form counts what the one-component form
        counts on dc_predictors_restart(first=carry) for Y, Cb and Cr (a
        segment that starts at block 0 still resets to 0)."""
        rng = np.random.default_rng(204)
        carry = torch.from_numpy(rng.integers(-900, 900, (2, 3)).astype(
            np.int32))
        got = TE.symbol_histograms_batch_plain(*quantized, ri, carry)
        rows = []
        for c, (q, bpm) in enumerate(zip(quantized, (4, 1, 1))):
            n, b, _ = q.shape
            pred = TE.dc_predictors_restart(q[:, :, 0], ri * bpm, carry[:, c])
            rows.append(TE.symbol_histograms_plain(q.reshape(-1, 64),
                                                   pred.reshape(-1), b))
        assert torch.equal(got[:, :2], rows[0])
        assert torch.equal(got[:, 2:], rows[1] + rows[2])
        if ri == 0:  # the carry reaches the counts
            assert not torch.equal(got,
                                   TE.symbol_histograms_batch_plain(*quantized))


class TestTables:
    @pytest.mark.parametrize("chroma", [False, True])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_block_emissions_equal_jax(self, seed, chroma):
        tabs = _random_tables(seed)
        q = TE.edge_case_blocks(210 + seed)
        pred = TE.dc_predictors(torch.from_numpy(q[:, 0]))
        got = TE.block_emissions(torch.from_numpy(q), pred, chroma, tabs)
        ref = JE.block_emissions(jnp.asarray(q), _jax(pred), chroma,
                                 tables=tuple(jnp.asarray(t) for t in tabs))
        for g, r in zip(got, ref):
            assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int64))

    def test_kernel_order_catches_a_swap(self):
        """The kernel takes (dc_code, dc_size, ac_code, ac_size); the JAX
        order is (dc_size, dc_code, ac_size, ac_code).  A set where sizes
        and codes differ everywhere they can shows a swap."""
        tabs = _random_tables(3)
        dc_size, dc_code, ac_size, ac_code = tabs
        assert (dc_size != dc_code).sum() >= 8
        assert (ac_size != ac_code).sum() >= 150
        got = TE.kernel_tables(tabs, torch.device("cpu"))
        assert got.dtype == torch.int32 and got.is_contiguous()
        assert tuple(got.shape) == (1, 348)
        assert np.array_equal(got[0].numpy(), np.concatenate(
            [dc_code, dc_size, ac_code, ac_size]))
        per_image = TE.kernel_tables(
            tuple(np.stack([t, t]) for t in tabs), torch.device("cpu"))
        assert tuple(per_image.shape) == (2, 348)
        assert torch.equal(per_image[1], got[0])
        with pytest.raises(ValueError, match="dc_size"):
            TE.kernel_tables((ac_size, dc_code, dc_size, ac_code),
                             torch.device("cpu"))

    @pytest.mark.parametrize("bpi", [6, 29])
    def test_per_image_sets_equal_single_sets(self, bpi):
        sets = [_random_tables(4 + i) for i in range(3)]
        stacked = tuple(np.stack([s[k] for s in sets]) for k in range(4))
        q = torch.from_numpy(TE.edge_case_blocks(220)[:3 * bpi])
        pred = TE.dc_predictors(q[:, 0])
        words, bits = TE.encode_block_words(q, pred, True, tables=stacked,
                                            blocks_per_image=bpi)
        ems = TE.block_emissions(q, pred, True, stacked, bpi)
        for i, one in enumerate(sets):
            sl = slice(i * bpi, (i + 1) * bpi)
            w1, b1 = TE.encode_block_words(q[sl], pred[sl], True, tables=one)
            assert torch.equal(words[sl], w1) and torch.equal(bits[sl], b1)
            for e, e1 in zip(ems, TE.block_emissions(q[sl], pred[sl], True,
                                                     one)):
                assert torch.equal(e[sl], e1)

    def test_fixed_tables_unchanged(self):
        """tables=None is the Annex K set of the component, and passing
        that set explicitly gives the same words."""
        q = torch.from_numpy(TE.edge_case_blocks(221))
        pred = TE.dc_predictors(q[:, 0])
        annex_k = (T.C_DC_SIZE, T.C_DC_CODE, T.C_AC_SIZE, T.C_AC_CODE)
        w0, b0 = TE.encode_block_words(q, pred, True)
        w1, b1 = TE.encode_block_words(q, pred, True, tables=annex_k)
        assert torch.equal(w0, w1) and torch.equal(b0, b1)

    def test_set_count_must_divide_blocks(self):
        q = torch.from_numpy(TE.edge_case_blocks(222)[:10])
        tabs = tuple(np.stack([t] * 3) for t in _random_tables(5))
        with pytest.raises(ValueError, match="table sets"):
            TE.encode_block_words(q, q[:, 0], False, tables=tabs)


class TestLongEmissions:
    """Slots of up to 74 bits (fault H of the JAX package)."""

    def test_tables_reach_74_bits(self):
        _, _, dc_size, dc_code, ac_size, ac_code = TE.long_emission_tables()
        assert ac_size[T.ZRL_INDEX] == 16
        assert ac_size[T.ac_symbol_index(14, 10)] == 16
        q = torch.from_numpy(TE.long_emission_blocks())
        _, _, nbits = TE.block_emissions(
            q, TE.dc_predictors(q[:, 0]), False,
            (dc_size, dc_code, ac_size, ac_code))
        assert int(nbits.max()) == 74 and int((nbits > 64).sum()) == 3

    def test_entropy_bytes_equal_host_encoder(self):
        """Two MCUs of the long-emission blocks, all six components on the
        long tables: the stuffed entropy bytes of the port's plain encode
        equal native.entropy_encode's (the C++ encoder writes every ZRL,
        code and extra field apart)."""
        _, _, *tabs = TE.long_emission_tables()
        q = TE.long_emission_blocks()
        q12 = np.concatenate([q, q[:4]])
        yq = np.concatenate([q12[0:4], q12[6:10]])
        cbq, crq = q12[[4, 10]], q12[[5, 11]]
        packed = (host_codec._packed_dc(tabs[0], tabs[1]),
                  host_codec._packed_ac(tabs[2], tabs[3]))
        ref = native.entropy_encode(yq, cbq, crq, 0, *packed, *packed)

        def enc(blocks):
            t = torch.from_numpy(blocks)
            return TE.encode_block_words(t, TE.dc_predictors(t[:, 0]), False,
                                         tables=tabs)

        (wy, by), (wc, bc), (wr, br) = enc(yq), enc(cbq), enc(crq)
        order = [(wy[4 * m:4 * m + 4], by[4 * m:4 * m + 4]) for m in (0, 1)]
        words = torch.cat([order[0][0], wc[:1], wr[:1],
                           order[1][0], wc[1:], wr[1:]])
        bits = torch.cat([order[0][1], bc[:1], br[:1],
                          order[1][1], bc[1:], br[1:]])
        assert _stream_bytes(words, bits) == ref

    def test_low_64_bits_equal_jax(self):
        """Where an emission has more than 64 bits, the JAX accumulator
        keeps its low 64 bits; block_emissions reports the same."""
        _, _, *tabs = TE.long_emission_tables()
        q = TE.long_emission_blocks()
        pred = TE.dc_predictors(torch.from_numpy(q[:, 0]))
        got = TE.block_emissions(torch.from_numpy(q), pred, False, tabs)
        ref = JE.block_emissions(jnp.asarray(q), _jax(pred), False,
                                 tables=tuple(jnp.asarray(t) for t in tabs))
        for g, r in zip(got, ref):
            assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int64))


def _dht(stream: bytes) -> bytes:
    pj = parse(stream)
    return stream[stream.find(b"\xff\xc4"):pj.entropy_start]


class TestOptimizeStreams:
    @pytest.mark.parametrize("kw", [
        {}, {"quality": 70}, {"restart_interval": 2}, {"gray": True},
    ], ids=["plain", "quality70", "restart2", "gray"])
    def test_byte_identical_to_jax_and_host(self, batch2, kw):
        got = TC.encode_batch(batch2, precision="exact", optimize=True,
                              device=CPU, **kw)
        assert got == JC.encode_batch(batch2, precision="exact",
                                      optimize=True, **kw)
        assert got == [host_codec.encode(im[..., 0], im[..., 1], im[..., 2],
                                         optimize=True, **kw)
                       for im in batch2]
        assert _dht(got[0]) != _dht(got[1])          # tables per image

    def test_fast_streams_smaller_and_decodable(self, batch2):
        opt = TC.encode_batch(batch2, optimize=True, device=CPU)
        std = TC.encode_batch(batch2, device=CPU)
        for o, s in zip(opt, std):
            assert len(o) < len(s)
            a = np.stack(host_codec.decode(o)[:3], -1)
            b = np.stack(host_codec.decode(s)[:3], -1)
            assert np.array_equal(a, b)          # same coefficients

    def test_device_decode_takes_per_image_tables(self, batch2):
        """optimize streams with restarts decode on the device transport
        (one table set per image in the scan) to the ycc420 pixels."""
        opt = TC.encode_batch(batch2, optimize=True, restart_interval=2,
                              device=CPU)
        ticket = TC.decode_batch_dispatch(opt, device=CPU)
        assert ticket[0] == "device"
        a, _ = TC.decode_batch_finish(ticket)
        b, _ = TC.decode_batch(opt, transport="ycc420", device=CPU)
        assert np.array_equal(a, b)

    def test_pipeline_encode_batches(self, batch2):
        from jpezy_tpu_torch.runtime.pipeline import encode_batches

        out = list(encode_batches([batch2, batch2[::-1]], optimize=True,
                                  precision="exact", device=CPU))
        want = TC.encode_batch(batch2, optimize=True, precision="exact",
                               device=CPU)
        assert out[0] == want and out[1] == want[::-1]
