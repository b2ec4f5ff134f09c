"""Parity of the PyTorch port's entropy encode with jpezy_tpu.ops.entropy.

Given the same quantized blocks, every stage is integer-exact and must be
identical: emissions (hi, lo, nbits), the plain pack against both JAX
references the Pallas kernel is held to (the default reduce form and the
fori form, use_pallas=False), stream offsets and the stream concat,
including images that overflow their word budget.  The fused encode
(encode_block_words_plain: emissions + pack) is held to the JAX emissions + pack
and to the numpy oracle's bit strings on the seeded edge-case blocks.  The
CUDA kernels are held to the plain versions in tests/test_torch_cuda.py
and chip_smoke.py; what of their wrappers runs without a card (argument
checks, dispatch by device, the tables written into the source) is tested
here.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jpezy_tpu.bitstream import writer
from jpezy_tpu.bitstream.splice import splice_blocks
from jpezy_tpu.codec import oracle
from jpezy_tpu.ops import entropy as JE
from jpezy_tpu_torch.codec import host_glue as HG
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.ops import entropy as TE

from test_entropy_vectors import VECTORS, make_block
from test_torch_host_copies import host_runtime  # noqa: F401 (autouse)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.fixture(scope="module")
def qblocks():
    """[N, B, 64] quantized luma blocks of two test images plus sparse
    random blocks with large magnitudes and long zero runs."""
    from imagegen import make_test_image

    rgbs = np.stack([make_test_image(64, 64, seed=60 + i) for i in range(2)])
    y, cb, cr = HG.host_rgb_to_ycc420(rgbs)
    yq, _, _ = TC._quantize_local_ycc(_t(y), _t(cb), _t(cr), gray=False,
                                      dtype=torch.float64, rounded=False)
    rng = np.random.default_rng(61)
    rnd = (rng.integers(-1023, 1024, (2, 64, 64))
           * (rng.random((2, 64, 64)) < 0.15)).astype(np.int32)
    rnd[:, :, 0] = rng.integers(-1024, 1017, (2, 64))
    return np.concatenate([yq.numpy(), rnd], axis=1)


def _emissions_both(q2d, chroma):
    pred = JE.dc_predictors(jnp.asarray(q2d[:, 0]))
    ref = JE.block_emissions(jnp.asarray(q2d), pred, chroma)
    got = TE.block_emissions(_t(q2d), TE.dc_predictors(_t(q2d[:, 0])), chroma)
    return ref, got


class TestEmissions:
    def test_bit_category_identical(self):
        v = np.arange(-2047, 2048, dtype=np.int64)
        assert np.array_equal(TE.bit_category(_t(v)).numpy(),
                              _np(JE.bit_category(jnp.asarray(v))))

    def test_dc_predictors_identical(self, qblocks):
        dc = qblocks[:, :, 0]
        got = TE.dc_predictors(_t(dc)).numpy()
        for i in range(dc.shape[0]):
            assert np.array_equal(got[i], _np(JE.dc_predictors(
                jnp.asarray(dc[i]))))

    @pytest.mark.parametrize("chroma", [False, True])
    def test_block_emissions_identical(self, qblocks, chroma):
        q2d = qblocks.reshape(-1, 64)
        ref, got = _emissions_both(q2d, chroma)
        for r, g, name in zip(ref, got, ("hi", "lo", "nbits")):
            assert np.array_equal(g.numpy(), _np(r)), name


class TestPack:
    @pytest.mark.parametrize("chroma", [False, True])
    def test_pack_identical_to_reduce_and_fori(self, qblocks, chroma):
        ref, got = _emissions_both(qblocks.reshape(-1, 64), chroma)
        w, b = TE.pack_block_words(*got)
        w_red, b_red = JE.pack_block_words(*ref)
        w_fori, b_fori = JE.pack_block_words(*ref, use_pallas=False)
        assert np.array_equal(w.numpy(), _np(w_red))
        assert np.array_equal(w.numpy(), _np(w_fori))
        assert np.array_equal(b.numpy(), _np(b_red))
        assert np.array_equal(b.numpy(), _np(b_fori))

    def test_cpu_tensors_take_plain_pack(self, qblocks):
        _, got = _emissions_both(qblocks.reshape(-1, 64), False)
        w, b = TE.pack_block_words(*got)
        w_p, b_p = TE.pack_block_words_plain(*got)
        assert torch.equal(w, w_p) and torch.equal(b, b_p)


class TestConcat:
    def test_stream_offsets_identical(self):
        rng = np.random.default_rng(62)
        bits = rng.integers(0, 300, (3, 50)).astype(np.int32)
        goff, total = TE.stream_offsets_batch(_t(bits))
        rg, rt = JE.stream_offsets_batch(jnp.asarray(bits))
        assert np.array_equal(goff.numpy(), _np(rg))
        assert np.array_equal(total.numpy(), _np(rt))

    @pytest.mark.parametrize("maxw", [4096, 40],
                             ids=["within_budget", "overflow"])
    def test_concat_scatter_identical(self, qblocks, maxw):
        N, Bn, _ = qblocks.shape
        _, got = _emissions_both(qblocks.reshape(-1, 64), False)
        w, b = TE.pack_block_words(*got)
        w3, b2 = w.reshape(N, Bn, 64), b.reshape(N, Bn)
        goff, total = TE.stream_offsets_batch(b2)
        if maxw == 40:
            assert (total > 32 * maxw).all()  # both images overflow
        stream = TE._concat_batch_scatter(w3, goff, maxw)
        ref = JE._concat_batch_scatter(
            jnp.asarray(w3.numpy().astype(np.uint32)), jnp.asarray(b2.numpy()),
            jnp.asarray(goff.numpy()), maxw)
        assert np.array_equal(stream.numpy(), _np(ref))
        # within budget the stream is the host splice of the blocks
        if maxw == 4096:
            for i in range(N):
                raw = HG._stream_to_bytes(
                    stream[i].numpy().astype(np.uint32), int(total[i]))
                spliced, nbits = splice_blocks(
                    w3[i].numpy().astype(np.uint32), b2[i].numpy())
                assert nbits == int(total[i]) and raw == spliced


@pytest.mark.parametrize("name,vals", VECTORS, ids=[v[0] for v in VECTORS])
@pytest.mark.parametrize("chroma", [False, True])
def test_entropy_vectors(name, vals, chroma):
    """The adversarial vectors of test_entropy_vectors.py through the port:
    emissions identical to JAX, packed bits identical to the oracle."""
    blk = make_block(vals)
    ref, got = _emissions_both(blk[None], chroma)
    for r, g in zip(ref, got):
        assert np.array_equal(g.numpy(), _np(r)), name
    codes, lens = oracle.encode_block_emissions(
        blk[None], np.zeros(1, np.int32), chroma)
    want, t_want = writer.pack_bits(codes.reshape(-1), lens.reshape(-1))
    w, b = TE.pack_block_words(*got)
    have, t_have = splice_blocks(w.numpy().astype(np.uint32), b.numpy())
    assert (have, t_have) == (want, t_want), name


# ---------------------------------------------------------------------------
# The fused entropy encode (emissions + pack) and its edge-case blocks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def edge_blocks():
    return TE.edge_case_blocks(7)


def _zigzag_runs(q):
    """Per block: the zero runs before each nonzero AC, in zigzag order."""
    from jpezy_tpu_torch.core import tables as T

    out = []
    for zz in q[:, T.ZIGZAG]:
        nzpos = np.flatnonzero(zz[1:]) + 1
        out.append(set(np.diff(np.concatenate([[0], nzpos])) - 1))
    return out


class TestEdgeCaseBlocks:
    def test_seeded_and_typed(self, edge_blocks):
        assert edge_blocks.dtype == np.int32 and edge_blocks.shape[1] == 64
        assert np.array_equal(edge_blocks, TE.edge_case_blocks(7))
        assert not np.array_equal(edge_blocks, TE.edge_case_blocks(8))
        assert edge_blocks.min() >= -1024 and edge_blocks.max() <= 1023

    @pytest.mark.parametrize("run", TE.EDGE_RUNS)
    def test_covers_run(self, edge_blocks, run):
        assert any(run in runs for runs in _zigzag_runs(edge_blocks))

    def test_covers_eob_and_no_eob(self, edge_blocks):
        last = edge_blocks[:, 63]          # zigzag 63 is natural 63
        assert (last != 0).any() and (last == 0).any()
        assert (np.abs(edge_blocks).sum(axis=1) == 0).any()   # all-zero block

    def test_covers_dc_categories(self, edge_blocks):
        dc = edge_blocks[:, 0].astype(np.int64)
        diff = dc - np.concatenate([[0], dc[:-1]])
        cats = {int(abs(d)).bit_length() for d in diff}
        assert cats == set(range(12))
        assert (diff[np.abs(diff) >= 1024] > 0).any()
        assert (diff[np.abs(diff) >= 1024] < 0).any()

    def test_covers_ac_magnitudes_and_long_blocks(self, edge_blocks):
        ac = edge_blocks.copy()
        ac[:, 0] = 0
        assert ac.max() == 1023 and ac.min() == -1023
        cats = {int(abs(v)).bit_length() for v in ac.reshape(-1)}
        assert cats == set(range(11))
        _, bits = TE.encode_block_words_plain(
            _t(edge_blocks), TE.dc_predictors(_t(edge_blocks[:, 0])), False)
        assert int(bits.max()) >= 1592       # crosses word 49


class TestEncodeBlockWords:
    @pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
    def test_edge_cases_identical_to_jax(self, edge_blocks, chroma):
        pred = JE.dc_predictors(jnp.asarray(edge_blocks[:, 0]))
        w_ref, b_ref = JE.pack_block_words(*JE.block_emissions(
            jnp.asarray(edge_blocks), pred, chroma))
        w, b = TE.encode_block_words_plain(
            _t(edge_blocks), TE.dc_predictors(_t(edge_blocks[:, 0])), chroma)
        assert np.array_equal(w.numpy(), _np(w_ref))
        assert np.array_equal(b.numpy(), _np(b_ref))

    @pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
    def test_edge_cases_identical_to_oracle_bits(self, edge_blocks, chroma):
        from jpezy_tpu_torch.codec import oracle as port_oracle

        pred = np.concatenate([[0], edge_blocks[:-1, 0]]).astype(np.int32)
        codes, lens = port_oracle.encode_block_emissions(
            edge_blocks, pred, chroma)
        w, b = TE.encode_block_words_plain(_t(edge_blocks), _t(pred), chroma)
        w, b = w.numpy().astype(np.uint32), b.numpy()
        for i in range(edge_blocks.shape[0]):
            want = writer.pack_bits(codes[i], lens[i])
            have = splice_blocks(w[i:i + 1], b[i:i + 1])
            assert have == want, i

    @pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
    def test_real_blocks_identical_to_jax(self, qblocks, chroma):
        ref, _ = _emissions_both(qblocks.reshape(-1, 64), chroma)
        w_ref, b_ref = JE.pack_block_words(*ref)
        q2d = _t(qblocks.reshape(-1, 64))
        w, b = TE.encode_block_words(q2d, TE.dc_predictors(q2d[:, 0]), chroma)
        assert np.array_equal(w.numpy(), _np(w_ref))
        assert np.array_equal(b.numpy(), _np(b_ref))

    def test_cpu_tensors_take_plain_and_launch_nothing(self, edge_blocks):
        from jpezy_tpu_torch.ops import pack_cuda

        before = (pack_cuda.launches, pack_cuda.encode_launches)
        q = _t(edge_blocks)
        pred = TE.dc_predictors(q[:, 0])
        w, b = TE.encode_block_words(q, pred, True)
        w_p, b_p = TE.encode_block_words_plain(q, pred, True)
        assert torch.equal(w, w_p) and torch.equal(b, b_p)
        assert (pack_cuda.launches, pack_cuda.encode_launches) == before
        assert pack_cuda.LIB.handle is None      # nothing was built or loaded

    @pytest.mark.parametrize("fn", ["encode_block_words", "pack_block_words"])
    def test_meta_device_raises(self, fn):
        q = torch.zeros((2, 64), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            if fn == "encode_block_words":
                TE.encode_block_words(q, q[:, 0], False)
            else:
                h = q.to(torch.int64)
                TE.pack_block_words(h, h, q)


class TestCudaWrappersOnCpu:
    """What of ops/pack_cuda.py runs without a card: argument checks, the
    bit-pattern view, and the kernel source's tables."""

    def test_low32_keeps_bit_patterns(self):
        """entropy.words32, which the pack's wrapper hands its halves
        through."""
        rng = np.random.default_rng(63)
        x = rng.integers(0, 2**32, (5, 64), dtype=np.int64)
        x[0, :4] = [0, 2**31 - 1, 2**31, 2**32 - 1]
        got = TE.words32(_t(x)).numpy()
        assert got.dtype == np.int32
        assert np.array_equal(got.view(np.uint32), x.astype(np.uint32))

    @pytest.mark.parametrize("fn", ["pack_words_cuda",
                                    "encode_blocks_batch_cuda"],
                             ids=["pack_words_cuda", "encode_blocks_cuda"])
    def test_cpu_tensor_refused(self, fn):
        from jpezy_tpu_torch.ops import pack_cuda

        q = torch.zeros((2, 64), dtype=torch.int32)
        with pytest.raises(ValueError, match="not a CUDA tensor"):
            if fn == "pack_words_cuda":
                pack_cuda.pack_words_cuda(q.to(torch.int64),
                                          q.to(torch.int64), q)
            else:
                pack_cuda.encode_blocks_batch_cuda(q[None], q[None, :1],
                                                   q[None, :1])

    @pytest.mark.parametrize("bad", ["dtype", "shape"])
    def test_bad_arguments_refused(self, bad):
        from jpezy_tpu_torch.ops import pack_cuda

        q = torch.zeros((1, 2, 64) if bad == "dtype" else (1, 2, 63),
                        dtype=torch.int64 if bad == "dtype" else torch.int32)
        c = torch.zeros((1, 1, 64), dtype=torch.int32)
        with pytest.raises(ValueError, match="encode_blocks_batch_cuda"):
            pack_cuda.encode_blocks_batch_cuda(q, c, c)

    def test_kernel_source_tables_match(self):
        """The zigzag order and table indices written into the CUDA source
        are the codec's."""
        import re

        from jpezy_tpu_torch.core import tables as T
        from jpezy_tpu_torch.ops import pack_cuda

        src = open(pack_cuda.LIB.src).read()
        body = re.search(r"kZigzag\[kSlots\] = \{([^}]*)\}", src).group(1)
        assert [int(x) for x in body.split(",")] == list(T.ZIGZAG)
        for name, want in (("kEobIndex", T.EOB_INDEX),
                           ("kZrlIndex", T.ZRL_INDEX),
                           ("kDcEntries", len(T.Y_DC_SIZE)),
                           ("kAcEntries", len(T.Y_AC_SIZE))):
            got = re.search(rf"constexpr int {name} = (\d+);", src).group(1)
            assert int(got) == want, name
