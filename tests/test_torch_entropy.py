"""Parity of the PyTorch port's entropy encode with jpezy_tpu.ops.entropy.

Given the same quantized blocks, every stage is integer-exact and must be
identical: emissions (hi, lo, nbits), the plain pack against both JAX
references the Pallas kernel is held to (the default reduce form and the
fori form, use_pallas=False), stream offsets and the stream concat,
including images that overflow their word budget.  The CUDA kernel is
held to the plain pack in tests/test_torch_cuda.py and chip_smoke.py.
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
