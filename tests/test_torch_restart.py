"""Restart-interval encode of jpezy_tpu_torch against jpezy_tpu.

Everything from the quantized blocks on is integer-exact: the DC predictor
resets, the segment-aligned bit offsets, the `combined` array (total bits,
the S segment bit counts, then the stream) and the host assembly with RSTn
markers.  Exact-mode streams must therefore be byte-identical to
jax_codec.encode_batch and to the host C++ codec for every restart
interval (tolerance 0).  Fast mode runs a float32 DCT whose summation
order differs from XLA's, so its streams must be byte-identical or decode
(host C++ decoder) to within 0.05 dB PSNR of JAX's.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jpezy_tpu.codec import jax_codec as JC
from jpezy_tpu.ops import entropy as JE
from jpezy_tpu_torch.bitstream.reader import parse
from jpezy_tpu_torch.codec import host_codec
from jpezy_tpu_torch.codec import host_glue as HG
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.ops import entropy as TE
from jpezy_tpu_torch.runtime import pipeline as P

from test_torch_host_copies import host_runtime  # noqa: F401 (autouse)

CPU = "cpu"


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def batch2():
    from imagegen import make_test_image

    return np.stack([make_test_image(64, 64, seed=140 + i) for i in range(2)])


@pytest.fixture(scope="module")
def quantized(batch2):
    """Exact-mode quantized blocks of batch2, per component [N, B, 64]."""
    y, cb, cr = HG.host_rgb_to_ycc420(batch2)
    return TC._quantize_local_ycc(
        torch.from_numpy(y), torch.from_numpy(cb), torch.from_numpy(cr),
        gray=False, dtype=torch.float64, rounded=False)


def _rst_markers(stream: bytes) -> list[int]:
    pj = parse(stream)
    d = stream[pj.entropy_start:-2]
    return [d[i + 1] - 0xD0 for i in range(len(d) - 1)
            if d[i] == 0xFF and 0xD0 <= d[i + 1] <= 0xD7]


class TestOffsets:
    @pytest.mark.parametrize("seg_blocks", [6, 12, 18, 48, 100])
    def test_stream_offsets_restart_batch(self, seg_blocks):
        rng = np.random.default_rng(seg_blocks)
        bits = rng.integers(2, 1700, (3, 96)).astype(np.int32)
        got = TE.stream_offsets_restart_batch(torch.from_numpy(bits),
                                              seg_blocks)
        ref = JE.stream_offsets_restart_batch(jnp.asarray(bits), seg_blocks)
        for g, r in zip(got, ref):
            assert np.array_equal(g.numpy(), np.asarray(r))
        goff, total, seg_bits = (g.numpy() for g in got)
        S = -(-96 // seg_blocks)
        assert seg_bits.shape == (3, S)
        # every segment starts on a byte boundary
        assert not (goff[:, ::seg_blocks] % 8).any()
        assert np.array_equal(total, (((seg_bits + 7) // 8) * 8).sum(1))

    @pytest.mark.parametrize("bpm,ri", [(4, 1), (4, 3), (1, 2), (1, 8),
                                        (4, 0)])
    def test_dc_predictors_restart(self, bpm, ri):
        rng = np.random.default_rng(bpm * 10 + ri)
        q = rng.integers(-1024, 1017, (2, 16 * bpm, 64)).astype(np.int32)
        got = TE.dc_predictors_restart(torch.from_numpy(q[:, :, 0]), ri * bpm)
        ref = JC._batch_pred(jnp.asarray(q), bpm, ri)
        assert np.array_equal(got.numpy(), np.asarray(ref))
        one = TE.dc_predictors_restart(torch.from_numpy(q[0, :, 0]), ri * bpm)
        ref1 = JE.dc_predictors_restart(jnp.asarray(q[0, :, 0]), ri * bpm)
        assert np.array_equal(one.numpy(), np.asarray(ref1))

    def test_restart_offsets_then_scatter(self):
        """The segment-aligned offsets fed to the one global scatter give
        the JAX package's restart concat."""
        rng = np.random.default_rng(5)
        bits = rng.integers(2, 200, (2, 24)).astype(np.int32)
        words = np.zeros((2, 24, 64), np.uint32)
        for i in range(2):
            for b in range(24):
                nb = int(bits[i, b])
                v = int(rng.integers(0, 1 << 62)) | (1 << 62)
                s = format(v, "b") * 4
                full = s[:nb].ljust(2048, "0")
                words[i, b] = [int(full[k:k + 32], 2)
                               for k in range(0, 2048, 32)]
        goff, total, seg_bits = TE.stream_offsets_restart_batch(
            torch.from_numpy(bits), 6)
        got = (TE._concat_batch_scatter(
            torch.from_numpy(words.astype(np.int64)), goff, 256),
            total, seg_bits)
        ref = JE.concat_device_restart_batch(
            jnp.asarray(words), jnp.asarray(bits), 256, 6)
        for g, r in zip(got, ref):
            assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int64))


class TestCombined:
    @pytest.mark.parametrize("ri", [1, 3, 8])
    def test_combined_equals_jax(self, quantized, ri):
        wc, bc = TC._emit_local(*quantized, ri)
        got, words_c, bits_mcu = TC._concat_batch_combined_comp(wc, bc, ri)
        ref, ref_w, ref_b = JC._concat_batch_combined_comp(
            tuple(jnp.asarray(w.numpy().astype(np.uint32)) for w in wc),
            tuple(jnp.asarray(b.numpy()) for b in bc), ri)
        S = -(-16 // ri)
        assert got.shape[1] == 1 + S + TC.stream_budget_words_batch(96)
        assert np.array_equal(got.numpy(), np.asarray(ref).astype(np.int64))
        # the words and bits stay per component; an image's rows in MCU
        # order are what the JAX function's overflow fallback reorders
        assert np.array_equal(torch.cat(words_c, dim=1).numpy(),
                              np.asarray(ref_w).astype(np.int64))
        for i in range(got.shape[0]):
            w_mcu, b_mcu = TC._image_words_bits(words_c, bits_mcu, i)
            assert np.array_equal(b_mcu, np.asarray(ref_b)[i])
            assert np.array_equal(w_mcu, JC._words_comp_to_mcu(
                np.asarray(ref_w)[i], 16))

    def test_restart_zero_is_the_plain_layout(self, quantized):
        wc, bc = TC._emit_local(*quantized)
        a = TC._concat_batch_combined_comp(wc, bc)
        b = TC._concat_batch_combined_comp(*TC._emit_local(*quantized, 0), 0)
        assert torch.equal(a[0], b[0])
        assert all(torch.equal(x, y) for x, y in zip(a[1] + a[2], b[1] + b[2]))
        assert a[0].shape[1] == 1 + TC.stream_budget_words_batch(96)


class TestStreams:
    @pytest.mark.parametrize("ri,quality", [(1, None), (2, None), (3, 60),
                                            (8, None)])
    def test_exact_byte_identical_to_jax_and_host(self, batch2, ri, quality):
        got = TC.encode_batch(batch2, precision="exact", restart_interval=ri,
                              quality=quality, device=CPU)
        assert got == JC.encode_batch(batch2, precision="exact",
                                      restart_interval=ri, quality=quality)
        assert got == [host_codec.encode(
            im[..., 0], im[..., 1], im[..., 2], quality=quality,
            restart_interval=ri) for im in batch2]

    @pytest.mark.parametrize("ri,quality", [(1, 60), (2, None), (3, None),
                                            (8, 35)])
    def test_fast_identical_or_psnr_within_005db(self, batch2, ri, quality):
        got = TC.encode_batch(batch2, restart_interval=ri, quality=quality,
                              device=CPU)
        ref = JC.encode_batch(batch2, restart_interval=ri, quality=quality)
        # observed on these images: byte-identical to JAX's streams
        for g, r, img in zip(got, ref, batch2):
            if g == r:
                continue
            pg = np.stack(host_codec.decode(g)[:3], -1)
            pr = np.stack(host_codec.decode(r)[:3], -1)
            assert _psnr(pg, img) >= _psnr(pr, img) - 0.05

    @pytest.mark.parametrize("ri", [1, 3, 8])
    def test_markers(self, batch2, ri):
        """DRI in the header, RSTn between segments cycling 0..7, none
        after the last, and the host decoder reads the stream."""
        for s in TC.encode_batch(batch2, restart_interval=ri, device=CPU):
            assert s[:2] == b"\xff\xd8" and s[-2:] == b"\xff\xd9"
            assert parse(s).restart_interval == ri
            nseg = -(-16 // ri)
            assert _rst_markers(s) == [k % 8 for k in range(nseg - 1)]
            assert host_codec.decode(s)[0].shape == (64, 64)

    def test_gray_restart(self, batch2):
        got = TC.encode_batch(batch2, gray=True, precision="exact",
                              restart_interval=2, device=CPU)
        assert got == [host_codec.encode(
            im[..., 0], im[..., 1], im[..., 2], gray=True,
            restart_interval=2) for im in batch2]

    def test_noise_overflow_splice(self):
        """Noise outgrows the stream budget: the image's segments are
        spliced on the host from its per-block words."""
        rng = np.random.default_rng(17)
        noise = rng.integers(0, 256, (1, 256, 256, 3), np.uint8)
        ticket = TC.encode_batch_dispatch(noise, precision="exact",
                                          restart_interval=5, device=CPU)
        S = -(-256 // 5)
        maxw = ticket["combined"].shape[1] - 1 - S
        assert int(ticket["combined"][0, 0]) > 32 * maxw
        got = TC.encode_batch_finish(ticket)[0]
        assert got == host_codec.encode(
            noise[0, ..., 0], noise[0, ..., 1], noise[0, ..., 2],
            restart_interval=5)

    def test_pipeline_passes_restart_interval(self, batch2):
        ref = TC.encode_batch(batch2, restart_interval=2, device=CPU)
        assert list(P.encode_batches([batch2], restart_interval=2,
                                     device=CPU)) == [ref]
        (streams, px), = P.roundtrip_batches(
            [batch2], restart_interval=2, transport="device", device=CPU)
        assert streams == ref
        assert np.array_equal(px, TC.decode_batch(ref, transport="ycc420",
                                                  device=CPU)[0])


class TestHostGlueCopies:
    """The restart helpers copied into host_glue against their originals."""

    def test_assemble_restart_segments(self):
        rng = np.random.default_rng(3)
        seg_bits = np.array([13, 64, 7, 255, 8, 1, 90, 33, 16, 5], np.uint32)
        nbytes = int(((seg_bits + 7) // 8).sum())
        raw = bytes(rng.integers(0, 256, nbytes + 9, dtype=np.uint8)
                    | np.where(rng.random(nbytes + 9) < 0.3, 0xFF, 0)
                    .astype(np.uint8))
        assert (HG._assemble_restart_segments(raw, seg_bits)
                == JC._assemble_restart_segments(raw, seg_bits))

    def test_splice_restart_raw(self, quantized):
        ri, S = 3, 6
        wc, bc = TC._emit_local(*quantized, ri)
        combined, words_c, bits = TC._concat_batch_combined_comp(wc, bc, ri)
        nw, nb = TC._image_words_bits(words_c, bits, 0)
        seg_bits = combined[0, 1:1 + S].numpy().astype(np.uint32)
        got = HG._splice_restart_raw(nw, nb, S, ri, seg_bits)
        assert got == JC._splice_restart_raw(nw, nb, S, ri, seg_bits)
        # and the spliced segments are what the device stream holds
        stream = combined[0, 1 + S:].numpy().astype(">u4").tobytes()
        assert (HG._assemble_restart_segments(got, seg_bits)
                == HG._assemble_restart_segments(stream, seg_bits))
