"""Parity of jpezy_tpu_torch.codec.torch_codec with jpezy_tpu's jax_codec.

Encode: exact-mode streams are integer-exact end to end and must be
byte-identical to jax_codec.encode_batch, to the oracle on the 256x256
noise budget-overflow case, and to the committed golden JPEG.  Fast mode
uses a float32 DCT whose summation order differs from XLA's, so its
streams must be byte-identical or decode (in PIL, an independent decoder)
to within 0.05 dB PSNR of JAX's.

Decode: the u8 planes of the device program are held to within +-1 of
jax_codec._decode_fused_batch_ycc420 on the same upload buffer (float32
IDCT truncation ties), and RGB to within +-2 of jax_codec.decode_batch.
"""
import io
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jpezy_tpu.codec import jax_codec as JC
from jpezy_tpu.codec import oracle
from jpezy_tpu.runtime import ppm
from jpezy_tpu_torch.codec import torch_codec as TC

from test_torch_host_copies import host_runtime  # noqa: F401 (autouse)

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CPU = "cpu"


@pytest.fixture(scope="module")
def batch2():
    from imagegen import make_test_image

    return np.stack([make_test_image(64, 64, seed=80 + i) for i in range(2)])


@pytest.fixture(scope="module")
def fast_streams(batch2):
    return (TC.encode_batch(batch2, device=CPU),
            JC.encode_batch(batch2))


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


class TestEncodeExact:
    @pytest.mark.parametrize("kw", [
        {}, {"gray": True}, {"quality": 50}, {"rounded": True},
    ], ids=["plain", "gray", "quality50", "rounded"])
    def test_byte_identical_to_jax(self, batch2, kw):
        got = TC.encode_batch(batch2, precision="exact", device=CPU, **kw)
        assert got == JC.encode_batch(batch2, precision="exact", **kw)

    def test_noise_overflow_byte_identical(self):
        rng = np.random.default_rng(11)
        noise = rng.integers(0, 256, (256, 256, 3), np.uint8)
        ticket = TC.encode_batch_dispatch(noise[None], precision="exact",
                                          device=CPU)
        maxw = ticket["combined"].shape[1] - 1
        assert int(ticket["combined"][0, 0]) > 32 * maxw  # host splice path
        got = TC.encode_batch_finish(ticket)[0]
        assert got == oracle.encode(noise[..., 0], noise[..., 1],
                                    noise[..., 2])

    def test_golden_small(self):
        _, _, _, rgb = ppm.read(os.path.join(FIXDIR, "golden_small.ppm"))
        with open(os.path.join(FIXDIR, "golden_small.jpg"), "rb") as f:
            want = f.read()
        got = TC.encode_batch(rgb[None], precision="exact", device=CPU)[0]
        assert got == want


class TestEncodeFast:
    def test_identical_or_psnr_within_005db(self, batch2, fast_streams):
        from PIL import Image

        got, ref = fast_streams
        # observed on these images: both streams byte-identical to JAX's
        for g, r, img in zip(got, ref, batch2):
            assert g[:2] == b"\xff\xd8" and g[-2:] == b"\xff\xd9"
            if g == r:
                continue
            pg = np.asarray(Image.open(io.BytesIO(g)).convert("RGB"))
            pr = np.asarray(Image.open(io.BytesIO(r)).convert("RGB"))
            assert _psnr(pg, img) >= _psnr(pr, img) - 0.05


class TestDecode:
    def test_planes_within_one_of_jax(self, fast_streams):
        streams = fast_streams[1]
        flat, kw, *_ = TC._decode_host_prep(streams, gray=False,
                                            precision="fast", transport=None)
        got = TC._decode_fused_batch_ycc420(torch.from_numpy(flat), **kw)
        ref = np.asarray(JC._decode_fused_batch_ycc420(jnp.asarray(flat), **kw))
        diff = np.abs(got.numpy().astype(np.int64) - ref.astype(np.int64))
        # observed on these images: identical planes (0 of 12288 differ)
        assert diff.max() <= 1
        assert (diff > 0).mean() <= 0.01

    def test_rgb_within_two_of_jax(self, fast_streams):
        streams = fast_streams[1]
        got, props = TC.decode_batch(streams, device=CPU)
        ref, _ = JC.decode_batch(streams)
        assert got.shape == ref.shape == (2, 64, 64, 3)
        assert (props.width, props.height) == (64, 64)
        diff = np.abs(got.astype(np.int64) - ref.astype(np.int64))
        # observed on these images: identical RGB (0 of 24576 differ)
        assert diff.max() <= 2
        assert (diff > 0).mean() <= 0.01

    def test_overflow_rows_decode(self):
        """Dense noise sends blocks through the overflow rows and the
        sentinel padding; the port must match the host decoder's planes."""
        from jpezy_tpu.codec import host_codec

        rng = np.random.default_rng(12)
        noise = rng.integers(0, 256, (1, 48, 48, 3), np.uint8)
        streams = TC.encode_batch(noise, precision="exact", device=CPU)
        flat, kw, *_ = TC._decode_host_prep(streams, gray=False,
                                            precision="fast", transport=None)
        assert any(kw["caps"])
        got = TC._decode_fused_batch_ycc420(torch.from_numpy(flat), **kw)
        ref = np.asarray(JC._decode_fused_batch_ycc420(jnp.asarray(flat), **kw))
        assert np.abs(got.numpy().astype(int) - ref.astype(int)).max() <= 1
        px, _ = TC.decode_batch(streams, device=CPU)
        host = np.stack(host_codec.decode(streams[0])[:3], -1)
        assert _psnr(px[0], noise[0]) >= _psnr(host, noise[0]) - 0.05

    def test_missing_dqt_raises(self, fast_streams):
        """A stream with its DQT stripped must raise (the JAX batch decode
        skips this check and decodes flat gray; the port does not)."""
        stripped = fast_streams[0][0]
        sos = stripped.find(b"\xff\xda")
        while (i := stripped.find(b"\xff\xdb", 0, sos)) >= 0:
            seglen = int.from_bytes(stripped[i + 2:i + 4], "big")
            stripped = stripped[:i] + stripped[i + 2 + seglen:]
            sos = stripped.find(b"\xff\xda")
        with pytest.raises(ValueError, match="not decodable"):
            TC.decode_batch([stripped], device=CPU)


class TestOptionsRun:
    """optimize and the rgb encode transport round-trip on the CPU; the
    rgb decode transport, exact and gray decode match the JAX package; a
    bad argument beside each raises ValueError."""

    @pytest.mark.parametrize("kw", [
        {"optimize": True}, {"transport": "rgb"},
    ], ids=["optimize", "rgb"])
    def test_encode_options(self, batch2, kw):
        streams = TC.encode_batch(batch2, device=CPU, **kw)
        px, _ = TC.decode_batch(streams, device=CPU)
        assert px.shape == batch2.shape
        with pytest.raises(ValueError):
            TC.encode_batch(batch2, device=CPU,
                            **dict(kw, transport="bogus"))

    @pytest.mark.parametrize("kw", [
        {"transport": "rgb"}, {"precision": "exact"}, {"gray": True},
    ], ids=["rgb", "exact", "gray"])
    def test_decode_options(self, fast_streams, kw):
        px, _ = TC.decode_batch(fast_streams[0], device=CPU, **kw)
        ref, _ = JC.decode_batch(fast_streams[0], **kw)
        assert px.shape == ref.shape
        assert np.abs(px.astype(int) - ref.astype(int)).max() <= 1
        with pytest.raises(ValueError):
            TC.decode_batch(fast_streams[0], device=CPU,
                            **dict(kw, precision="coarse"))


class TestArguments:
    def test_invalid_arguments(self, batch2):
        with pytest.raises(ValueError):
            TC.encode_batch(batch2, quality=0, device=CPU)
        with pytest.raises(ValueError):
            TC.encode_batch(batch2, restart_interval=-1, device=CPU)
        with pytest.raises(ValueError):
            TC.encode_batch(batch2[:, :40], device=CPU)

    def test_default_device_needs_cuda(self, batch2):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TC.encode_batch(batch2)
