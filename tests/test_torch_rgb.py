"""The rgb transports, exact-mode, gray and any-sampling decode of
jpezy_tpu_torch against jpezy_tpu.

Colour conversion keeps the JAX package's expression order, so float64
is bit-exact: exact-mode rgb-transport streams must be byte-identical to
jax_codec's rgb transport and to the port's own ycc420 transport (the
host's float64 conversion), and exact-mode rgb decodes (colour, gray,
PIL-written 4:4:4, 4:2:2 and 1-component streams) pixel-identical to
jax_codec and to host_codec (tolerance 0).  Fast mode converts in float32;
XLA on the CPU may contract a multiply and an add where eager torch does
not, so quantized coefficients may differ by +-1 at truncation ties
(decoded PSNR within 0.05 dB of the JAX streams'), and fast rgb decodes by
+-1 per sample.
"""
import io

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jpezy_tpu.codec import jax_codec as JC
from jpezy_tpu.ops import blocks as JB
from jpezy_tpu.ops import colorspace as JCS
from jpezy_tpu_torch.codec import host_codec
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.ops import blocks as TB
from jpezy_tpu_torch.ops import colorspace as TCS

from test_torch_host_copies import host_runtime  # noqa: F401 (autouse)

CPU = "cpu"
F32, F64 = torch.float32, torch.float64


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def batch2():
    from imagegen import make_test_image

    return np.stack([make_test_image(64, 64, seed=230 + i) for i in range(2)])


@pytest.fixture(scope="module")
def exact_streams(batch2):
    return TC.encode_batch(batch2, precision="exact", device=CPU)


def _planes(seed, shape, lo, hi):
    rng = np.random.default_rng(seed)
    return [rng.integers(lo, hi, shape).astype(np.int32) for _ in range(3)]


class TestColorspace:
    def test_rgb_to_ycc_exact(self):
        r, g, b = _planes(1, (3, 40, 24), 0, 256)
        got = TCS.rgb_to_ycc(*(torch.from_numpy(x).to(torch.uint8)
                               for x in (r, g, b)), F64)
        ref = JCS.rgb_to_ycc(*(jnp.asarray(x.astype(np.uint8))
                               for x in (r, g, b)), jnp.float64)
        for x, y in zip(got, ref):
            assert x.dtype == torch.int32
            assert np.array_equal(x.numpy(), np.asarray(y))

    def test_ycc_to_rgb_exact(self):
        y, cb, cr = _planes(2, (3, 40, 24), -200, 460)
        got = TCS.ycc_to_rgb(*(torch.from_numpy(x) for x in (y, cb, cr)), F64)
        ref = JCS.ycc_to_rgb(*(jnp.asarray(x) for x in (y, cb, cr)),
                             jnp.float64)
        for x, z in zip(got, ref):
            assert x.dtype == torch.uint8
            assert np.array_equal(x.numpy(), np.asarray(z))
        gray = TCS.clamp_gray(torch.from_numpy(y), F64)
        assert np.array_equal(gray.numpy(), np.asarray(
            JCS.clamp_gray(jnp.asarray(y), jnp.float64)))

    def test_fast_within_one(self):
        r, g, b = _planes(3, (2, 64, 64), 0, 256)
        got = TCS.rgb_to_ycc(*(torch.from_numpy(x) for x in (r, g, b)), F32)
        ref = JCS.rgb_to_ycc(*(jnp.asarray(x) for x in (r, g, b)))
        for x, z in zip(got, ref):
            assert np.abs(x.numpy() - np.asarray(z)).max() <= 1
        y, cb, cr = _planes(4, (2, 64, 64), -100, 360)
        got = TCS.ycc_to_rgb(*(torch.from_numpy(x) for x in (y, cb, cr)), F32)
        ref = JCS.ycc_to_rgb(*(jnp.asarray(x) for x in (y, cb, cr)))
        for x, z in zip(got, ref):
            assert np.abs(x.numpy().astype(int) - np.asarray(z)).max() <= 1


class TestBlocks:
    @pytest.mark.parametrize("ph,pw", [(48, 32), (40, 17), (33, 64)])
    def test_pad_replicate(self, ph, pw):
        x = _planes(5, (2, 33, 17), -128, 128)[0]
        got = TB.pad_replicate(torch.from_numpy(x), ph, pw).numpy()
        for i in range(2):
            assert np.array_equal(got[i], np.asarray(
                JB.pad_replicate(jnp.asarray(x[i]), ph, pw)))

    @pytest.mark.parametrize("dup", [(1, 1), (2, 1), (1, 2), (2, 2)])
    def test_upsample_nearest(self, dup):
        x = _planes(6, (2, 8, 16), 0, 256)[0]
        got = TB.upsample_nearest(torch.from_numpy(x), *dup).numpy()
        for i in range(2):
            assert np.array_equal(got[i], np.asarray(
                JB.upsample_nearest(jnp.asarray(x[i]), *dup)))

    def test_decimate_420(self):
        x = _planes(7, (2, 32, 48), -128, 128)[0]
        got = TB.decimate_420(torch.from_numpy(x)).numpy()
        for i in range(2):
            assert np.array_equal(got[i], np.asarray(
                JB.decimate_420(jnp.asarray(x[i]))))


class TestRgbEncode:
    @pytest.mark.parametrize("kw", [{}, {"restart_interval": 2}],
                             ids=["plain", "restart2"])
    def test_exact_equals_jax_rgb_transport(self, batch2, kw):
        got = TC.encode_batch(batch2, precision="exact", transport="rgb",
                              device=CPU, **kw)
        assert got == JC.encode_batch(batch2, precision="exact",
                                      transport="rgb", **kw)

    @pytest.mark.parametrize("kw", [
        {}, {"gray": True}, {"quality": 70}, {"rounded": True},
        {"restart_interval": 3},
    ], ids=["plain", "gray", "quality70", "rounded", "restart3"])
    def test_exact_equals_ycc420_transport(self, batch2, kw):
        got = TC.encode_batch(batch2, precision="exact", transport="rgb",
                              device=CPU, **kw)
        assert got == TC.encode_batch(batch2, precision="exact", device=CPU,
                                      **kw)

    def test_fast_coefficients_within_one(self, batch2):
        got = TC._quantize_batch_rgb(torch.from_numpy(batch2))
        for i, im in enumerate(batch2):
            ref = JC.quantize_planes(
                jnp.asarray(im[..., 0]), jnp.asarray(im[..., 1]),
                jnp.asarray(im[..., 2]), ph=64, pw=64, gray=False)
            for g, r in zip(got, ref):
                d = np.abs(g[i].numpy() - np.asarray(r))
                assert d.max() <= 1 and (d > 0).mean() < 0.01

    def test_fast_psnr_within_005db_of_jax(self, batch2):
        got = TC.encode_batch(batch2, transport="rgb", device=CPU)
        ref = JC.encode_batch(batch2, transport="rgb")
        for s_got, s_ref, im in zip(got, ref, batch2):
            a = np.stack(host_codec.decode(s_got)[:3], -1)
            b = np.stack(host_codec.decode(s_ref)[:3], -1)
            assert abs(_psnr(a, im) - _psnr(b, im)) <= 0.05

    def test_unknown_transport_raises(self, batch2):
        with pytest.raises(ValueError, match="transport"):
            TC.encode_batch(batch2, transport="planes", device=CPU)


class TestRgbDecode:
    def test_exact_equals_jax_and_host(self, exact_streams):
        got, props = TC.decode_batch(exact_streams, precision="exact",
                                     device=CPU)
        ref, _ = JC.decode_batch(exact_streams, precision="exact")
        assert got.shape == (2, 64, 64, 3) and got.dtype == np.uint8
        assert np.array_equal(got, ref)
        for s, px in zip(exact_streams, got):
            assert np.array_equal(px, np.stack(host_codec.decode(s)[:3], -1))

    def test_fast_rgb_within_one_of_jax(self, exact_streams):
        got, _ = TC.decode_batch(exact_streams, transport="rgb", device=CPU)
        ref, _ = JC.decode_batch(exact_streams, transport="rgb")
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1

    def test_gray_exact_equals_jax(self, exact_streams):
        got, _ = TC.decode_batch(exact_streams, gray=True, precision="exact",
                                 device=CPU)
        ref, _ = JC.decode_batch(exact_streams, gray=True, precision="exact")
        assert np.array_equal(got, ref)
        assert np.array_equal(got[..., 0], got[..., 2])

    def test_auto_picks(self, exact_streams):
        for kw, want in ((dict(), "ycc420"), (dict(gray=True), "rgb"),
                         (dict(precision="exact"), "rgb"),
                         (dict(transport="rgb"), "rgb")):
            assert TC.decode_batch_dispatch(exact_streams, device=CPU,
                                            **kw)[0] == want

    @pytest.mark.parametrize("kw", [
        dict(transport="ycc420", gray=True),
        dict(transport="device", precision="exact"),
        dict(transport="indexed", gray=True),
    ], ids=["ycc420-gray", "device-exact", "indexed-gray"])
    def test_ineligible_transport_raises(self, exact_streams, kw):
        with pytest.raises(ValueError, match="4:2:0"):
            TC.decode_batch(exact_streams, device=CPU, **kw)


def _pil_streams(**kw):
    PIL = pytest.importorskip("PIL.Image")
    from imagegen import make_test_image

    gray_mode = kw.pop("gray_mode", False)
    out = []
    for seed in (240, 241):
        im = make_test_image(40, 24, seed=seed)
        if gray_mode:
            pil = PIL.fromarray(im[..., 0], mode="L")
        else:
            pil = PIL.fromarray(im)
        buf = io.BytesIO()
        pil.save(buf, "JPEG", **kw)
        out.append(buf.getvalue())
    return out


class TestForeignStreams:
    @pytest.mark.parametrize("kind", ["444", "422", "gray"])
    def test_exact_equals_jax(self, kind):
        kw = {"444": dict(subsampling=0, quality=80),
              "422": dict(subsampling=1, quality=80),
              "gray": dict(quality=80)}[kind]
        streams = _pil_streams(gray_mode=kind == "gray", **kw)
        got, props = TC.decode_batch(streams, precision="exact", device=CPU)
        ref, _ = JC.decode_batch(streams, precision="exact")
        assert (props.width, props.height) == (24, 40)
        assert got.shape == (2, 40, 24, 3)
        assert np.array_equal(got, ref)
        if kind == "gray":
            assert np.array_equal(got[..., 0], got[..., 1])
        one = TC.decode(streams[0], precision="exact", device=CPU)
        assert np.array_equal(np.stack(one[:3], -1), ref[0])
