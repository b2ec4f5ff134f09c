"""Parity of the PyTorch port's block, DCT and quantize ops with jpezy_tpu.

The same seeded numpy inputs go through the JAX function (CPU backend with
x64, as conftest.py sets) and its jpezy_tpu_torch counterpart on
device="cpu".  Integer-exact stages must be identical; the float32 DCT may
differ by one at truncation ties (summation order differs between XLA and
torch's CPU matmul), so fDCT+quantize is held to max |diff| <= 1.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from jpezy_tpu.codec import jax_codec as JC
from jpezy_tpu.codec import oracle
from jpezy_tpu.core import tables as T
from jpezy_tpu.ops import blocks as JB
from jpezy_tpu.ops import dct as JD
from jpezy_tpu.ops import quantize as JQ
from jpezy_tpu.parallel import sharded as JS
from jpezy_tpu_torch import constants as C
from jpezy_tpu_torch import device as DV
from jpezy_tpu_torch.codec import host_glue as HG
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.ops import blocks as TB
from jpezy_tpu_torch.ops import dct as TD
from jpezy_tpu_torch.ops import quantize as TQ

from test_torch_host_copies import host_runtime  # noqa: F401 (autouse)

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def ycc():
    """Two 64x64 test images as the ycc420 transport's int8 planes."""
    from imagegen import make_test_image

    rgbs = np.stack([make_test_image(64, 64, seed=40 + i) for i in range(2)])
    return HG.host_rgb_to_ycc420(rgbs)


class TestTables:
    def test_basis64_equals_jax(self):
        fwd, inv = TD._basis64()
        assert np.array_equal(fwd, JD._FWD64)
        assert np.array_equal(inv, JD._INV64)

    @pytest.mark.parametrize("quality", [None, 50])
    def test_codec_constants_equal_tables(self, quality):
        c = C.codec_constants(CPU, quality)
        yqt, cqt = (T.scale_quant_tables(quality) if quality is not None
                    else (T.Y_QUANT, T.C_QUANT))
        pairs = [
            ("zigzag", T.ZIGZAG), ("y_quant", yqt), ("c_quant", cqt),
            ("y_dc_size", T.Y_DC_SIZE), ("y_dc_code", T.Y_DC_CODE),
            ("y_ac_size", T.Y_AC_SIZE), ("y_ac_code", T.Y_AC_CODE),
            ("c_dc_size", T.C_DC_SIZE), ("c_dc_code", T.C_DC_CODE),
            ("c_ac_size", T.C_AC_SIZE), ("c_ac_code", T.C_AC_CODE),
            ("fwd_c1", oracle._FWD_C1), ("fwd_c2", oracle._FWD_C2),
            ("cu_j", oracle._CU_J), ("inv_cucv", oracle._INV_CUCV),
            ("inv_c1", oracle._INV_C1), ("inv_c2", oracle._INV_C2),
        ]
        for name, ref in pairs:
            assert np.array_equal(c[name].numpy(), np.asarray(ref)), name
        assert np.array_equal(c["fwd64_f32"].numpy(),
                              JD._FWD64.astype(np.float32))
        assert np.array_equal(c["inv64_f32"].numpy(),
                              JD._INV64.astype(np.float32))


class TestDevice:
    def test_default_cuda_never_falls_back(self):
        if torch.cuda.is_available():
            assert DV.resolve("cuda").type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                DV.resolve("cuda")

    def test_cpu_resolves(self):
        assert DV.resolve("cpu") == torch.device("cpu")

    def test_reduced_fp32_precision_refused(self):
        old = torch.get_float32_matmul_precision()
        try:
            torch.set_float32_matmul_precision("high")
            with pytest.raises(RuntimeError, match="allow_tf32|highest"):
                DV.resolve(CPU)
        finally:
            torch.set_float32_matmul_precision(old)


class TestBlocks:
    def test_blockify_identical(self):
        rng = np.random.default_rng(0)
        y = rng.integers(-128, 128, (2, 32, 48)).astype(np.int32)
        c = rng.integers(-128, 128, (2, 16, 24)).astype(np.int32)
        assert np.array_equal(TB.blockify_luma(_t(y)).numpy(),
                              np.asarray(jax.vmap(JB.blockify_luma)(y)))
        assert np.array_equal(TB.blockify_chroma(_t(c)).numpy(),
                              np.asarray(jax.vmap(JB.blockify_chroma)(c)))

    @pytest.mark.parametrize("v,h", [(2, 2), (1, 1), (1, 2)])
    def test_deblockify_identical(self, v, h):
        rng = np.random.default_rng(1)
        my, mx = 2, 3
        blocks = rng.integers(0, 256, (2, my * mx * v * h, 64)).astype(np.int32)
        got = TB.deblockify(_t(blocks), my, mx, v, h).numpy()
        for i in range(2):
            ref = np.asarray(JB.deblockify(jnp.asarray(blocks[i]), my, mx, v, h))
            assert np.array_equal(got[i], ref)


class TestDct:
    def test_forward_ordered_identical(self):
        rng = np.random.default_rng(2)
        blocks = rng.integers(-128, 128, (300, 64)).astype(np.int32)
        got = TD.forward_dct(_t(blocks), torch.float64).numpy()
        assert np.array_equal(got, np.asarray(JD.forward_dct(
            jnp.asarray(blocks), jnp.float64)))
        assert np.array_equal(got, oracle.forward_dct(blocks))

    def test_inverse_ordered_identical(self):
        rng = np.random.default_rng(3)
        coeffs = (rng.integers(-40, 41, (300, 64))
                  * rng.integers(0, 2, (300, 64))).astype(np.int32)
        coeffs[:, 0] = rng.integers(-1024, 1017, 300)
        got = TD.inverse_dct(_t(coeffs), 128, torch.float64).numpy()
        assert np.array_equal(got, np.asarray(JD.inverse_dct(
            jnp.asarray(coeffs), 128, jnp.float64)))
        assert np.array_equal(got, oracle.inverse_dct(coeffs))

    def test_inverse_fp32_within_one(self):
        rng = np.random.default_rng(4)
        coeffs = (rng.integers(-40, 41, (300, 64))
                  * rng.integers(0, 2, (300, 64))).astype(np.int32)
        got = TD.inverse_dct(_t(coeffs)).numpy()
        ref = np.asarray(JD.inverse_dct(jnp.asarray(coeffs)))
        assert np.abs(got - ref).max() <= 1


class TestQuantize:
    @pytest.mark.parametrize("chroma", [False, True])
    @pytest.mark.parametrize("rounded", [False, True])
    def test_quantize_identical(self, chroma, rounded):
        rng = np.random.default_rng(5)
        coeffs = rng.integers(-2048, 2048, (500, 64)).astype(np.int32)
        for qt in (None, T.scale_quant_tables(95)[int(chroma)]):
            got = TQ.quantize(_t(coeffs), chroma, rounded=rounded,
                              qtable=qt).numpy()
            ref = np.asarray(JQ.quantize(jnp.asarray(coeffs), chroma,
                                         rounded=rounded, qtable=qt))
            assert np.array_equal(got, ref)

    def test_dequantize_identical(self):
        rng = np.random.default_rng(6)
        coeffs = rng.integers(-127, 128, (200, 64)).astype(np.int32)
        got = TQ.dequantize(_t(coeffs), T.C_QUANT).numpy()
        assert np.array_equal(
            got, np.asarray(JQ.dequantize(jnp.asarray(coeffs), T.C_QUANT)))


class TestQuantizeLocal:
    """sharded._quantize_local_ycc (the encode front half on the main path)
    against torch_codec._quantize_local_ycc on the same int8 planes."""

    @staticmethod
    def _both(ycc, precision, **kw):
        y, cb, cr = ycc
        ref = JS._quantize_local_ycc(
            jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr),
            dtype=JC._dtype(precision), **kw)
        got = TC._quantize_local_ycc(
            _t(y), _t(cb), _t(cr), dtype=TC._dtype(precision), **kw)
        return [np.asarray(r) for r in ref], [g.numpy() for g in got]

    @pytest.mark.parametrize("kw", [
        dict(gray=False, rounded=False),
        dict(gray=True, rounded=False),
        dict(gray=False, rounded=True),
        dict(gray=False, rounded=False,
             qtables=T.scale_quant_tables(50)),
    ], ids=["plain", "gray", "rounded", "quality50"])
    def test_exact_identical(self, ycc, kw):
        ref, got = self._both(ycc, "exact", **kw)
        for r, g in zip(ref, got):
            assert np.array_equal(g, r)

    def test_fast_within_one(self, ycc):
        ref, got = self._both(ycc, "fast", gray=False, rounded=False)
        for r, g in zip(ref, got):
            assert np.abs(g - r).max() <= 1
