"""The rgb transport's colour stages and its IDCT into planes
(jpezy_tpu_torch/ops/colorspace.py: rgb_to_ycc420, planes_to_rgb;
ops/block_transform.py: idct_planes_rgb) against jpezy_tpu, the host C++
library and numpy models of the kernels' arithmetic, on the CPU.

On CUDA tensors these take the hand-written kernels of csrc/colour.cu and
csrc/exact_transforms.cu (idct_planes_rgb_kernel); on CPU tensors their
plain versions.  Here, with each tolerance stated where it is asserted:

  - rgb_to_ycc420_plain equals eager JAX rgb_to_ycc + decimate_420 and the
    host C++ rgb_to_ycc420 exactly at float64, is within 1 of JAX at
    float32, and equals a numpy model of the kernel's expression (one
    rounding an operation, float32 constants rounded from the double
    literals) at both precisions; every one of the 2^24 RGB triples fits
    int8 at both precisions;
  - planes_to_rgb_plain equals eager JAX upsample_nearest + ycc_to_rgb (or
    clamp_gray) and the host C++ ycc_to_rgb_i32 exactly at float64 for
    4:2:0, 4:2:2, 4:4:4, 4:1:1, a 3x horizontal factor, an upsampled luma,
    one component and gray, on samples past both clamps; within 1 of JAX
    at float32; equal to the numpy model of the kernel at both precisions;
  - idct_planes_rgb_model (the fast kernel's ascending float32 sums) is
    within 1 of idct_planes_rgb_plain's matrix product and of JAX's
    planes, with the share that differs bounded;
  - _quantize_batch_rgb and _decode_fused_batch give on the CPU exactly
    what the compositions they replaced gave, fast and exact, colour and
    gray;
  - CPU tensors build and launch nothing, and the CUDA wrappers refuse
    what they do not take before anything is built.

tests/test_torch_cuda.py and chip_smoke.py hold the kernels to these plain
versions and the model bit for bit on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpezy_tpu.ops import blocks as JB
from jpezy_tpu.ops import colorspace as JCS
from jpezy_tpu.ops import dct as JD
from jpezy_tpu.ops import quantize as JQ
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.core import tables as T
from jpezy_tpu_torch.ops import block_transform as BT
from jpezy_tpu_torch.ops import blocks as TB
from jpezy_tpu_torch.ops import colorspace as TCS
from jpezy_tpu_torch.ops import colour_cuda, exact_cuda
from jpezy_tpu_torch.runtime import native
from jpezy_tpu_torch.testing import colour_sets as CS
from jpezy_tpu_torch.testing import exact_ties as XT

from test_torch_host_copies import host_runtime  # noqa: F401 (autouse)

CPU = "cpu"
F32, F64 = torch.float32, torch.float64


def _img(h, w, seed):
    from imagegen import make_test_image

    return make_test_image(h, w, seed=seed)


def _rgb_batch(h, w, seed):
    """A test image and a uniform noise image, [2, h, w, 3] uint8."""
    noise = np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                 dtype=np.uint8)
    return np.stack([_img(h, w, seed), noise])


# ---------------------------------------------------------------------------
# numpy models of the colour kernels' expressions
# ---------------------------------------------------------------------------


def _encode_model(rgb, real):
    """csrc/colour.cu's rgb_to_ycc420_kernel in numpy: every product and
    sum rounded to `real` (np.float32 or np.float64), the constants the
    double literals rounded to it, truncated toward zero."""
    c = {k: real(v) for k, v in dict(yr=0.2990, yg=0.5870, yb=0.1140,
                                     br=0.1687, bg=0.3313, half=0.5000,
                                     rg=0.4187, rb=0.0813, off=128.0).items()}
    r, g, b = (rgb[..., i].astype(real) for i in range(3))
    y = ((c["yr"] * r + c["yg"] * g) + c["yb"] * b) - c["off"]
    rq, gq, bq = r[:, ::2, ::2], g[:, ::2, ::2], b[:, ::2, ::2]
    cb = (-(c["br"] * rq) - c["bg"] * gq) + c["half"] * bq
    cr = (c["half"] * rq - c["rg"] * gq) - c["rb"] * bq
    return tuple(np.trunc(v).astype(np.int32) for v in (y, cb, cr))


def _decode_model(up, gray, real):
    """ycc_planes_to_rgb_kernel in numpy on upsampled int32 planes."""
    if gray:
        return np.clip(up[0], 0, 255).astype(np.uint8)[..., None]
    y, cb, cr = (p.astype(real) for p in up)
    k = {n: real(v) for n, v in dict(rv=1.4020, gu=0.3441, gv=0.7139,
                                     bu=1.7718, off=128.0).items()}
    cbm, crm = cb - k["off"], cr - k["off"]
    rgb = (y + crm * k["rv"], (y - cbm * k["gu"]) - crm * k["gv"],
           y + cbm * k["bu"])
    return np.stack([np.clip(np.trunc(v), 0, 255).astype(np.uint8)
                     for v in rgb], -1)


# ---------------------------------------------------------------------------
# rgb_to_ycc420
# ---------------------------------------------------------------------------

SHAPES = [(64, 128), (48, 32)]


def _jax_ycc420(rgb, dtype):
    """Eager JAX rgb_to_ycc, then decimate_420 image by image, as int32."""
    y, cb, cr = JCS.rgb_to_ycc(jnp.asarray(rgb[..., 0]),
                               jnp.asarray(rgb[..., 1]),
                               jnp.asarray(rgb[..., 2]), dtype)
    dec = [np.stack([np.asarray(JB.decimate_420(c[i]))
                     for i in range(rgb.shape[0])]) for c in (cb, cr)]
    return (np.asarray(y), *dec)


@pytest.mark.parametrize("hw", SHAPES)
def test_rgb_to_ycc420_exact_equals_jax_host_and_model(hw):
    rgb = _rgb_batch(*hw, seed=hw[0])
    got = TCS.rgb_to_ycc420_plain(torch.from_numpy(rgb), F64)
    assert [g.dtype for g in got] == [torch.int8] * 3
    assert [tuple(g.shape) for g in got] == [
        (2, *hw), (2, hw[0] // 2, hw[1] // 2), (2, hw[0] // 2, hw[1] // 2)]
    ref_jax = _jax_ycc420(rgb, jnp.float64)
    ref_host = native.rgb_to_ycc420(rgb)
    ref_model = _encode_model(rgb, np.float64)
    for g, j, h, m in zip(got, ref_jax, ref_host, ref_model):
        g = g.numpy().astype(np.int32)
        # exact: the reference's double arithmetic everywhere, tolerance 0
        assert np.array_equal(g, j)
        assert np.array_equal(g, h.astype(np.int32))
        assert np.array_equal(g, m)


@pytest.mark.parametrize("hw", SHAPES)
def test_rgb_to_ycc420_fast_within_one_of_jax_equal_to_model(hw):
    rgb = _rgb_batch(*hw, seed=hw[1])
    got = TCS.rgb_to_ycc420_plain(torch.from_numpy(rgb), F32)
    for g, j, m in zip(got, _jax_ycc420(rgb, jnp.float32),
                       _encode_model(rgb, np.float32)):
        g = g.numpy().astype(np.int32)
        # JAX's float32 is free to fuse and reorder: within 1 of it; the
        # kernel's expression (the model) is torch's own: equal
        assert np.abs(g - j).max() <= 1
        assert np.array_equal(g, m)


def test_every_rgb_triple_fits_int8():
    """Over all 2^24 RGB triples, in four chunks: Y - 128 in -128..127,
    Cb and Cr in -127..127, at float32 and float64, so the int8 planes
    hold the int32 values unchanged."""
    lo = {F32: [0, 0, 0], F64: [0, 0, 0]}
    hi = {F32: [0, 0, 0], F64: [0, 0, 0]}
    for chunk in range(4):
        v = torch.arange(chunk << 22, (chunk + 1) << 22, dtype=torch.int32)
        r, g, b = ((v >> s) & 0xFF for s in (16, 8, 0))
        r, g, b = (x.to(torch.uint8) for x in (r, g, b))
        for dt in (F32, F64):
            for i, c in enumerate(TCS.rgb_to_ycc(r, g, b, dt)):
                lo[dt][i] = min(lo[dt][i], int(c.min()))
                hi[dt][i] = max(hi[dt][i], int(c.max()))
    for dt in (F32, F64):
        assert lo[dt][0] == -128 and hi[dt][0] == 127
        assert lo[dt][1:] == [-127, -127] and hi[dt][1:] == [127, 127]


def test_rgb_to_ycc420_dispatch_on_cpu_is_plain_and_launches_nothing():
    rgb = torch.from_numpy(_rgb_batch(32, 48, seed=7))
    before = colour_cuda.rgb_to_ycc420_launches
    for dt in (F32, F64):
        got = TCS.rgb_to_ycc420(rgb, dt)
        for g, w in zip(got, TCS.rgb_to_ycc420_plain(rgb, dt)):
            assert torch.equal(g, w)
    assert colour_cuda.rgb_to_ycc420_launches == before
    assert colour_cuda.LIB.handle is None


# ---------------------------------------------------------------------------
# planes_to_rgb
# ---------------------------------------------------------------------------

SAMPLINGS = CS.SAMPLINGS
OUT_HW = (24, 48)    # every factor of SAMPLINGS divides it


def _planes(dups, seed, n=2):
    """CS.sampling_planes as numpy: int32 planes covering OUT_HW, samples
    from -400 to 699, past both clamps."""
    return [p.numpy() for p in CS.sampling_planes(dups, n, *OUT_HW, seed)]


_geom = CS.geom_of


def _up(p, dy, dx):
    return np.repeat(np.repeat(p, dy, axis=1), dx, axis=2)


@pytest.mark.parametrize("label", list(SAMPLINGS))
def test_planes_to_rgb_exact_equals_jax_host_and_model(label):
    dups, gray = SAMPLINGS[label]
    planes = _planes(dups, seed=len(label))
    used = planes[:1] if gray else planes
    got = TCS.planes_to_rgb_plain([torch.from_numpy(p) for p in used],
                                  _geom(dups), gray, F64).numpy()
    assert got.shape == (2, *OUT_HW, 1 if gray else 3)
    up = [np.stack([np.asarray(JB.upsample_nearest(jnp.asarray(p[i]), dy, dx))
                    for i in range(2)]) for p, (dy, dx) in zip(used, dups)]
    if gray:
        ref = np.asarray(JCS.clamp_gray(jnp.asarray(up[0]),
                                        jnp.float64))[..., None]
    else:
        ref = np.stack([np.asarray(c) for c in JCS.ycc_to_rgb(
            *(jnp.asarray(u) for u in up), jnp.float64)], -1)
        host = np.stack([native.ycc_to_rgb_i32(*(u[i] for u in up))
                         for i in range(2)])
        assert np.array_equal(got, host)  # exact: tolerance 0
    assert np.array_equal(got, ref)
    assert np.array_equal(got, _decode_model(up, gray, np.float64))
    # both clamps were reached
    assert got.min() == 0 and got.max() == 255


@pytest.mark.parametrize("label", list(SAMPLINGS))
def test_planes_to_rgb_fast_within_one_of_jax_equal_to_model(label):
    dups, gray = SAMPLINGS[label]
    planes = _planes(dups, seed=100 + len(label))
    used = planes[:1] if gray else planes
    got = TCS.planes_to_rgb_plain([torch.from_numpy(p) for p in used],
                                  _geom(dups), gray, F32).numpy()
    up = [_up(p, dy, dx) for p, (dy, dx) in zip(used, dups)]
    if gray:
        ref = np.asarray(JCS.clamp_gray(jnp.asarray(up[0]),
                                        jnp.float32))[..., None]
    else:
        ref = np.stack([np.asarray(c) for c in JCS.ycc_to_rgb(
            *(jnp.asarray(u) for u in up), jnp.float32)], -1)
    # JAX's float32 may fuse and reorder: within 1; the model is the
    # kernel's expression, torch's own order: equal
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert np.array_equal(got, _decode_model(up, gray, np.float32))


def test_planes_to_rgb_dispatch_on_cpu_is_plain_and_launches_nothing():
    dups, _ = SAMPLINGS["4:2:0"]
    planes = [torch.from_numpy(p) for p in _planes(dups, seed=3)]
    before = colour_cuda.ycc_planes_to_rgb_launches
    for dt in (F32, F64):
        for gray in (False, True):
            used = planes[:1] if gray else planes
            assert torch.equal(
                TCS.planes_to_rgb(used, _geom(dups), gray, dt),
                TCS.planes_to_rgb_plain(used, _geom(dups), gray, dt))
    assert colour_cuda.ycc_planes_to_rgb_launches == before
    assert colour_cuda.LIB.handle is None


# ---------------------------------------------------------------------------
# idct_planes_rgb: the fast kernel's model against the plain product and JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rgb_uploads():
    """The rgb transport's coefficient uploads of two 64x128 test images
    at Annex K and of two noise images at quality 100 (dense blocks,
    large values), with their decode kwargs."""
    out = {}
    for label, rgb, quality in (
            ("test images", np.stack([_img(64, 128, 40 + i)
                                      for i in range(2)]), None),
            ("noise at quality 100", np.random.default_rng(41).integers(
                0, 256, (2, 64, 128, 3), dtype=np.uint8), 100)):
        streams = TC.encode_batch(rgb, quality=quality, device=CPU)
        pjs, geom, level = TC._parse_batch(streams)
        coeff, kw = TC._rgb_host_prep(pjs, geom, level, gray=False,
                                      precision="fast")
        out[label] = (coeff, kw)
    return out


def _jax_planes(coeff, geom, sizes, qtuple, level, gray):
    """JAX's _decode_fused_batch up to the upsampling, eagerly: dequantize,
    the float32 inverse_dct, deblockify image by image."""
    planes, off = [], 0
    for n_b, qt, g in zip(sizes[:1] if gray else sizes, qtuple, geom):
        blk = jnp.asarray(coeff[:, off:off + n_b].reshape(-1, 64))
        off += n_b
        spat = np.asarray(JD.inverse_dct(JQ.dequantize(blk, np.array(qt)),
                                         level, jnp.float32))
        spat = spat.reshape(coeff.shape[0], n_b, 64)
        planes.append(np.stack([np.asarray(JB.deblockify(
            jnp.asarray(s), *g[:4])) for s in spat]))
    return planes


def _layout_sets(rgb_uploads):
    for label, (coeff, kw) in rgb_uploads.items():
        my, mx = kw["geom"][0][:2]
        for lay, (geom, sizes, gray) in XT.upload_layouts(my, mx).items():
            for level in (128, 2048):
                yield (f"{label} as {lay}, level {level}", coeff,
                       dict(geom=geom, sizes=sizes, gray=gray, level=level,
                            qtuple=kw["qtuple"][:len(sizes)]))


def test_idct_rgb_model_within_one_of_plain_and_jax(rgb_uploads):
    for label, coeff, kw in _layout_sets(rgb_uploads):
        model = BT.idct_planes_rgb_model(coeff, **kw)
        plain = BT.idct_planes_rgb_plain(torch.from_numpy(coeff),
                                         dtype=F32, **kw)
        jax_p = _jax_planes(coeff, kw["geom"], kw["sizes"], kw["qtuple"],
                            kw["level"], kw["gray"])
        assert len(model) == len(plain) == len(jax_p) == (
            1 if kw["gray"] else len(kw["sizes"])), label
        for m, p, j in zip(model, plain, jax_p):
            assert m.dtype == np.int32 and m.shape == tuple(p.shape), label
            # the same float32 terms summed in another order (the model
            # ascending, the plain version and JAX in their BLAS order):
            # within 1, and differing on at most 1e-3 of the samples
            for other in (p.numpy(), j):
                d = np.abs(m.astype(np.int64) - other)
                assert d.max() <= 1 and (d > 0).mean() <= 1e-3, label


def test_idct_planes_rgb_dispatch_on_cpu(rgb_uploads):
    coeff, kw = rgb_uploads["test images"]
    src = torch.from_numpy(coeff)
    before = (exact_cuda.idct_rgb_launches, exact_cuda.idct_exact_launches)
    args = {k: kw[k] for k in ("geom", "level", "gray", "sizes", "qtuple")}
    for precision, dt in (("fast", F32), ("exact", F64)):
        got = BT.idct_planes_rgb(src, precision=precision, **args)
        want = BT.idct_planes_rgb_plain(src, dtype=dt, **args)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (exact_cuda.idct_rgb_launches,
            exact_cuda.idct_exact_launches) == before
    with pytest.raises(ValueError, match="precision"):
        BT.idct_planes_rgb(src, precision="half", **args)


# ---------------------------------------------------------------------------
# the rgb transport's programs against the compositions they replaced
# ---------------------------------------------------------------------------


def _old_quantize_batch_rgb(rgb, *, gray, precision, rounded=False,
                            quality=None):
    """_quantize_batch_rgb as it was: rgb_to_ycc to int32 planes,
    decimate_420 views, then the fDCT and quantize."""
    dt = TC._dtype(precision)
    y, cb, cr = TCS.rgb_to_ycc(rgb[..., 0], rgb[..., 1], rgb[..., 2], dt)
    return TC._quantize_local_ycc(
        y, TB.decimate_420(cb), TB.decimate_420(cr), gray=gray, dtype=dt,
        rounded=rounded, qtables=TC._qtables(quality, rgb.device))


def _old_decode_fused_batch(coeff_all, *, geom, level, gray, precision,
                            sizes, qtuple):
    """_decode_fused_batch as it was: the plain IDCT into planes (exact
    mode's ordered sums), upsample_nearest, then colour or the clamp."""
    dt = TC._dtype(precision)
    spats = BT.idct_planes_rgb_plain(coeff_all, geom=geom, level=level,
                                     gray=gray, sizes=sizes, qtuple=qtuple,
                                     dtype=dt)
    planes = [TB.upsample_nearest(p, g[4], g[5]) for p, g in zip(spats, geom)]
    if gray:
        return TCS.clamp_gray(planes[0], dt)[..., None]
    r, g, b = TCS.ycc_to_rgb(planes[0], planes[1], planes[2], dt)
    return torch.stack([r, g, b], dim=-1)


@pytest.mark.parametrize("precision", ["fast", "exact"])
@pytest.mark.parametrize("gray", [False, True])
def test_quantize_batch_rgb_equals_the_old_composition(precision, gray):
    rgb = torch.from_numpy(_rgb_batch(32, 64, seed=9))
    for kw in (dict(), dict(quality=95, rounded=True)):
        got = TC._quantize_batch_rgb(rgb, gray=gray, precision=precision,
                                     **kw)
        want = _old_quantize_batch_rgb(rgb, gray=gray, precision=precision,
                                       **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("precision", ["fast", "exact"])
@pytest.mark.parametrize("gray", [False, True])
def test_decode_fused_batch_equals_the_old_composition(rgb_uploads,
                                                       precision, gray):
    for coeff, kw in rgb_uploads.values():
        kw = dict(kw, gray=gray, precision=precision)
        src = torch.from_numpy(coeff)
        got = TC._decode_fused_batch(src, **kw)
        assert got.dtype == torch.uint8
        assert torch.equal(got, _old_decode_fused_batch(src, **kw))


def test_decode_fused_batch_other_samplings_equal_the_old_composition():
    """The upload read as 4:2:2, 4:4:4 and one component, with the dups
    their frames would carry."""
    coeff = np.random.default_rng(5).integers(-60, 60, (2, 6 * 8, 64),
                                              dtype=np.int16)
    q = tuple(int(x) for x in T.Y_QUANT)
    for geom, sizes, gray in (
            (((2, 2, 1, 2, 1, 1), (2, 2, 1, 1, 1, 2), (2, 2, 1, 1, 1, 2)),
             (8, 4, 4), False),
            (((2, 4, 1, 1, 1, 1),) * 3, (8, 8, 8), False),
            (((4, 6, 1, 1, 1, 1),), (24,), True)):
        for precision in ("fast", "exact"):
            kw = dict(geom=geom, level=128, gray=gray, precision=precision,
                      sizes=sizes, qtuple=(q,) * len(sizes))
            src = torch.from_numpy(coeff[:, :sum(sizes)].copy())
            assert torch.equal(TC._decode_fused_batch(src, **kw),
                               _old_decode_fused_batch(src, **kw))


# ---------------------------------------------------------------------------
# the CUDA wrappers refuse before building
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad, match", [
    (torch.zeros((1, 16, 16, 3), dtype=torch.uint8), "CUDA"),
    (torch.zeros((1, 16, 16, 3), dtype=torch.int32), "uint8"),
    (torch.zeros((1, 16, 24, 3), dtype=torch.uint8), "multiples of 16"),
    (torch.zeros((1, 24, 16, 3), dtype=torch.uint8), "multiples of 16"),
    (torch.zeros((16, 16, 3), dtype=torch.uint8), r"\[N, H, W, 3\]"),
    (torch.zeros((1, 16, 16, 4), dtype=torch.uint8), r"\[N, H, W, 3\]"),
])
def test_rgb_to_ycc420_cuda_refuses_before_building(bad, match):
    with pytest.raises(ValueError, match=match):
        colour_cuda.rgb_to_ycc420_cuda(bad)
    with pytest.raises(ValueError, match="float32 or float64"):
        colour_cuda.rgb_to_ycc420_cuda(bad, torch.float16)
    assert colour_cuda.LIB.handle is None


def _i32(*shape):
    return torch.zeros(shape, dtype=torch.int32)


@pytest.mark.parametrize("planes, dups, gray, match", [
    ([_i32(1, 16, 16)] * 3, [(1, 1)] * 3, False, "CUDA"),
    ([_i32(1, 16, 16)] * 2, [(1, 1)] * 2, False, "want 3"),
    ([_i32(1, 16, 16)] * 3, [(1, 1)] * 3, True, r"want 1 .*\(gray\)"),
    ([_i32(1, 16, 16), _i32(1, 16, 4), _i32(1, 16, 4)],
     [(1, 1), (1, 4), (1, 5)], False, "factors 1 to 4"),
    ([_i32(1, 16, 20), _i32(1, 16, 4), _i32(1, 16, 4)],
     [(1, 1), (1, 5), (1, 5)], False, "factors 1 to 4"),
    ([_i32(1, 16, 16), _i32(1, 8, 8), _i32(1, 8, 4)],
     [(1, 1), (2, 2), (2, 2)], False, "does not cover"),
    ([_i32(1, 16, 16).to(torch.int16), _i32(1, 8, 8), _i32(1, 8, 8)],
     [(1, 1), (2, 2), (2, 2)], False, "int32"),
    ([_i32(1, 16, 6)], [(1, 1)], True, "multiple of 4"),
    ([_i32(16, 16)], [(1, 1)], True, r"\[N, rows, cols\]"),
])
def test_ycc_planes_to_rgb_cuda_refuses_before_building(planes, dups, gray,
                                                        match):
    with pytest.raises(ValueError, match=match):
        colour_cuda.ycc_planes_to_rgb_cuda(planes, dups, gray=gray)
    assert colour_cuda.LIB.handle is None


def test_idct_planes_rgb_cuda_refuses_before_building():
    coeff = torch.zeros((1, 6, 64), dtype=torch.int16)
    q = torch.ones((3, 64), dtype=torch.int32)
    geom = ((1, 1, 2, 2, 1, 1), (1, 1, 1, 1, 2, 2), (1, 1, 1, 1, 2, 2))
    kw = dict(geom=geom, level=128, gray=False, sizes=(4, 1, 1))
    cases = [
        ((coeff, q), kw, "CUDA"),
        ((coeff.to(torch.int8), q), kw, "int16 or int32"),
        ((coeff[0], q), kw, r"\[N, sum\(sizes\), 64\]"),
        ((coeff, q), dict(kw, sizes=(4, 1)), "same 1 to 3"),
        ((coeff, q), dict(kw, geom=((1, 1, 5, 1, 1, 1),) + geom[1:],
                          sizes=(5, 1, 0)), "does not hold"),
    ]
    for args, kwargs, match in cases:
        with pytest.raises(ValueError, match=match):
            exact_cuda.idct_planes_rgb_cuda(*args, **kwargs)
    assert exact_cuda.LIB.handle is None
