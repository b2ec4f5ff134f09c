"""The block transforms of jpezy_tpu_torch (ops/block_transform.py) against
jpezy_tpu, and the numpy models of the CUDA kernels against the plain
versions.

fdct_quantize (blockify, float32 fDCT, quantize) and idct_planes
(dequantize, float32 IDCT, level shift, clamp into the packed u8 planes,
from the ycc420 transport's sparse upload or the Huffman scan's dense
blocks) take the hand-written kernels of csrc/block_transforms.cu on CUDA
tensors and their plain versions on CPU tensors.  Here, on the CPU:

  - the plain versions against the JAX package's stages
    (parallel/sharded.py:_quantize_local_ycc, jax_codec.
    _decode_fused_batch_ycc420 and _decode_fused_batch_device): within 1
    where a float32 sum falls next to an integer (the two sum in other
    orders), with the share of values that differ stated and bounded, and
    identical on flat blocks and DC-only blocks, where every product is
    exact in float32;
  - the numpy models of the kernels' arithmetic (the fDCT's integer
    form, PR 9's separable one, the IDCT's ascending sums): equal to the
    plain versions exactly when both take the same float part (the layout,
    densify, overflow rows, dequantize, quantize, rounded, gray, clamp),
    within 1 with the kernels' own order, and the sparse and dense forms
    give identical planes for the same blocks;
  - the integer fDCT model (integer_forward): W_int and its three 8-bit
    digits, each digit's sum within int32 on the extreme blocks, the
    kernel's 32-bit recombination, a register-by-register model of a warp
    tile's tensor-core fragments, the DC trunc(sum / 8), within 1 of the
    64-term float32 form and of JAX, no more often off an
    extended-precision truth, and against the plain form on images whose
    components end in short tiles;
  - the separable fDCT model: its DC is the exact sum times 0.125, flat
    blocks give DC only, it is within 1 of the 64-term float32 form and of
    an extended-precision truth and no more often off the truth, and the
    folded normalisation it avoids gets flat blocks' DC wrong;
  - the sparse layout at odd MCU counts, where the Cr fields start off a
    4-byte boundary;
  - dispatch: CPU tensors launch nothing, and the CUDA wrappers refuse
    what they do not take before anything is built.

tests/test_torch_cuda.py and chip_smoke.py hold the kernels to the models
bit for bit on the card.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jpezy_tpu.codec import jax_codec as JC
from jpezy_tpu.parallel import sharded as JS
from jpezy_tpu_torch.bitstream.reader import parse
from jpezy_tpu_torch.codec import host_glue as HG
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.constants import FDCT_DIGITS, FDCT_INT
from jpezy_tpu_torch.core import tables as T
from jpezy_tpu_torch.ops import block_transform as BT
from jpezy_tpu_torch.ops import dct as D
from jpezy_tpu_torch.ops import entropy_decode as ED
from jpezy_tpu_torch.ops import transform_cuda
from jpezy_tpu_torch.testing import fdct_int as FI

from test_torch_host_copies import host_runtime  # noqa: F401 (autouse)

CPU = "cpu"
QUALITIES = (None, 50, 95)


def _img(h, w, seed):
    from imagegen import make_test_image

    return make_test_image(h, w, seed=seed)


def _flat_mcus(n, h, w, seed):
    """Images whose every 16x16 MCU is one colour: every 8x8 block of every
    component is flat after the host's 4:2:0 conversion."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, 256, (n, h // 16, w // 16, 3), dtype=np.uint8)
    return cols.repeat(16, axis=1).repeat(16, axis=2)


def _planes(rgbs):
    return HG.host_rgb_to_ycc420(rgbs)


def _tables(quality):
    return None if quality is None else T.scale_quant_tables(quality)


def _exact_inverse(deq, level):
    """The plain version's float part (torch's float32 matmul on the
    CPU): swapped into a model, only the integer parts remain to differ."""
    return D.inverse_dct(torch.from_numpy(deq), level, torch.float32).numpy()


def _exact_forward(blk):
    return D.forward_dct(torch.from_numpy(blk), torch.float32).numpy()


# ---------------------------------------------------------------------------
# fdct_quantize
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def planes():
    return _planes(np.stack([_img(128, 64, 300 + i) for i in range(2)]))


@pytest.mark.parametrize("gray", [False, True], ids=["colour", "gray"])
@pytest.mark.parametrize("rounded", [False, True], ids=["trunc", "rounded"])
@pytest.mark.parametrize("quality", QUALITIES, ids=["annexk", "q50", "q95"])
def test_fdct_plain_within_one_of_jax(planes, quality, rounded, gray):
    qt = _tables(quality)
    got = BT.fdct_quantize_plain(*(torch.from_numpy(a) for a in planes),
                                 gray=gray, rounded=rounded, qtables=qt)
    ref = JS._quantize_local_ycc(*(jnp.asarray(a) for a in planes),
                                 gray=gray, dtype=jnp.float32,
                                 rounded=rounded, qtables=qt)
    differ = total = 0
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.dtype == torch.int32 and g.shape == r.shape
        d = np.abs(g.numpy().astype(np.int64) - r)
        assert d.max() <= 1
        differ += int((d > 0).sum())
        total += d.size
    # a coefficient differs only where a float32 sum falls next to an
    # integer and the quotient crosses a step: none seen on these images
    assert differ <= total // 10000


@pytest.mark.parametrize("rounded", [False, True], ids=["trunc", "rounded"])
@pytest.mark.parametrize("quality", QUALITIES, ids=["annexk", "q50", "q95"])
def test_fdct_flat_blocks_identical_to_jax(quality, rounded):
    p = _planes(_flat_mcus(2, 64, 128, 310))
    qt = _tables(quality)
    got = BT.fdct_quantize_plain(*(torch.from_numpy(a) for a in p),
                                 gray=False, rounded=rounded, qtables=qt)
    ref = JS._quantize_local_ycc(*(jnp.asarray(a) for a in p), gray=False,
                                 dtype=jnp.float32, rounded=rounded,
                                 qtables=qt)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
        assert not g[..., 1:].any()           # flat: DC only
    model = BT.fdct_quantize_model(*p, gray=False, rounded=rounded,
                                   qtables=qt)
    assert all(np.array_equal(g.numpy(), m) for g, m in zip(got, model))


@pytest.mark.parametrize("gray", [False, True], ids=["colour", "gray"])
@pytest.mark.parametrize("rounded", [False, True], ids=["trunc", "rounded"])
@pytest.mark.parametrize("quality", QUALITIES, ids=["annexk", "q50", "q95"])
def test_fdct_model_integer_parts_equal_plain(planes, quality, rounded,
                                              gray):
    qt = _tables(quality)
    plain = BT.fdct_quantize_plain(*(torch.from_numpy(a) for a in planes),
                                   gray=gray, rounded=rounded, qtables=qt)
    model = BT.fdct_quantize_model(*planes, gray=gray, rounded=rounded,
                                   qtables=qt, transform=_exact_forward)
    for p, m in zip(plain, model):
        assert m.dtype == np.int32 and np.array_equal(p.numpy(), m)


@pytest.mark.parametrize("rounded", [False, True], ids=["trunc", "rounded"])
@pytest.mark.parametrize("quality", QUALITIES, ids=["annexk", "q50", "q95"])
def test_fdct_model_within_one_of_plain(planes, quality, rounded):
    qt = _tables(quality)
    plain = BT.fdct_quantize_plain(*(torch.from_numpy(a) for a in planes),
                                   gray=False, rounded=rounded, qtables=qt)
    model = BT.fdct_quantize_model(*planes, gray=False, rounded=rounded,
                                   qtables=qt)
    for p, m in zip(plain, model):
        assert np.abs(p.numpy().astype(np.int64) - m).max() <= 1


def test_fdct_model_float_part_within_one_of_torch():
    """The separable float32 form against torch's 64-term product on noise
    blocks of the full sample range: the truncated coefficients within
    1."""
    rng = np.random.default_rng(320)
    blk = rng.integers(-128, 128, (4096, 64)).astype(np.int32)
    d = np.abs(BT.separable_forward(blk).astype(np.int64)
               - _exact_forward(blk))
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def _forward64(blk):
    """The 64-term float32 form: the ascending sum with fwd64_f32 (the
    kernel's arithmetic before the separable one), truncated."""
    return BT.sum_ascending(blk.astype(np.float32),
                            BT._basis("fwd64_f32")).astype(np.int32)


def _forward_truth(blk):
    """The forward DCT in extended precision (np.longdouble): the cosines,
    the normalisation and the sums, truncated toward zero."""
    L = np.longdouble
    v = np.arange(8, dtype=L)[:, None]
    x = np.arange(8, dtype=L)[None, :]
    cos = np.cos((2 * x + 1) * v * L("3.14159265358979323846264338") / 16)
    c = np.ones(8, dtype=L)
    c[0] = 1 / np.sqrt(L(2))
    o = np.einsum("uy,vx,byx->buv", cos, cos,
                  blk.astype(L).reshape(-1, 8, 8)) * (np.outer(c, c) / 4)
    return np.trunc(o).reshape(-1, 64).astype(np.int32)


def _synthetic_blocks(n, seed):
    """n seeded 8x8 level-shifted blocks, a quarter each of gradients,
    oriented textures, noise and flat blocks."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:8, 0:8]
    k = n // 4

    def u(lo, hi):
        return rng.uniform(lo, hi, (k, 1, 1))

    grad = u(-128, 127) + u(-12, 12) * yy + u(-12, 12) * xx
    tex = u(-60, 60) * np.sin(u(0, 3) * xx + u(0, 3) * yy + u(0, 6)) \
        + u(-60, 60)
    noise = rng.integers(-128, 128, (k, 8, 8))
    flat = np.broadcast_to(rng.integers(-128, 128, (k, 1, 1)), (k, 8, 8))
    b = np.concatenate([grad, tex, noise, flat])
    return b.round().clip(-128, 127).astype(np.int32).reshape(-1, 64)


@pytest.fixture(scope="module")
def forward_sets(planes):
    """The test planes' blocks and 16,384 synthetic ones, with the
    separable model's, the integer model's, the 64-term form's and the
    truth's coefficients."""
    y, cb, cr = planes
    blk = np.concatenate(
        [BT._blockify(y.astype(np.int32), 2, 2).reshape(-1, 64)]
        + [BT._blockify(p.astype(np.int32), 1, 1).reshape(-1, 64)
           for p in (cb, cr)] + [_synthetic_blocks(16384, 321)])
    return {"sep": BT.separable_forward(blk), "int": BT.integer_forward(blk),
            "f64": _forward64(blk), "truth": _forward_truth(blk)}


QUANT_SETTINGS = {"annexk": (None, False), "q95": (95, False),
                  "rounded": (None, True)}


def _quantized(forward_sets, setting):
    quality, rounded = QUANT_SETTINGS[setting]
    qt = np.asarray(T.Y_QUANT if quality is None
                    else T.scale_quant_tables(quality)[0])
    return {k: BT._quantize(v, qt, rounded) for k, v in forward_sets.items()}


def test_fdct_model_dc_is_the_exact_sum():
    """The separable model's DC is sum(X) * 0.125 exactly: the cosine row
    0 is 1, every partial sum of integer samples is exact in float32 and
    S[0][0] is 0.125 exactly."""
    c = BT._basis("fdct_cos_f32")
    s = BT._basis("fdct_scale_f32")
    assert (c[0] == 1.0).all() and s[0, 0] == np.float32(0.125)
    rng = np.random.default_rng(322)
    blk = rng.integers(-128, 128, (8192, 64)).astype(np.int32)
    o = BT.separable_sums(blk, c)
    assert np.array_equal(o[:, 0, 0], blk.sum(axis=1).astype(np.float32))
    want = (blk.sum(axis=1).astype(np.float32) * np.float32(0.125))
    assert np.array_equal(BT.separable_forward(blk)[:, 0],
                          want.astype(np.int32))


def test_fdct_model_flat_blocks_dc_only():
    """Flat blocks of every level: the DC is 8 times the level (64 x / 8,
    exact) and every AC coefficient is zero."""
    levels = np.arange(-128, 128, dtype=np.int32)
    blk = np.repeat(levels[:, None], 64, axis=1)
    got = BT.separable_forward(blk)
    assert np.array_equal(got[:, 0], 8 * levels)
    assert not got[:, 1:].any()


@pytest.mark.parametrize("setting", list(QUANT_SETTINGS))
def test_fdct_model_within_one_of_64_term_and_truth(forward_sets, setting):
    """Quantized, the separable model is within 1 of the 64-term float32
    form and of the extended-precision truth, never off on a DC, and off
    the truth on at most 2e-3 of the coefficients (the card's gate against
    the plain version)."""
    q = _quantized(forward_sets, setting)
    for other in ("f64", "truth"):
        d = np.abs(q["sep"].astype(np.int64) - q[other])
        assert d.max() <= 1, other
        assert not d[:, 0].any(), other
    assert (q["sep"] != q["truth"]).mean() <= 2e-3


def test_fdct_model_error_share_against_truth(forward_sets):
    """The separable model is off the truth on at most 1.5 times as many
    quantized coefficients as the 64-term form, counted over Annex K,
    quality 95 and rounded together (Annex K alone has a few tens of
    differences in a million coefficients, too few for a ratio), and off
    as rarely before quantization."""
    sep = f64 = total = 0
    for setting in QUANT_SETTINGS:
        q = _quantized(forward_sets, setting)
        sep += int((q["sep"] != q["truth"]).sum())
        f64 += int((q["f64"] != q["truth"]).sum())
        total += q["sep"].size
    assert 0 < sep <= 1.5 * f64
    raw = {k: float((forward_sets[k] != forward_sets["truth"]).mean())
           for k in ("sep", "f64")}
    assert raw["sep"] <= 1.5 * raw["f64"] and raw["sep"] < 5e-3


def test_folded_normalisation_breaks_the_dc():
    """The pitfall the kernel avoids: folding c_u / 2 into each pass's
    cosine table (no final multiply) gets the DC of flat blocks wrong,
    because float32(1 / (2 sqrt 2)) squared is not 0.125."""
    c = np.ones(8)
    c[0] = 1 / np.sqrt(2)
    folded = (np.asarray(BT._basis("fdct_cos_f32"), np.float64)
              * c[:, None] / 2).astype(np.float32)
    levels = np.arange(-128, 128, dtype=np.int32)
    blk = np.repeat(levels[:, None], 64, axis=1)
    dc = BT.separable_sums(blk, folded)[:, 0, 0].astype(np.int32)
    wrong = dc != 8 * levels
    assert wrong.mean() > 0.25
    assert np.array_equal(BT.separable_forward(blk)[:, 0], 8 * levels)


def _f32_up(x):
    """The least float32 at or above x (a positive Fraction), exactly."""
    from fractions import Fraction

    f = np.float32(float(x))
    while Fraction(float(f)) < x:
        f = np.nextafter(f, np.float32(np.inf))
    while Fraction(float(np.nextafter(f, np.float32(0)))) >= x:
        f = np.nextafter(f, np.float32(0))
    return Fraction(float(f))


def test_division_by_reciprocal_rounded_up():
    """The kernel's quantizer (and index arithmetic) divide by multiplying
    with 1/den rounded up to float32, the product rounded up and
    truncated: for 0 < num < 2^22 that is C's num / den.  Held here in
    exact rational arithmetic on seeded quotients and on the ones next to
    every boundary: num = k den - 1, k den, k den + den - 1."""
    from fractions import Fraction

    rng = np.random.default_rng(323)
    dens = [1, 2, 3, 7, 11, 16, 99, 121, 255, 256, 509, 510, 65535]
    cases = [(int(n), int(d)) for n, d in zip(
        rng.integers(1, 1 << 22, 1500), rng.integers(1, 511, 1500))]
    for d in dens:
        for k in (1, 2, 3, 100, (1 << 22) // d - 1, (1 << 22) // d):
            cases += [(n, d) for n in (k * d - 1, k * d, k * d + d - 1)
                      if 0 < n < 1 << 22]
    for num, den in cases:
        q = _f32_up(num * _f32_up(Fraction(1, den)))
        assert int(q) == num // den, (num, den)


def test_fdct_model_reads_strided_int32_planes():
    """The rgb path's planes: int32, chroma as the column-stride-2 view of
    the decimation; the model and the plain version take them as they
    are."""
    rgb = torch.from_numpy(np.stack([_img(32, 48, 330 + i)
                                     for i in range(2)]))
    from jpezy_tpu_torch.ops import blocks as B
    from jpezy_tpu_torch.ops import colorspace as C

    y, cb, cr = C.rgb_to_ycc(rgb[..., 0], rgb[..., 1], rgb[..., 2])
    cbd, crd = B.decimate_420(cb), B.decimate_420(cr)
    assert cbd.stride()[-1] == 2 and y.dtype == torch.int32
    plain = BT.fdct_quantize_plain(y, cbd, crd, gray=False, rounded=False)
    model = BT.fdct_quantize_model(y.numpy(), cbd.numpy(), crd.numpy(),
                                   gray=False, rounded=False,
                                   transform=_exact_forward)
    assert all(np.array_equal(p.numpy(), m) for p, m in zip(plain, model))
    assert all(np.array_equal(a.numpy(), b.numpy()) for a, b in zip(
        plain, TC._quantize_batch_rgb(rgb)))


# ---------------------------------------------------------------------------
# fdct_quantize: the integer form of the kernel (integer_forward)
# ---------------------------------------------------------------------------


def test_integer_table_and_digits():
    """W_int = round(W 2^24) from the float64 forward basis, below 2^22,
    its DC column 2^21 exactly, no column's magnitudes summing past the
    DC's 2^27; the three digits are balanced signed bytes that recombine
    to W_int exactly; the kernel's B fragments (transform_cuda.
    fragment_table, 12,288 bytes) hold every digit once, at the sample
    order of transform_cuda.slot_sample, a permutation."""
    w = FDCT_INT
    assert np.array_equal(w, np.round(D._FWD64.T * 2.0 ** 24))
    assert np.abs(w).max() < 1 << 22 and (w[:, 0] == 1 << 21).all()
    # int8 samples keep every coefficient within 1,024 (the DC's bound),
    # which lets the kernel's quantizer skip div_exact's guard
    assert 128 * np.abs(w).sum(axis=0).max() == 1024 << 24
    d = FDCT_DIGITS.astype(np.int64)
    assert FDCT_DIGITS.dtype == np.int8
    assert np.array_equal(d[0] + (d[1] << 8) + (d[2] << 16), w)
    assert [int(np.abs(x).max()) for x in d] == [122, 119, 62]
    slots = np.concatenate([transform_cuda.slot_sample(j, np.arange(32))
                            for j in (0, 1)])
    assert sorted(slots.tolist()) == list(range(64))
    table = transform_cuda.fragment_table()
    assert table.shape == (3, 8, 32, 4) and table.nbytes == 12288
    got = np.sort(table.view(np.int8).reshape(3, -1), axis=1)
    assert np.array_equal(got, np.sort(FDCT_DIGITS.reshape(3, -1), axis=1))


def _integer_sets():
    rng = np.random.default_rng(350)
    levels = np.arange(-128, 128)
    return {"extreme": FI.extreme_blocks(),
            "flat": np.repeat(levels[:, None], 64, axis=1),
            "noise": rng.integers(-128, 128, (4096, 64)),
            "synthetic": _synthetic_blocks(4096, 351)}


@pytest.mark.parametrize("label", ["extreme", "flat", "noise", "synthetic"])
def test_integer_digit_sums_stay_within_int32(label):
    """Each digit's sum, the int32 accumulator of the kernel's tensor-core
    products, stays below 2^20 (so below 2^31), largest on the extreme
    blocks; recombined in the kernel's 32-bit steps it is the int64
    truncation of X W_int / 2^24, integer_forward."""
    blk = _integer_sets()[label]
    acc = BT.digit_sums(blk)
    assert np.abs(acc).max() < 1 << 20
    if label == "extreme":
        # each digit's sum reaches the largest magnitude any int8 block
        # gives it: 127 or 128 times the sums of its positive and of its
        # negative entries
        for a, d in zip(acc, FDCT_DIGITS.astype(np.int64)):
            pos, neg = np.clip(d, 0, None).sum(0), -np.clip(d, None, 0).sum(0)
            most = np.maximum(127 * pos + 128 * neg, 128 * pos + 127 * neg)
            assert np.abs(a).max() == most.max()
    assert np.array_equal(BT.recombine_digits(acc), BT.integer_forward(blk))


def test_recombine_digits_equals_int64_truncation():
    """The kernel's 32-bit recombination against trunc(A / 2^24) in int64
    on digit sums over their whole range, and on sums at the edges of a
    quotient: A = m 2^24 + r for r in {-1, 0, 1} and both signs of m."""
    rng = np.random.default_rng(352)
    acc = rng.integers(-(1 << 20), 1 << 20, (3, 200000))
    edges = []
    for m in (-64, -2, -1, 0, 1, 2, 63):
        for r in (-1, 0, 1):
            a = m * (1 << 24) + r
            a2 = int(np.clip(a // (1 << 16), -(1 << 19), (1 << 19) - 1))
            rest = a - (a2 << 16)
            a1 = rest // 256
            edges.append((rest - 256 * a1, a1, a2))
    acc = np.concatenate([acc, np.array(edges).T], axis=1)
    total = acc[0] + (acc[1] << 8) + (acc[2] << 16)
    want = np.sign(total) * (np.abs(total) >> 24)
    assert np.abs(acc[0] + (acc[1] << 8)).max() < 1 << 31
    assert np.array_equal(BT.recombine_digits(acc), want)


@pytest.mark.parametrize("label", ["flat", "noise", "synthetic"])
def test_integer_dc_is_the_exact_sum_over_8(label):
    """W_int's DC column is 2^21, so the DC is trunc(sum(X) / 8) exactly;
    flat blocks of every level give 8 times the level and no AC term."""
    blk = _integer_sets()[label]
    got = BT.integer_forward(blk)
    s = blk.sum(axis=1)
    assert np.array_equal(got[:, 0], np.sign(s) * (np.abs(s) // 8))
    if label == "flat":
        assert np.array_equal(got[:, 0], 8 * np.arange(-128, 128))
        assert not got[:, 1:].any()


@pytest.mark.parametrize("label", ["extreme", "noise", "planes"])
def test_warp_tile_model_equals_digit_sums(label, planes):
    """testing/fdct_int's model of a warp tile, register by register as the
    PTX ISA lays out mma m16n8k32's s8 fragments (the lanes' loaded rows as
    A, transform_cuda.fragment_table as B), equals the digit sums of the
    tile's 16 blocks: the kernel's sample order and its table agree."""
    if label == "planes":
        blk = BT._blockify(planes[0].astype(np.int32), 2, 2).reshape(-1, 64)
    else:
        blk = _integer_sets()[label]
    for tile in (blk[:16], blk[16:32], blk[-16:]):
        assert np.array_equal(FI.warp_digit_sums(tile), BT.digit_sums(tile))


def test_integer_within_one_of_64_term_and_jax(planes, forward_sets):
    """integer_forward within 1 of the 64-term float32 form, differing on
    at most 2e-3 of the coefficients; quantized through the model, within
    1 of JAX's _quantize_local_ycc at float32 (the JAX package's own CPU
    path)."""
    d = np.abs(forward_sets["int"].astype(np.int64) - forward_sets["f64"])
    assert d.max() <= 1 and (d > 0).mean() <= 2e-3
    model = BT.fdct_quantize_model(*planes, gray=False, rounded=False,
                                   transform=BT.integer_forward)
    ref = JS._quantize_local_ycc(*(jnp.asarray(a) for a in planes),
                                 gray=False, dtype=jnp.float32,
                                 rounded=False, qtables=None)
    for m, r in zip(model, ref):
        assert np.abs(m.astype(np.int64) - np.asarray(r)).max() <= 1


@pytest.mark.parametrize("setting", list(QUANT_SETTINGS))
def test_integer_error_share_against_truth(forward_sets, setting):
    """The integer form is off the extended-precision truth on at most
    1.5 times as many quantized coefficients as the 64-term float32 form,
    at each quantizer setting alone, within 1 of it and of the truth and
    never off on a DC; and before quantization as rarely."""
    q = _quantized(forward_sets, setting)
    for other in ("f64", "truth"):
        d = np.abs(q["int"].astype(np.int64) - q[other])
        assert d.max() <= 1 and not d[:, 0].any(), other
    n_int = int((q["int"] != q["truth"]).sum())
    n_f64 = int((q["f64"] != q["truth"]).sum())
    assert n_int <= 1.5 * n_f64
    raw = {k: int((forward_sets[k] != forward_sets["truth"]).sum())
           for k in ("int", "f64")}
    assert 0 < raw["int"] <= 1.5 * raw["f64"]


INTEGER_MODEL_SETTINGS = {"annexk": dict(gray=False, rounded=False),
                          "q95": dict(gray=False, rounded=False,
                                      qtables=T.scale_quant_tables(95)),
                          "rounded": dict(gray=False, rounded=True),
                          "gray": dict(gray=True, rounded=False)}


@pytest.mark.parametrize("wh", [(48, 16), (48, 32), (128, 64)],
                         ids=["48x16", "48x32", "128x64"])
@pytest.mark.parametrize("setting", list(INTEGER_MODEL_SETTINGS))
def test_integer_model_agrees_with_plain(setting, wh):
    """fdct_quantize_model with integer_forward against the plain form
    (the 64-term float32 product) on 3 images whose components end in
    tiles of fewer than the kernel's 16 blocks: the same shapes, within
    1, on at most 2e-3 of the coefficients (none on these)."""
    w, h = wh
    kw = INTEGER_MODEL_SETTINGS[setting]
    p = _planes(np.stack([_img(h, w, 360 + i) for i in range(3)]))
    plain = BT.fdct_quantize_plain(*(torch.from_numpy(a) for a in p), **kw)
    model = BT.fdct_quantize_model(*p, transform=BT.integer_forward, **kw)
    for g, m in zip(plain, model):
        assert m.dtype == np.int32 and g.shape == m.shape
        d = np.abs(g.numpy().astype(np.int64) - m)
        assert d.max() <= 1 and (d > 0).mean() <= 2e-3
        if kw["gray"] and g is not plain[0]:
            assert not m.any()


# ---------------------------------------------------------------------------
# idct_planes, sparse form
# ---------------------------------------------------------------------------


def _sparse(streams):
    """(flat uint8, kwargs) of the ycc420 transport for these streams."""
    flat, kw, *_ = TC._decode_host_prep(streams, gray=False,
                                        precision="fast", transport=None)
    return flat, kw


@pytest.fixture(scope="module")
def sparse_cases():
    """label -> (flat, kwargs): real images, and noise at quality 100,
    which sends blocks as overflow rows."""
    real = np.stack([_img(128, 64, 340 + i) for i in range(2)])
    # three images: every block overflows, and 3 x 64 rows fill no
    # power-of-two bucket, so each tail carries the padding sentinel
    noise = np.random.default_rng(341).integers(0, 256, (3, 64, 64, 3),
                                                dtype=np.uint8)
    cases = {"real": _sparse(TC.encode_batch(real, device=CPU)),
             "noise q100": _sparse(TC.encode_batch(noise, quality=100,
                                                   device=CPU)),
             "real q95": _sparse(TC.encode_batch(real, quality=95,
                                                 device=CPU))}
    assert not any(cases["real"][1]["caps"])
    assert all(cases["noise q100"][1]["caps"])
    return cases


@pytest.fixture(scope="module")
def sparse_jax(sparse_cases):
    return {k: np.asarray(JC._decode_fused_batch_ycc420(jnp.asarray(f), **kw))
            for k, (f, kw) in sparse_cases.items()}


SPARSE = ("real", "noise q100", "real q95")


@pytest.mark.parametrize("label", SPARSE)
def test_sparse_plain_within_one_of_jax(sparse_cases, sparse_jax, label):
    flat, kw = sparse_cases[label]
    got = BT.idct_planes_sparse_plain(torch.from_numpy(flat), **kw).numpy()
    ref = sparse_jax[label]
    assert got.shape == ref.shape and got.dtype == np.uint8
    d = np.abs(got.astype(np.int64) - ref)
    # observed on these batches: identical; the bound leaves room for ties
    assert d.max() <= 1 and (d > 0).mean() <= 0.001


@pytest.mark.parametrize("label", SPARSE)
def test_sparse_model_integer_parts_equal_plain(sparse_cases, label):
    flat, kw = sparse_cases[label]
    plain = BT.idct_planes_sparse_plain(torch.from_numpy(flat), **kw)
    model = BT.idct_planes_sparse_model(flat, **kw,
                                        transform=_exact_inverse)
    assert np.array_equal(plain.numpy(), model)


@pytest.mark.parametrize("label", SPARSE)
def test_sparse_model_within_one_of_plain(sparse_cases, label):
    flat, kw = sparse_cases[label]
    plain = BT.idct_planes_sparse_plain(torch.from_numpy(flat), **kw).numpy()
    model = BT.idct_planes_sparse_model(flat, **kw)
    d = np.abs(plain.astype(np.int64) - model)
    assert d.max() <= 1 and (d > 0).mean() <= 0.001


def test_sparse_dc_only_identical_to_jax():
    """Flat MCUs decode from DC-only blocks: every term is DC q / 8,
    exact in float32, so JAX, the plain version and the model agree."""
    streams = TC.encode_batch(_flat_mcus(2, 64, 128, 350), device=CPU)
    flat, kw = _sparse(streams)
    got = BT.idct_planes_sparse_plain(torch.from_numpy(flat), **kw).numpy()
    ref = np.asarray(JC._decode_fused_batch_ycc420(jnp.asarray(flat), **kw))
    assert np.array_equal(got, ref)
    assert np.array_equal(got, BT.idct_planes_sparse_model(flat, **kw))


def test_sparse_overflow_sentinels_write_nothing(sparse_cases):
    """The host pads each overflow tail with the sentinel N*B_c; the model
    drops it as the plain version does, and an index out of range either
    way is dropped too (the kernel's bounds check)."""
    flat, kw = sparse_cases["noise q100"]
    N, shapes, caps = kw["N"], kw["shapes"], kw["caps"]
    X = sum((8 + kw["K"]) * b for b in shapes)
    oidx = np.frombuffer(flat[N * X:N * X + 4 * caps[0]].tobytes(), "<i4")
    assert (oidx == N * shapes[0]).any()          # the padding is there
    base = BT.idct_planes_sparse_model(flat, **kw)
    bent = flat.copy()
    pad = int(np.argmax(oidx == N * shapes[0]))
    bent[N * X + 4 * pad:N * X + 4 * pad + 4] = np.frombuffer(
        np.array([-5], "<i4").tobytes(), np.uint8)
    assert np.array_equal(BT.idct_planes_sparse_model(bent, **kw), base)


@pytest.mark.parametrize("hw", [(16, 16), (32, 48), (16, 48)],
                         ids=["16x16", "48x32", "48x16"])
def test_sparse_odd_offsets(hw):
    """16x16 (1 MCU) and 48x16 (3 MCUs): an odd MCU count puts the Cr
    fields 2 bytes off a word boundary (48x32, 6 MCUs, stays aligned);
    the model reads the same coefficients as the plain version."""
    rgbs = np.stack([_img(*hw, 360 + i) for i in range(3)])
    flat, kw = _sparse(TC.encode_batch(rgbs, quality=95, device=CPU))
    nm = (hw[0] // 16) * (hw[1] // 16)
    cr_off = (8 + kw["K"]) * (kw["shapes"][0] + kw["shapes"][1])
    assert (cr_off % 4 != 0) == (nm % 2 == 1)
    plain = BT.idct_planes_sparse_plain(torch.from_numpy(flat), **kw).numpy()
    model = BT.idct_planes_sparse_model(flat, **kw, transform=_exact_inverse)
    assert np.array_equal(plain, model)
    assert np.abs(plain.astype(int)
                  - BT.idct_planes_sparse_model(flat, **kw)).max() <= 1


# ---------------------------------------------------------------------------
# idct_planes, dense form
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def restart_case():
    """Three 64x128 restart streams (ri=3, a short last segment): the
    device transport's lanes, the scan's blocks (plain version) and the
    ycc420 transport's upload of the same streams."""
    rgbs = np.stack([_img(64, 128, 370 + i) for i in range(3)])
    streams = TC.encode_batch(rgbs, restart_interval=3, device=CPU)
    pjs = [parse(s) for s in streams]
    _, geom, level = TC._parse_batch(streams, transport="device")
    nmcu, ri = 32, 3
    nseg = -(-nmcu // ri)
    words, nblk, rawlen = HG._device_host_frontend(pjs, nmcu, ri, nseg)
    lut, tsel = HG._device_luts(pjs, nseg)
    lanes = dict(words=words, nblk=nblk, lut=lut, tsel=tsel, rawlen=rawlen)
    t = {k: (ED.words_tensor(v) if k == "words" else
             torch.from_numpy(np.ascontiguousarray(v, np.int32)))
         for k, v in lanes.items()}
    blocks, bad = ED.decode_segments(**t, max_blocks=ri * 6)
    qarr = HG._quant_arr(pjs)
    kw = dict(N=3, nseg=nseg, ri=ri, geom=geom, level=level)
    return dict(streams=streams, lanes=lanes, blocks=blocks, bad=bad,
                qarr=qarr, kw=kw, sparse=_sparse(streams))


def test_dense_plain_within_one_of_jax(restart_case):
    c = restart_case
    got = BT.idct_planes_dense_plain(c["blocks"], c["bad"],
                                     torch.from_numpy(c["qarr"]),
                                     **c["kw"]).numpy()
    ln = c["lanes"]
    ref = np.asarray(JC._decode_fused_batch_device(
        *(jnp.asarray(ln[k]) for k in ("words", "nblk", "lut", "tsel",
                                      "rawlen")),
        jnp.asarray(c["qarr"]), **c["kw"]))
    assert got.shape == ref.shape == (3, 64 * 128 * 3 // 2 + 1)
    assert not got[:, -1].any() and not ref[:, -1].any()
    d = np.abs(got.astype(np.int64) - ref)
    assert d.max() <= 1 and (d > 0).mean() <= 0.001


def test_dense_model_integer_parts_equal_plain(restart_case):
    c = restart_case
    plain = BT.idct_planes_dense_plain(c["blocks"], c["bad"],
                                       torch.from_numpy(c["qarr"]),
                                       **c["kw"]).numpy()
    model = BT.idct_planes_dense_model(c["blocks"].numpy(), c["bad"].numpy(),
                                       c["qarr"], **c["kw"],
                                       transform=_exact_inverse)
    assert np.array_equal(plain, model)
    fast = BT.idct_planes_dense_model(c["blocks"].numpy(), c["bad"].numpy(),
                                      c["qarr"], **c["kw"])
    assert np.abs(plain.astype(int) - fast).max() <= 1


def test_dense_flags_per_image(restart_case):
    """One flag byte per image: set where any of its segments is."""
    c = restart_case
    bad = torch.zeros_like(c["bad"])
    bad[c["kw"]["nseg"] + 2] = True                 # image 1's third segment
    args = (c["blocks"], bad, torch.from_numpy(c["qarr"]))
    plain = BT.idct_planes_dense_plain(*args, **c["kw"]).numpy()
    model = BT.idct_planes_dense_model(*(a.numpy() for a in args),
                                       **c["kw"])
    assert plain[:, -1].tolist() == model[:, -1].tolist() == [0, 1, 0]


def test_sparse_and_dense_models_give_the_same_planes(restart_case):
    """The same streams through the ycc420 upload and through the scan's
    blocks: the models' planes are identical (the kernels skip zero
    coefficients, which is exact, so the two forms may read different
    zeros and still agree)."""
    c = restart_case
    flat, kw = c["sparse"]
    sparse = BT.idct_planes_sparse_model(flat, **kw)
    dense = BT.idct_planes_dense_model(c["blocks"].numpy(), c["bad"].numpy(),
                                       c["qarr"], **c["kw"])
    assert np.array_equal(sparse, dense[:, :-1])
    assert np.array_equal(
        TC._decode_fused_batch_ycc420(torch.from_numpy(flat), **kw).numpy(),
        BT.idct_planes_dense_plain(c["blocks"], c["bad"],
                                   torch.from_numpy(c["qarr"]),
                                   **c["kw"]).numpy()[:, :-1])


def test_inverse_model_level_added_after_the_sum():
    """The level is a separate float32 add after the product, as in the
    plain version; starting the sum at the level rounds otherwise."""
    rng = np.random.default_rng(380)
    deq = (rng.integers(-64, 64, (20000, 64)) * rng.integers(
        1, 40, (1, 64))).astype(np.int32)
    got = BT.inverse_model(deq, 128)
    m = BT._basis("inv64_f32")
    s = BT.sum_ascending(deq.astype(np.float32), m)
    assert np.array_equal(got, (s + np.float32(128)).astype(np.int32))
    assert np.abs(got.astype(np.int64) - _exact_inverse(deq, 128)).max() <= 1
    started = np.full(deq.shape, 128, np.float32)
    for k in range(64):
        started += deq[:, k:k + 1].astype(np.float32) * m[:, k][None, :]
    assert not np.array_equal(got, started.astype(np.int32))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _counts():
    return transform_cuda.fdct_launches, transform_cuda.idct_launches


def test_codec_on_cpu_launches_nothing(restart_case):
    before = _counts()
    rgbs = np.stack([_img(32, 32, 390 + i) for i in range(2)])
    for kw in ({}, {"transport": "rgb"}, {"restart_interval": 1},
               {"optimize": True}):
        streams = TC.encode_batch(rgbs, device=CPU, **kw)
    TC.decode_batch(restart_case["streams"], transport="device", device=CPU)
    TC.decode_batch(streams, transport="ycc420", device=CPU)
    assert _counts() == before


def test_quantize_local_ycc_dispatches_by_precision(planes):
    t = [torch.from_numpy(a) for a in planes]
    for dtype in (torch.float32, torch.float64):
        got = TC._quantize_local_ycc(*t, gray=False, dtype=dtype,
                                     rounded=False)
        want = BT.fdct_quantize_plain(*t, gray=False, rounded=False,
                                      dtype=dtype)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_dispatchers_refuse_other_devices():
    meta = torch.zeros((1, 16, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="fdct_quantize"):
        BT.fdct_quantize(meta, meta[:, :8, :8], meta[:, :8, :8], gray=False,
                         rounded=False)
    with pytest.raises(ValueError, match="idct_planes_sparse"):
        BT.idct_planes_sparse(torch.zeros(8, dtype=torch.uint8,
                                          device="meta"),
                              geom=(), level=128, shapes=(), K=10, N=0,
                              caps=(), qtuple=())
    with pytest.raises(ValueError, match="idct_planes_dense"):
        BT.idct_planes_dense(torch.zeros((6, 6, 64), dtype=torch.int16,
                                         device="meta"), None, None, N=1,
                             nseg=1, ri=1, geom=(), level=128)


def _fdct_args(case):
    y = torch.zeros((2, 32, 32), dtype=torch.int8)
    c = torch.zeros((2, 16, 16), dtype=torch.int8)
    args = [y, c, c, torch.zeros(64, dtype=torch.int32),
            torch.zeros(64, dtype=torch.int32)]
    if case == "dtype":
        args[:3] = [a.to(torch.int16) for a in args[:3]]
    elif case == "mixed dtypes":
        args[1] = args[1].to(torch.int32)
    elif case == "rank":
        args[0] = y.reshape(2, -1)
    elif case == "chroma shape":
        args[2] = torch.zeros((2, 8, 16), dtype=torch.int8)
    elif case == "table dtype":
        args[3] = args[3].to(torch.int64)
    elif case == "not 16":
        args[:3] = [torch.zeros((2, 24, 32), dtype=torch.int8), c, c]
    return args


@pytest.mark.parametrize("case", ["cpu", "dtype", "mixed dtypes", "rank",
                                  "chroma shape", "table dtype", "not 16"])
def test_fdct_wrapper_refuses_before_building(case):
    with pytest.raises(ValueError, match="fdct_quantize_cuda"):
        transform_cuda.fdct_quantize_cuda(*_fdct_args(case))
    assert transform_cuda.LIB.handle is None


@pytest.mark.parametrize("case", ["cpu", "dtype", "short", "rank",
                                  "table shape", "geometry"])
def test_sparse_wrapper_refuses_before_building(case, sparse_cases):
    flat, kw = sparse_cases["real"]
    kw = dict(kw)
    qtab = BT.quant_tables(kw.pop("qtuple"), torch.device(CPU))
    t = torch.from_numpy(flat)
    if case == "dtype":
        t = t.to(torch.int16)
    elif case == "short":
        t = t[:-1]
    elif case == "rank":
        t = t.reshape(2, -1)
    elif case == "table shape":
        qtab = qtab[:2]
    elif case == "geometry":
        g = kw["geom"][0]
        kw["geom"] = ((g[0], g[1], 1, 2) + tuple(g[4:]),) + kw["geom"][1:]
    with pytest.raises(ValueError, match="idct_planes"):
        transform_cuda.idct_planes_sparse_cuda(t, qtab, **kw)
    assert transform_cuda.LIB.handle is None


@pytest.mark.parametrize("case", ["cpu", "dtype", "bad dtype", "no flags",
                                  "qarr shape", "too few segments",
                                  "4:4:4"])
def test_dense_wrapper_refuses_before_building(case, restart_case):
    c = restart_case
    kw = dict(c["kw"])
    args = [c["blocks"], c["bad"], torch.from_numpy(c["qarr"])]
    if case == "dtype":
        args[0] = args[0].to(torch.int32)
    elif case == "bad dtype":
        args[1] = args[1].to(torch.int32)
    elif case == "no flags":
        args[1] = None
    elif case == "qarr shape":
        args[2] = args[2][:2]
    elif case == "too few segments":
        kw["nseg"] -= 2
    elif case == "4:4:4":
        kw["geom"] = tuple((g[0], g[1], 1, 1, 1, 1) for g in kw["geom"])
    with pytest.raises(ValueError, match="idct_planes"):
        transform_cuda.idct_planes_dense_cuda(*args, **kw)
    assert transform_cuda.LIB.handle is None
