"""Exact mode's block transforms of jpezy_tpu_torch
(ops/block_transform.py: fdct_quantize_exact, idct_planes_exact) against
the oracle, the host C++ codec and jpezy_tpu, on the CPU.

On CUDA tensors both take the hand-written kernels of
csrc/exact_transforms.cu, which make the oracle's float64 roundings and no
others; on CPU tensors their plain versions (ops/dct.py's ordered sums).
Here, with exact equality everywhere:

  - the kernels' float64 tables (constants.EXACT_TABLES) are the oracle's,
    and the oracle's term tables are their entries, bit for bit;
  - fdct_quantize_exact equals the oracle's forward DCT with the quantizer,
    JAX's _forward_dct_ordered called eagerly (never jitted: jitted, XLA
    reorders the sums and differs at ties, fault K of ROADMAP.md) with
    JAX's quantize, and the host C++ codec's coefficients, at Annex K,
    quality 95, rounded and gray, on int8 planes and on the rgb path's
    int32 planes with strided chroma;
  - idct_planes_exact equals JAX's eager _inverse_dct_ordered with
    dequantize and deblockify, the oracle's inverse DCT and the host C++
    codec's, at 4:2:0, 4:2:2, 4:4:4, one component, gray and level 2048;
  - numpy models of the kernels' factorizations (the forward's first
    product shared by the 8 rows, the inverse over the nonzero
    coefficients only, partial sums that cancel to 0 included) equal the
    oracle;
  - numpy models of the kernels' schedules (a warp's 4 blocks as one: the
    union of their nonzero samples or coefficients, the other blocks'
    +-0 terms; no product by COS[0][.], cu[i >= 1] or a cucv of 1, the
    first term stored) equal the oracle on the tie sets, cancelling
    blocks, noise at quality 100 and warp groups that mix dense blocks
    with sparse and zero ones;
  - the tie sets (testing/exact_ties.forward_tie_blocks, inverse_tie_blocks)
    hold blocks on which jitted JAX differs from the oracle, and the port
    does not;
  - CPU tensors build and launch nothing, and the CUDA wrappers refuse
    what they do not take before anything is built.

tests/test_torch_cuda.py and chip_smoke.py hold the kernels to the plain
versions bit for bit on the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from jpezy_tpu.ops import dct as JD
from jpezy_tpu.ops import quantize as JQ
from jpezy_tpu_torch import constants as K
from jpezy_tpu_torch.codec import host_codec
from jpezy_tpu_torch.codec import host_glue as HG
from jpezy_tpu_torch.codec import oracle as O
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.core import tables as T
from jpezy_tpu_torch.ops import block_transform as BT
from jpezy_tpu_torch.ops import blocks as TB
from jpezy_tpu_torch.ops import colorspace as TCS
from jpezy_tpu_torch.ops import exact_cuda
from jpezy_tpu_torch.runtime import native
from jpezy_tpu_torch.testing import exact_ties as XT

from test_torch_host_copies import host_runtime  # noqa: F401 (autouse)

CPU = "cpu"
ONES = np.ones(64, np.int32)


def _bits(a):
    return np.asarray(a, np.float64).view(np.uint64)


def _img(h, w, seed):
    from imagegen import make_test_image

    return make_test_image(h, w, seed=seed)


# ---------------------------------------------------------------------------
# The tables
# ---------------------------------------------------------------------------


def test_exact_tables_are_the_oracles():
    assert K.EXACT_TABLES.dtype == np.float64 and K.EXACT_TABLES.shape == (
        136,) and K.EXACT_TABLES.flags.c_contiguous
    assert np.array_equal(_bits(K.EXACT_COS), _bits(O._COS))
    assert np.array_equal(_bits(K.EXACT_COS), _bits(O.cos_table()))
    assert np.array_equal(_bits(K.EXACT_CU), _bits(O._CU_J))
    assert np.array_equal(_bits(K.EXACT_CUCV), _bits(O._INV_CUCV))
    k = np.arange(64)[:, None]
    ij = np.arange(64)[None, :]
    cos = K.EXACT_COS
    # forward term k = 8 y + x of coefficient (i, j); inverse term k = 8 v + u
    # of sample (y, x): each factor one entry of the kernels' tables
    assert np.array_equal(_bits(O._FWD_C1), _bits(cos[ij % 8, k % 8]))
    assert np.array_equal(_bits(O._FWD_C2), _bits(cos[ij // 8, k // 8]))
    assert np.array_equal(_bits(O._INV_C1), _bits(cos[k % 8, ij % 8]))
    assert np.array_equal(_bits(O._INV_C2), _bits(cos[k // 8, ij // 8]))
    # the codec's device tables are the same values
    c = K.codec_constants(CPU)
    assert np.array_equal(_bits(c["cu_j"].numpy()), _bits(K.EXACT_CU))
    assert np.array_equal(_bits(c["inv_cucv"].numpy()), _bits(K.EXACT_CUCV))


# ---------------------------------------------------------------------------
# fdct_quantize_exact
# ---------------------------------------------------------------------------

SETTINGS = {"annexk": dict(gray=False, rounded=False, quality=None),
            "q95": dict(gray=False, rounded=False, quality=95),
            "rounded": dict(gray=False, rounded=True, quality=None),
            "gray": dict(gray=True, rounded=False, quality=None)}


@pytest.fixture(scope="module")
def planes():
    """Two 128x64 test images' host ycc420 planes (int8)."""
    return HG.host_rgb_to_ycc420(np.stack([_img(128, 64, 500 + i)
                                           for i in range(2)]))


def _comp_blocks(planes):
    """Per component (blocks [N, B, 64] int32, chroma) in MCU order."""
    y, cb, cr = (np.asarray(p).astype(np.int32) for p in planes)
    return [(BT._blockify(y, 2, 2), False), (BT._blockify(cb, 1, 1), True),
            (BT._blockify(cr, 1, 1), True)]


def _tables(quality):
    return (T.scale_quant_tables(quality) if quality is not None
            else (T.Y_QUANT, T.C_QUANT))


def _reference(name, planes, gray, rounded, quality):
    """(yq, cbq, crq) [N, B, 64] int32 from one reference."""
    yqt, cqt = _tables(quality)
    out = []
    for blk, chroma in _comp_blocks(planes):
        n, b, _ = blk.shape
        flat = blk.reshape(-1, 64)
        qt = np.asarray(cqt if chroma else yqt, np.int32)
        if gray and chroma:
            out.append(np.zeros((n, b, 64), np.int32))
            continue
        if name == "oracle":
            q = BT._quantize(O.forward_dct(flat), qt, rounded)
        elif name == "jax eager":
            coef = JD._forward_dct_ordered(jnp.asarray(flat))
            q = np.asarray(JQ.quantize(coef, chroma, rounded=rounded,
                                       qtable=qt))
        else:  # the host C++ codec's fDCT (its quantizer truncates)
            cu8 = np.where(np.arange(8) == 0, 1.0 / np.sqrt(2.0), 1.0)
            if rounded:
                q = BT._quantize(native.fdct_quant(flat, O._FWD_C1, O._FWD_C2,
                                                   cu8, ONES), qt, True)
            else:
                q = native.fdct_quant(flat, O._FWD_C1, O._FWD_C2, cu8, qt)
        out.append(np.asarray(q, np.int32).reshape(n, b, 64))
    return out


@pytest.mark.parametrize("ref", ["oracle", "jax eager", "host_codec"])
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_fdct_exact_equals_references(planes, setting, ref):
    kw = SETTINGS[setting]
    qt = None if kw["quality"] is None else _tables(kw["quality"])
    got = BT.fdct_quantize_exact(*(torch.from_numpy(p) for p in planes),
                                 gray=kw["gray"], rounded=kw["rounded"],
                                 qtables=qt)
    want = _reference(ref, planes, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), w)


def test_fdct_exact_rgb_path_int32_strided(planes):
    """The rgb transport's planes: int32 luma, chroma decimated as views of
    column stride 2, converted at float64 on the CPU."""
    rgb = torch.from_numpy(np.stack([_img(64, 80, 510 + i)
                                     for i in range(2)]))
    y, cb, cr = TCS.rgb_to_ycc(rgb[..., 0], rgb[..., 1], rgb[..., 2],
                               torch.float64)
    p3 = (y, TB.decimate_420(cb), TB.decimate_420(cr))
    assert p3[1].stride()[-1] == 2
    got = BT.fdct_quantize_exact(*p3, gray=False, rounded=False)
    want = _reference("oracle", tuple(p.numpy() for p in p3), gray=False,
                      rounded=False, quality=None)
    assert all(np.array_equal(g.numpy(), w) for g, w in zip(got, want))
    via_codec = TC._quantize_local_ycc(*p3, gray=False, dtype=torch.float64,
                                       rounded=False)
    assert all(torch.equal(a, b) for a, b in zip(got, via_codec))


def test_exact_encode_equals_host_codec():
    """The codec's exact paths through fdct_quantize_exact on CPU tensors:
    ycc420 and rgb transports, quality 95 and optimize, byte-identical to
    the host C++ codec."""
    rgbs = np.stack([_img(48, 64, 520 + i) for i in range(2)])
    for kw in ({}, {"transport": "rgb"}, {"quality": 95},
               {"optimize": True, "restart_interval": 2}):
        got = TC.encode_batch(rgbs, precision="exact", device=CPU, **kw)
        host_kw = {k: v for k, v in kw.items() if k != "transport"}
        assert got == [host_codec.encode(im[..., 0], im[..., 1], im[..., 2],
                                         **host_kw) for im in rgbs], kw


# ---------------------------------------------------------------------------
# idct_planes_exact
# ---------------------------------------------------------------------------

# (mcus_y, mcus_x) and per component (v, h); gray; level
GEOMETRIES = {
    "420": ((2, 3), ((2, 2), (1, 1), (1, 1)), False, 128),
    "422": ((2, 3), ((1, 2), (1, 1), (1, 1)), False, 128),
    "444": ((3, 2), ((1, 1), (1, 1), (1, 1)), False, 128),
    "1comp": ((3, 4), ((1, 1),), False, 128),
    "gray": ((2, 3), ((2, 2), (1, 1), (1, 1)), True, 128),
    "level2048": ((2, 3), ((2, 2), (1, 1), (1, 1)), False, 2048),
}


def _idct_case(name, seed=530):
    """(coeff_all [N, sum B, 64] int16, kwargs of idct_planes_exact): seeded
    coefficients, a fifth of them nonzero, every DC set, at 16 times the
    magnitude for level 2048 (12-bit samples)."""
    (my, mx), vh, gray, level = GEOMETRIES[name]
    rng = np.random.default_rng(seed)
    N = 2
    sizes = tuple(my * mx * v * h for v, h in vh)
    qtuple = tuple(tuple(int(x) for x in (T.Y_QUANT if c == 0
                                          else T.C_QUANT))
                   for c in range(len(vh)))
    scale = level // 128
    coeff = np.zeros((N, sum(sizes), 64), np.int32)
    nz = rng.random(coeff.shape) < 0.2
    coeff[nz] = rng.integers(-40 * scale, 41 * scale, int(nz.sum()))
    coeff[:, :, 0] = rng.integers(-60 * scale, 61 * scale,
                                  coeff.shape[:2])
    geom = tuple((my, mx, v, h, 1, 1) for v, h in vh)
    return (torch.from_numpy(coeff.astype(np.int16)),
            dict(geom=geom, level=level, gray=gray, sizes=sizes,
                 qtuple=qtuple))


def _idct_reference(ref, coeff, geom, level, gray, sizes, qtuple):
    out, off = [], 0
    for n_b, qt, g in zip(sizes[:1] if gray else sizes, qtuple, geom):
        blk = coeff[:, off:off + n_b].reshape(-1, 64)
        off += n_b
        if ref == "jax eager":
            deq = JQ.dequantize(jnp.asarray(blk.astype(np.int32)),
                                np.asarray(qt))
            spat = np.asarray(JD._inverse_dct_ordered(deq, level))
        elif ref == "oracle":
            spat = O.inverse_dct(blk.astype(np.int64) * np.asarray(qt),
                                 level)
        else:  # the host C++ codec's dequantize + IDCT
            spat = native.idct_dequant(blk, np.asarray(qt, np.int32),
                                       O._INV_CUCV, O._INV_C1, O._INV_C2,
                                       level)
        out.append(BT._deblockify(spat.reshape(coeff.shape[0], n_b, 64),
                                  *g[:4]))
    return out


@pytest.mark.parametrize("ref", ["jax eager", "oracle", "host_codec"])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_idct_exact_equals_references(name, ref):
    coeff, kw = _idct_case(name)
    got = BT.idct_planes_exact(coeff, **kw)
    want = _idct_reference(ref, coeff.numpy(), **kw)
    assert len(got) == (1 if kw["gray"] else len(kw["sizes"]))
    for g, w, geo in zip(got, want, kw["geom"]):
        my, mx, v, h = geo[:4]
        assert g.dtype == torch.int32
        assert tuple(g.shape) == (coeff.shape[0], my * v * 8, mx * h * 8)
        assert np.array_equal(g.numpy(), w)
    # unclamped: the seeded blocks reach past [0, 255] (or [0, 4095])
    assert int(got[0].min()) < 0 or int(got[0].max()) > 2 * kw["level"] - 1


def test_exact_decode_program_equals_host_codec():
    """_decode_fused_batch in exact mode on CPU tensors (through
    idct_planes_exact) gives host_codec.decode's pixels, colour and gray."""
    rgbs = np.stack([_img(48, 64, 540 + i) for i in range(2)])
    streams = [host_codec.encode(im[..., 0], im[..., 1], im[..., 2],
                                 quality=90) for im in rgbs]
    for gray in (False, True):
        px, _ = TC.decode_batch(streams, precision="exact", gray=gray,
                                device=CPU)
        want = np.stack([np.stack(host_codec.decode(s, gray=gray)[:3], -1)
                         for s in streams])
        assert np.array_equal(px, want), gray


# ---------------------------------------------------------------------------
# The kernels' factorizations, in numpy
# ---------------------------------------------------------------------------


def _kernel_forward(blk):
    """fdct_quantize_exact_kernel's float part: per (k, j) one first
    product p[k] COS[j][x] for all 8 rows i, the rows' sums ascending in k,
    then ((s cu[j]) cu[i]) / 4 as three roundings, truncated."""
    cos, cu = K.EXACT_COS, K.EXACT_CU
    pic = blk.astype(np.float64).reshape(-1, 8, 8)         # [B, y, x]
    acc = np.zeros((pic.shape[0], 8, 8))                    # [B, i, j]
    for y in range(8):
        for x in range(8):
            t = pic[:, y, x][:, None] * cos[:, x][None, :]  # [B, j]
            acc += t[:, None, :] * cos[:, y][None, :, None]
    res = ((acc * cu[None, None, :]) * cu[None, :, None]) * 0.25
    return res.reshape(-1, 64).astype(np.int32)


def _kernel_inverse(deq, level, trace=None):
    """idct_planes_exact_kernel's float part: per block the nonzero
    coefficients in ascending k, each ((cucv[k] d) COS[u][x]) COS[v][y]
    added to sample (y, x), then s * 0.25 + level, truncated.  trace, if
    given, receives each block's partial sums after every term."""
    cos, cucv = K.EXACT_COS, K.EXACT_CUCV
    out = np.empty(deq.shape, np.int32)
    for b, d in enumerate(np.asarray(deq, np.int64)):
        s = np.zeros((8, 8))                                # [y, x]
        for k in np.flatnonzero(d):
            u, v = k % 8, k // 8
            cx = (cucv[k] * float(d[k])) * cos[u, :]        # [x]
            s = s + cx[None, :] * cos[v, :][:, None]
            if trace is not None:
                trace.append((b, k, s.copy()))
        out[b] = (s * 0.25 + level).astype(np.int32).reshape(64)
    return out


def test_kernel_forward_factorization_equals_oracle():
    rng = np.random.default_rng(550)
    blk = np.concatenate([XT.forward_tie_blocks(1024, 551),
                          rng.integers(-128, 128, (2048, 64))]).astype(
        np.int32)
    assert np.array_equal(_kernel_forward(blk), O.forward_dct(blk))


# d[2] = a, d[16] = -a: on the diagonal samples the two terms are exact
# negatives, so the partial sum is exactly 0 there after k = 16
_cancelling_blocks = XT.cancelling_coefficients


def test_zero_skipping_inverse_cancelling_partial_sums():
    d = _cancelling_blocks(256, 560)
    trace = []
    got = _kernel_inverse(d, 128, trace)
    assert np.array_equal(got, O.inverse_dct(d, 128))
    zeros = [s for _, k, s in trace if k == 16]
    assert len(zeros) == 256
    for s in zeros:
        diag = np.diagonal(s)
        assert np.all(diag == 0.0) and not np.signbit(diag).any()


@functools.lru_cache(maxsize=2)
def _inverse_ties(level):
    return XT.inverse_tie_blocks(512, 565, level)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.integers(0, 2**31 - 1), st.sampled_from([0.02, 0.15, 0.5, 1.0]),
       st.sampled_from([128, 2048]))
def test_zero_skipping_inverse_equals_full_sum(seed, density, level):
    """Random blocks at four densities, blocks whose partial sums cancel to
    0, and tie blocks: the sum over the nonzero coefficients alone equals
    the oracle's 64-term sum."""
    rng = np.random.default_rng(seed)
    d = np.where(rng.random((64, 64)) < density,
                 rng.integers(-1024, 1025, (64, 64)), 0)
    d[:8] = _cancelling_blocks(8, seed)
    ties = _inverse_ties(level)
    d[8:16] = ties[rng.integers(0, len(ties), 8)]
    assert np.array_equal(_kernel_inverse(d, level),
                          O.inverse_dct(d, level))


# ---------------------------------------------------------------------------
# The kernels' schedules: a warp's 4 blocks as one, products by 1 left out
# ---------------------------------------------------------------------------


def _groups(a):
    """Blocks [B, 64] -> [G, 4, 64], the last group padded with zero blocks,
    as a kernel warp takes them (4 consecutive blocks of a component)."""
    out = np.zeros((-(-len(a) // 4) * 4, 64), a.dtype)
    out[:len(a)] = a
    return out.reshape(-1, 4, 64)


def _schedule_forward(blk):
    """fdct_quantize_exact_kernel's float part: per group of 4 blocks the
    samples nonzero in any of them (the others' terms left out), per (k, j)
    one first product p[k] COS[j][x], added as it is into row 0 (COS[0][y] =
    1) and times COS[i][y] into rows 1 to 7, the k = 0 term stored in
    place of its add onto +0; then (s cu[j]) cu[0] / 4 for row 0 and
    s cu[j] / 4 for the others (cu[i] = 1), truncated."""
    cos, cu = K.EXACT_COS, K.EXACT_CU
    pic = _groups(np.asarray(blk, np.float64))
    union = (pic != 0).any(axis=1)                          # [G, k]
    acc = np.zeros(pic.shape[:2] + (8, 8))                  # [G, b, i, j]
    for k in range(64):
        y, x = divmod(k, 8)
        g = union[:, k]
        t = pic[g, :, k][:, :, None] * cos[:, x]            # [g, b, j]
        rows = np.concatenate([t[:, :, None, :], t[:, :, None, :]
                               * cos[1:, y][None, None, :, None]], axis=2)
        acc[g] = rows if k == 0 else acc[g] + rows
    res = acc * cu[None, None, None, :]
    res[:, :, 0, :] *= cu[0]
    res = (res * 0.25).reshape(-1, 64)[:len(blk)]
    return res.astype(np.int32)


def _schedule_inverse(deq, level):
    """idct_planes_exact_kernel's float part: cucv[k] d[k] once per
    coefficient where u or v is 0 (cucv is 1 elsewhere); per group of 4
    blocks the coefficients nonzero in any of them in ascending k, each
    term (cucv[k] d) COS[u][x] (no product for u = 0) times COS[v][y] (none
    for v = 0), the k = 0 term stored in place of its add onto +0, the
    other blocks' zero coefficients adding +-0; then s / 4 + level,
    truncated."""
    cos, cucv = K.EXACT_COS, K.EXACT_CUCV
    d = _groups(np.asarray(deq, np.int64)).astype(np.float64)
    union = (d != 0).any(axis=1)
    k = np.arange(64)
    scaled = (k % 8 == 0) | (k // 8 == 0)
    d[:, :, scaled] = cucv[scaled] * d[:, :, scaled]
    acc = np.zeros(d.shape[:2] + (8, 8))                    # [G, b, y, x]
    for k in range(64):
        v, u = divmod(k, 8)
        g = union[:, k]
        cx = d[g, :, k][:, :, None] * (cos[u] if u else np.ones(8))
        term = cx[:, :, None, :] * (cos[v][:, None] if v else np.ones((8, 1)))
        acc[g] = term if k == 0 else acc[g] + term
    return (acc * 0.25 + level).astype(np.int32).reshape(-1, 64)[:len(deq)]


def _rcp_up(d):
    """exact_transforms.cu's rcp_up in numpy: for 2^e <= d < 2^(e+1),
    D = d 2^(23-e), the mantissa q = ceil(2^47 / D) in (2^23, 2^24], built
    into a float32's bits as the kernel builds them (2^-e for a power of
    two or where q rounds up to 2^24)."""
    d = np.asarray(d, np.int64)
    e = np.floor(np.log2(d)).astype(np.int64)
    e -= (np.int64(1) << e) > d                 # floor(log2) exactly
    e += (np.int64(1) << (e + 1)) <= d
    q = -(-(np.int64(1) << 47) // (d << (23 - e)))
    pow2 = (d & (d - 1)) == 0
    top = pow2 | (q == 1 << 24)
    bits = np.where(top, (127 - e) << 23,
                    ((126 - e) << 23) | (q - (1 << 23)))
    return bits.astype(np.int32).view(np.float32)


def test_rcp_up_is_the_reciprocal_rounded_up():
    """The kernels' division by reciprocals (div_exact) needs 1/d rounded
    up to a float32; rcp_up makes it in integer arithmetic, so that the
    exact kernels' SASS holds no FFMA (__frcp_ru's would).  For every d
    below 2^24: r d >= 1 and the next float32 below r gives < 1 (products
    exact in float64: 24 by 24 bits)."""
    d = np.arange(1, 1 << 24, dtype=np.int64)
    r = _rcp_up(d)
    below = np.nextafter(r, np.float32(0))
    df = d.astype(np.float64)
    assert np.all(r.astype(np.float64) * df >= 1.0)
    assert np.all(below.astype(np.float64) * df < 1.0)


def test_skipped_factors_are_exactly_one():
    """The factors the kernels leave out (and their launchers check): x 1
    is x for every x."""
    k = np.arange(64)
    assert np.array_equal(_bits(K.EXACT_COS[0]), _bits(np.ones(8)))
    assert np.array_equal(_bits(K.EXACT_CU[1:]), _bits(np.ones(7)))
    both = (k % 8 > 0) & (k // 8 > 0)
    assert np.array_equal(_bits(K.EXACT_CUCV[both]), _bits(np.ones(49)))
    assert not np.any(K.EXACT_CUCV[~both] == 1.0)


def _noise_samples(n, seed):
    return np.random.default_rng(seed).integers(-128, 128, (n, 64))


def _noise_q100(n, seed):
    """Dequantized coefficients of noise at quality 100 (quantizer 1)."""
    assert set(np.concatenate(T.scale_quant_tables(100)).tolist()) == {1}
    return O.forward_dct(_noise_samples(n, seed))


FORWARD_SETS = {
    "ties": lambda: XT.forward_tie_blocks(1024, 600),
    "cancelling": lambda: XT.cancelling_samples(512, 601),
    "noise": lambda: _noise_samples(1024, 602),
    "mixed groups": lambda: XT.mixed_sample_groups(256, 603),
}


@pytest.mark.parametrize("name", list(FORWARD_SETS))
def test_schedule_forward_equals_oracle(name):
    blk = FORWARD_SETS[name]().astype(np.int32)
    assert np.array_equal(_schedule_forward(blk), O.forward_dct(blk))


INVERSE_SETS = {
    "ties 128": (lambda: XT.inverse_tie_blocks(2048, 610, 128), 128),
    "ties 2048": (lambda: XT.inverse_tie_blocks(2048, 611, 2048), 2048),
    "cancelling": (lambda: _cancelling_blocks(512, 612), 128),
    "noise q100": (lambda: _noise_q100(512, 613), 128),
    "mixed groups 128": (lambda: XT.mixed_coefficient_groups(256, 614), 128),
    "mixed groups 2048": (
        lambda: XT.mixed_coefficient_groups(256, 615, 2048), 2048),
}


@pytest.mark.parametrize("name", list(INVERSE_SETS))
def test_schedule_inverse_equals_oracle(name):
    make, level = INVERSE_SETS[name]
    d = make()
    assert np.array_equal(_schedule_inverse(d, level),
                          O.inverse_dct(d, level))


def test_mixed_groups_mix_dense_with_sparse_blocks():
    """Even groups hold a dense block, odd ones none (a small union, the
    kernels' skipping path), and in every group most of the samples (or
    coefficients) the group takes are zero in another of its blocks: the
    kernels' +-0 terms are exercised on both paths."""
    for blk in (XT.mixed_sample_groups(64, 620),
                XT.mixed_coefficient_groups(64, 621)):
        nz = _groups(blk) != 0
        dense = nz.sum(axis=2).max(axis=1)
        assert np.all(dense[0::2] >= 60) and np.all(dense[1::2] <= 8)
        union = nz.any(axis=1)
        assert np.all(union[1::2].sum(axis=1) <= 32)
        mixed = (union & ~nz.all(axis=1)).sum(axis=1)
        assert np.all(mixed >= union.sum(axis=1) // 2)


def _mixed(seed, density_dense, density_rest, lo, hi):
    """4 groups of 4: a dense block beside blocks at another density, in a
    seeded order."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        dens = [density_dense] + [density_rest] * 3
        rng.shuffle(dens)
        for p in dens:
            out.append(np.where(rng.random(64) < p,
                                rng.integers(lo, hi, 64), 0))
    return np.stack(out)


@settings(max_examples=25, deadline=None, derandomize=True)
@given(st.integers(0, 2**31 - 1), st.sampled_from([0.0, 0.05, 0.3]))
def test_schedule_forward_mixed_densities(seed, rest):
    blk = _mixed(seed, 1.0, rest, -128, 128)
    blk[:4] = XT.cancelling_samples(4, seed)
    assert np.array_equal(_schedule_forward(blk), O.forward_dct(blk))


@settings(max_examples=25, deadline=None, derandomize=True)
@given(st.integers(0, 2**31 - 1), st.sampled_from([0.0, 0.05, 0.3]),
       st.sampled_from([128, 2048]))
def test_schedule_inverse_mixed_densities(seed, rest, level):
    d = _mixed(seed, 0.9, rest, -1024, 1025) * (level // 128)
    d[4:8] = _cancelling_blocks(4, seed)
    ties = _inverse_ties(level)
    d[8:10] = ties[np.random.default_rng(seed).integers(0, len(ties), 2)]
    assert np.array_equal(_schedule_inverse(d, level),
                          O.inverse_dct(d, level))


# ---------------------------------------------------------------------------
# The tie sets: jitted JAX misses on them, the port does not
# ---------------------------------------------------------------------------


def test_forward_ties_split_jit_from_oracle():
    blk = XT.forward_tie_blocks(1024, 570)
    ref = O.forward_dct(blk)
    jit = np.asarray(jax.jit(JD._forward_dct_ordered)(jnp.asarray(blk)))
    assert (jit != ref).any(axis=1).sum() >= 5        # fault K shows here
    eager = np.asarray(JD._forward_dct_ordered(jnp.asarray(blk)))
    assert np.array_equal(eager, ref)
    # the port, through the planes of one image (luma 2 x 2 a MCU) at
    # quantizer 1, equals the oracle on every tie
    mx = len(blk) // 4
    n = 4 * mx
    ones = torch.ones(64, dtype=torch.int32)
    got = BT.fdct_quantize_exact(
        *(torch.from_numpy(p.astype(np.int8)) for p in XT.tie_planes(blk)),
        gray=False, rounded=False, qtables=(ones, ones))
    assert np.array_equal(got[0].numpy()[0], ref[:n])
    assert np.array_equal(got[1].numpy()[0], ref[:mx])


def test_inverse_ties_split_jit_from_oracle():
    for level in (128, 2048):
        coef = XT.inverse_tie_blocks(2048, 571, level)
        ref = O.inverse_dct(coef, level)
        jit = np.asarray(jax.jit(JD._inverse_dct_ordered,
                                 static_argnums=1)(jnp.asarray(coef), level))
        assert (jit != ref).any(axis=1).sum() >= 5, level
        # the port: one 1-component image of the ties at quantizer 1
        n = len(coef)
        got = BT.idct_planes_exact(
            torch.from_numpy(coef[None].astype(np.int32)),
            geom=((1, n, 1, 1, 1, 1),), level=level, gray=False, sizes=(n,),
            qtuple=(tuple([1] * 64),))
        assert np.array_equal(got[0].numpy(),
                              BT._deblockify(ref[None], 1, n, 1, 1)), level


# ---------------------------------------------------------------------------
# Dispatch and refusals
# ---------------------------------------------------------------------------


def test_exact_paths_on_cpu_launch_and_build_nothing():
    before = (exact_cuda.fdct_exact_launches, exact_cuda.idct_exact_launches)
    rgbs = np.stack([_img(32, 32, 580 + i) for i in range(2)])
    streams = TC.encode_batch(rgbs, precision="exact", device=CPU)
    TC.encode_batch(rgbs, precision="exact", transport="rgb", device=CPU)
    for gray in (False, True):
        TC.decode_batch(streams, precision="exact", gray=gray, device=CPU)
    assert (exact_cuda.fdct_exact_launches,
            exact_cuda.idct_exact_launches) == before
    assert exact_cuda.LIB.handle is None


def test_exact_dispatchers_refuse_other_devices():
    meta = torch.zeros((1, 16, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="fdct_quantize_exact"):
        BT.fdct_quantize_exact(meta, meta[:, :8, :8], meta[:, :8, :8],
                               gray=False, rounded=False)
    with pytest.raises(ValueError, match="idct_planes_exact"):
        BT.idct_planes_exact(torch.zeros((1, 1, 64), dtype=torch.int16,
                                         device="meta"),
                             geom=((1, 1, 1, 1, 1, 1),), level=128,
                             gray=False, sizes=(1,), qtuple=((1,) * 64,))


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
def test_fdct_exact_wrapper_refuses_before_building(case):
    with pytest.raises(ValueError, match="fdct_quantize_exact_cuda"):
        exact_cuda.fdct_quantize_exact_cuda(*_fdct_args(case))
    assert exact_cuda.LIB.handle is None


@pytest.mark.parametrize("case", ["cpu", "dtype", "rank", "rows",
                                  "table shape", "sampling factor 5",
                                  "grid", "four components"])
def test_idct_exact_wrapper_refuses_before_building(case):
    coeff, kw = _idct_case("420")
    kw = dict(kw)
    qtab = BT.quant_tables(kw.pop("qtuple"), torch.device(CPU))
    if case == "dtype":
        coeff = coeff.to(torch.int64)
    elif case == "rank":
        coeff = coeff.reshape(2, -1)
    elif case == "rows":
        coeff = coeff[:, 1:]
    elif case == "table shape":
        qtab = qtab[:2]
    elif case == "sampling factor 5":
        g = kw["geom"]
        kw["geom"] = ((g[0][0], g[0][1], 5, 1, 1, 1),) + g[1:]
    elif case == "grid":
        g = kw["geom"]
        kw["geom"] = g[:2] + ((g[2][0] + 1,) + g[2][1:],)
    elif case == "four components":
        kw["geom"] += kw["geom"][-1:]
        kw["sizes"] += kw["sizes"][-1:]
    with pytest.raises(ValueError, match="idct_planes"):
        exact_cuda.idct_planes_exact_cuda(coeff, qtab, **kw)
    assert exact_cuda.LIB.handle is None
