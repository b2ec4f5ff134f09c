"""The ycc420 IDCT's three launches (csrc/block_transforms.cu,
idct_planes_sparse_kernel, idct_planes_overflow_kernel and
idct_planes_dense_kernel) in numpy: their schedules held to
block_transform.idct_planes_sparse_model and idct_planes_dense_model bit
for bit.
The overflow launch's on uploads whose overflow rows carry the float32 tie
set, the mixed warp groups, blocks that clamp at both ends, noise, other
sampling factors, fields at odd byte offsets, caps that are not multiples
of 8 and padding rows (testing/ycc_uploads.overflow_sets, at levels 128
and 2048); the sparse launch's on those, on the sparse rows of
ycc_uploads.sparse_sets (a float32 tie set, masks with more than K set
bits, K from 1 to 64, value bytes at every byte of a word, units at an MCU
row's end, one image), on the transport's own uploads and on seeded
uploads; the dense launch's on the scan's blocks of ycc_uploads.
dense_sets (the tie, mixed-group, clamp and noise sets, segments padded
past the images' MCUs, a quant table an image, corrupt segments) and of
the transport's own streams; and the uploads those sets are built with,
held to the transport's own.  numpy and the host library only: no JAX
compile, no card."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from jpezy_tpu_torch.codec import host_glue as HG
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.ops import block_transform as BT
from jpezy_tpu_torch.ops import exact_cuda
from jpezy_tpu_torch.ops import transform_cuda
from jpezy_tpu_torch.testing import ycc_uploads as YU
from test_torch_host_copies import host_runtime  # noqa: F401 (autouse)

BASIS = exact_cuda.INV_BASIS
# overflow rows a warp of the kernel takes together (kOvfTile), and the
# union bits from which it takes all 64 terms (kOvfDenseTerms)
TILE = 8
DENSE_TERMS = 32
# the sparse launch's unit of blocks (kSparseUnit) and the blocks whose
# masks one walk takes as a union (kSparseGroup)
UNIT = 32
GROUP = 16
# the dense launch's unit, one walk (kDenseUnit), and the union bits from
# which it takes all 64 terms (kDenseTerms)
DENSE_UNIT = 16
DENSE_GROUP_TERMS = 32
_Q = np.arange(4)
# the 16 mirror quads' base samples p = 8 y + x, [y, x]
_QUAD_P = 8 * _Q[:, None] + _Q[None, :]


def _mirror(s):
    """[..., i, y, x] samples of the 4 mirror positions of quad (y, x) ->
    [..., 8, 8]: i = 0 (y, x), 1 (y, 7 - x), 2 (7 - y, x), 3 (7 - y,
    7 - x)."""
    out = np.zeros(s.shape[:-3] + (8, 8), s.dtype)
    rows, cols = _Q[:, None], _Q[None, :]
    out[..., rows, cols] = s[..., 0, :, :]
    out[..., rows, 7 - cols] = s[..., 1, :, :]
    out[..., 7 - rows, cols] = s[..., 2, :, :]
    out[..., 7 - rows, 7 - cols] = s[..., 3, :, :]
    return out


def _tile_samples(d, level, union=None, finish=None):
    """The union walk of both sparse-form launches (quad_walk) on groups d
    [T, B, 64] of dequantized float32 blocks: per group the coefficients
    in `union` [T, 64] (by default those nonzero in any of its blocks), in
    ascending k = 8 v + u (the other blocks' zero coefficients adding
    +-0); per k and mirror quad (y, x < 4) one float32 product t = d[k]
    M[8 y + x][k], added as t into sample (y, x), as (-1)^u t into (y,
    7 - x), (-1)^v t into (7 - y, x) and (-1)^(u + v) t into (7 - y,
    7 - x); the k = 0 term stored in place of its add onto +0; then + level
    in float32, truncated and clamped to [0, 255] (or `finish` of the sums
    and the level) -> [T, B, 8, 8] uint8."""
    if union is None:
        union = (d != 0).any(axis=1)
    base = BASIS[_QUAD_P.ravel()].reshape(4, 4, 64)
    acc = np.zeros(d.shape[:2] + (4, 4, 4), np.float32)  # [T, b, i, y, x]
    for k in range(64):
        v, u = divmod(k, 8)
        g = union[:, k]
        t = d[g, :, k][:, :, None, None] * base[None, None, :, :, k]
        sign = np.array([1, (-1) ** u, (-1) ** v, (-1) ** (u + v)],
                        np.float32)
        term = t[:, :, None] * sign[None, None, :, None, None]  # exact
        acc[g] = term if k == 0 else acc[g] + term
    return _mirror((finish or _clamped)(acc, level))


def _clamped(s, level):
    """float32 sums + level in float32, truncated, clamped to [0, 255]."""
    return np.clip(np.trunc(s + np.float32(level)), 0, 255).astype(np.uint8)


def _sample_of(s, level):
    """The kernels' sample_of: + level in float32, clamped to [0, 255]
    first, then its floor."""
    x = np.clip(s + np.float32(level), np.float32(0), np.float32(255))
    return np.floor(x).astype(np.uint8)


def _unit_groups(mcus_y, mcus_x, v, h, group=GROUP, unit=UNIT):
    """The sparse launch's walks over one image's blocks of a component
    with sampling factors v x h (the dense launch's with unit=DENSE_UNIT):
    [walks, group] block indices, -1 past a unit's blocks.  A unit is up
    to unit // (v h) MCUs of one MCU row (one MCU where it holds more), its
    blocks consecutive from (my mcus_x + mx0) v h; a walk takes `group` of
    them."""
    per = v * h
    mpu = unit // per if per < unit else 1
    walks = []
    for my in range(mcus_y):
        for mx0 in range(0, mcus_x, mpu):
            b0, nb = (my * mcus_x + mx0) * per, min(mpu, mcus_x - mx0) * per
            walks += [[b0 + g0 + i if g0 + i < nb else -1
                       for i in range(group)] for g0 in range(0, nb, group)]
    return np.array(walks, np.int64).reshape(-1, group)


def _sparse_rows(flat, kw, cut=True):
    """Per component of an upload its blocks' masks, [N B_c, 64] bool, cut
    to their first K set bits (all of them without `cut`), and dequantized
    coefficients d = c q as int32 (c the value byte of the bit's rank, the
    last one past the K-th), [N B_c, 64]."""
    flat = np.asarray(flat, np.uint8)
    N, K = kw["N"], kw["K"]
    X = sum((8 + K) * bn for bn in kw["shapes"])
    rows = flat[:N * X].reshape(N, X)
    out, off = [], 0
    j = np.arange(64, dtype=np.uint64)
    for bn, qt in zip(kw["shapes"], kw["qtuple"]):
        lo, hi = (np.frombuffer(rows[:, o:o + 4 * bn].tobytes(), "<u4")
                  .astype(np.uint64) for o in (off, off + 4 * bn))
        vals = rows[:, off + 8 * bn:off + (8 + K) * bn].reshape(
            N * bn, K).view(np.int8).astype(np.int64)
        off += (8 + K) * bn
        bit = ((lo | (hi << np.uint64(32)))[:, None] >> j) & np.uint64(1)
        bit = bit.astype(np.int64)
        rank = np.cumsum(bit, axis=1) - bit
        keep = (bit == 1) & ((rank < K) | (not cut))
        c = np.take_along_axis(vals, np.minimum(rank, K - 1), axis=1)
        d = np.where(keep, c * np.asarray(qt, np.int64)[None], 0)
        out.append((keep, d.astype(np.int32)))
    return out


def _schedule_sparse(flat, kw, group=GROUP, cut=True):
    """The sparse form's two launches with the sparse launch's schedule,
    then the overflow launch's (_schedule_overflow): per component and
    image the units' walks (_unit_groups); each block's mask cut to its
    first K set bits, its coefficient k = c q (int32) at a kept bit, else
    0; the union of the walk's cut masks.  A walk whose union holds no bit
    but k = 0 gives each quad its one term fl(d[0] M[p][0]) + level for
    its 4 samples; any other walks the union (_tile_samples).  Blocks past
    a unit's end hold nothing and store nothing.  cut=False walks every set
    bit of a mask (a kernel without the cut to the first K)."""
    N, geom = kw["N"], kw["geom"]
    planes = []
    for (keep, d), g in zip(_sparse_rows(flat, kw, cut), geom):
        mcus_y, mcus_x, v, h = (int(x) for x in g[:4])
        bn = mcus_y * mcus_x * v * h
        walks = _unit_groups(mcus_y, mcus_x, v, h, group)    # [W, group]
        live = np.tile(walks >= 0, (N, 1))                     # [N W, group]
        at = (np.maximum(walks, 0)[None]
              + bn * np.arange(N)[:, None, None]).reshape(-1, group)
        dg = np.where(live[..., None], d[at], 0).astype(np.float32)
        union = np.where(live[..., None], keep[at], False).any(axis=1)
        samples = _tile_samples(dg, kw["level"], union)
        flat_walk = ~union[:, 1:].any(axis=1)
        if flat_walk.any():
            t = (dg[flat_walk, :, 0, None, None]
                 * BASIS[_QUAD_P, 0][None, None])             # [T, b, y, x]
            s = _clamped(t, kw["level"])
            samples[flat_walk] = _mirror(np.repeat(s[:, :, None], 4, axis=2))
        blocks = np.zeros((N * bn, 8, 8), np.uint8)
        blocks[at[live]] = samples[live]
        planes.append(BT._deblockify(blocks.reshape(N, bn, 64), mcus_y,
                                     mcus_x, v, h).reshape(N, bn * 64))
    return _schedule_overflow(flat, kw, np.concatenate(planes, axis=1))


def _schedule_overflow(flat, kw, planes=None):
    """The sparse form's two launches with the overflow launch's schedule:
    the planes of the sparse launch (by default the model without the
    tails: an overflow block's mask is clear, so it holds its level), then
    per component its rows in tiles of 8 in upload order (the last tile
    padded with rows that are not there); a row whose index is outside
    [0, N B_c) is zero (no term) and stores nothing, each other row's 64
    samples (_tile_samples) go to its block's place in the planes."""
    flat = np.asarray(flat, np.uint8)
    N, shapes, geom = kw["N"], kw["shapes"], kw["geom"]
    if planes is None:
        planes = BT.idct_planes_sparse_model(
            flat, **dict(kw, caps=(0,) * len(shapes)))
    p0 = 0
    for (rows, oidx), Bn, qt, g in zip(YU.overflow_tails(flat, kw), shapes,
                                       kw["qtuple"], geom):
        mcus_y, mcus_x, v, h = (int(x) for x in g[:4])
        H, W = mcus_y * v * 8, mcus_x * h * 8
        plane = planes[:, p0:p0 + H * W].reshape(N, H, W)
        p0 += H * W
        live = (oidx >= 0) & (oidx < N * Bn)
        n_t = -(-len(rows) // TILE) * TILE
        d = np.zeros((n_t, 64), np.int32)
        d[:len(rows)] = np.where(live[:, None], rows, 0) \
            * np.asarray(qt, np.int32)[None]
        samples = _tile_samples(d.astype(np.float32).reshape(-1, TILE, 64),
                                kw["level"]).reshape(n_t, 8, 8)
        for i in np.flatnonzero(live):
            n, bi = divmod(int(oidx[i]), Bn)
            m, r = divmod(bi, v * h)
            my, mx = divmod(m, mcus_x)
            y0, x0 = (my * v + r // h) * 8, (mx * h + r % h) * 8
            plane[n, y0:y0 + 8, x0:x0 + 8] = samples[i]
    return planes


SETS = [(level, label) for level in (128, 2048)
        for label in ("ties", "mixed groups", "clamp", "noise",
                      "samplings, 3 components", "samplings, 1 component",
                      "junk padding")]
_BUILT = {}


def _set(level, label):
    if level not in _BUILT:
        _BUILT[level] = YU.overflow_sets(level)
    return _BUILT[level][label]


@pytest.mark.parametrize("level, label", SETS)
def test_schedule_overflow_equals_model(level, label):
    flat, kw = _set(level, label)
    assert any(kw["caps"])
    assert np.array_equal(_schedule_overflow(flat, kw),
                          BT.idct_planes_sparse_model(flat, **kw))


def test_schedule_overflow_on_the_transports_noise_upload():
    """Noise at quality 100 through the codec and the transport's host
    half: every block an overflow row, the tails padded with the
    sentinel."""
    noise = np.random.default_rng(420).integers(0, 256, (3, 32, 48, 3),
                                                dtype=np.uint8)
    flat, kw, *_ = TC._decode_host_prep(
        TC.encode_batch(noise, quality=100, device="cpu"), gray=False,
        precision="fast", transport=None)
    rows = YU.overflow_rows(flat, kw)
    assert rows == [kw["N"] * Bn for Bn in kw["shapes"]]
    assert all(cap > r for cap, r in zip(kw["caps"], rows))
    assert np.array_equal(_schedule_overflow(flat, kw),
                          BT.idct_planes_sparse_model(flat, **kw))


@settings(max_examples=20, deadline=None, derandomize=True)
@given(st.integers(0, 2**31 - 1), st.sampled_from([128, 2048]),
       st.sampled_from([((2, 2), (1, 1), (1, 1)), ((1, 2), (1, 1), (1, 1)),
                        ((4, 4),), ((1, 3), (2, 1))]),
       st.sampled_from([1, 4, 10, 13]), st.sampled_from([None, 0, 1, 9]))
def test_schedule_overflow_random_uploads(seed, level, factors, K, pad):
    """Seeded blocks at densities from empty to dense (tiles mixing dense
    rows with sparse ones) at any sampling, K and padding."""
    rng = np.random.default_rng(seed)
    scale = level // 128
    comps = [YU._random_blocks(rng, 2, 3 * v * h, scale) for v, h in factors]
    flat, kw = YU.sparse_upload(comps, K=K, pad=pad)
    qt = tuple(tuple(int(x) for x in rng.integers(1, 9, 64))
               for _ in factors)
    kw.update(geom=YU.geometry(1, 3, factors), level=level, qtuple=qt)
    assert np.array_equal(_schedule_overflow(flat, kw),
                          BT.idct_planes_sparse_model(flat, **kw))


def test_sets_reach_both_walks_and_both_clamps():
    """The sets' tiles take the kernel's branch-free run (DENSE_TERMS or
    more union bits) and its skipping walk, and their samples saturate at 0
    and at 255."""
    dense = sparse = low = high = 0
    for level, label in SETS:
        flat, kw = _set(level, label)
        for rows, oidx in YU.overflow_tails(flat, kw):
            n_t = -(-len(rows) // TILE) * TILE
            d = np.zeros((n_t, 64), np.int32)
            d[:len(rows)] = np.where((oidx >= 0)[:, None], rows, 0)
            bits = (d.reshape(-1, TILE, 64) != 0).any(axis=1).sum(axis=1)
            dense += int((bits >= DENSE_TERMS).sum())
            sparse += int(((bits > 0) & (bits < DENSE_TERMS)).sum())
        planes = BT.idct_planes_sparse_model(flat, **kw)
        low += int((planes == 0).sum())
        high += int((planes == 255).sum())
    assert min(dense, sparse, low, high) > 0


def test_mixed_groups_are_the_kernels_tiles():
    """Every block of the mixed set is an overflow row in block order, so
    tile i is the set's group i: dense groups beside sparse ones."""
    flat, kw = _set(128, "mixed groups")
    (rows, oidx), = YU.overflow_tails(flat, kw)
    assert np.array_equal(oidx, np.arange(len(oidx)))
    nz = (rows.reshape(-1, TILE, 64) != 0)
    assert np.all(nz.sum(axis=2).max(axis=1)[0::2] >= 60)
    assert np.all(nz.any(axis=1).sum(axis=1)[1::2] < 32)


def test_junk_padding_indices_lie_outside_the_batch():
    flat, kw = _set(2048, "junk padding")
    for (rows, oidx), Bn in zip(YU.overflow_tails(flat, kw), kw["shapes"]):
        pad = oidx[-11:]
        assert np.all((pad < 0) | (pad >= kw["N"] * Bn))
        assert np.any(rows[-11:] != 0)
        assert set(np.unique(pad)) >= {-1, kw["N"] * Bn, -(1 << 31)}


@pytest.mark.parametrize("seed", [0, 1])
def test_sparse_upload_is_the_transports_upload(seed):
    """YU.sparse_upload of the blocks that the host frontend decodes is
    byte for byte the transport's upload (codec/host_glue.
    _ycc420_host_frontend), its shapes and caps too."""
    from imagegen import make_test_image

    rgbs = np.stack([make_test_image(48, 64, seed=430 + 2 * seed + i)
                     for i in range(2)])
    quality = (75, 100)[seed]
    streams = TC.encode_batch(rgbs, quality=quality, device="cpu")
    pjs, _, _ = TC._parse_batch(streams)
    want, shapes, caps = HG._ycc420_host_frontend(pjs, 10)
    blocks = [HG.decode_entropy_host(pj) for pj in pjs]
    comps = [np.stack([b[c] for b in blocks]) for c in range(3)]
    flat, kw = YU.sparse_upload(comps, K=10)
    assert (kw["shapes"], kw["caps"]) == (shapes, caps)
    assert np.array_equal(flat, want)


def test_host_cap_is_the_transports():
    assert [YU.host_cap(n) for n in (0, 1, 16, 17, 100)] == [0, 16, 16, 32,
                                                            128]


def test_sparse_upload_refuses_wide_values():
    with pytest.raises(ValueError, match="int16"):
        YU.sparse_upload([np.full((1, 1, 64), 40000)])


def test_idct_planes_sparse_cuda_refuses_cpu_tensors_before_building():
    """The wrapper and the earlier design's binding share its checks, which
    stop a CPU upload before any library is built."""
    flat, kw = _set(128, "clamp")
    q = torch.ones((1, 64), dtype=torch.int32)
    args = {k: kw[k] for k in ("geom", "level", "shapes", "K", "N", "caps")}
    with pytest.raises(ValueError, match="CUDA"):
        transform_cuda.idct_planes_sparse_cuda(torch.from_numpy(flat), q,
                                               **args)
    with pytest.raises(ValueError, match="CUDA"):
        transform_cuda.sparse_desc(torch.from_numpy(flat), q, **args)
    assert transform_cuda.LIB.handle is None


# ---------------------------------------------------------------------------
# The sparse launch's schedule (_schedule_sparse)
# ---------------------------------------------------------------------------

SPARSE_LABELS = ("sparse ties", "junk masks", "K = 1", "K = 13",
                 "K = 64, N = 1")
SPARSE_SETS = [(level, label) for level in (128, 2048)
               for label in SPARSE_LABELS]
_SPARSE_BUILT = {}


def _sparse_set(level, label):
    if level not in _SPARSE_BUILT:
        _SPARSE_BUILT[level] = YU.sparse_sets(level)
    return _SPARSE_BUILT[level][label]


def _any_set(level, label):
    return (_sparse_set if label in SPARSE_LABELS else _set)(level, label)


@pytest.mark.parametrize("level, label", SPARSE_SETS + SETS)
def test_schedule_sparse_equals_model(level, label):
    """The sparse launch's unions, +-0 terms, mirror quads, k = 0 store
    and DC-only groups, then the overflow launch, on every set of
    testing/ycc_uploads."""
    flat, kw = _any_set(level, label)
    assert np.array_equal(_schedule_sparse(flat, kw),
                          BT.idct_planes_sparse_model(flat, **kw))


@pytest.mark.parametrize("group", [4, 8, 16])
@pytest.mark.parametrize("level, label", [(128, "junk masks"),
                                          (2048, "K = 13"),
                                          (128, "samplings, 1 component")])
def test_schedule_sparse_any_union_size(group, level, label):
    """Walks of 4, 8 or 16 blocks (the union sizes scripts/
    idct_sparse_phases.py and chip_smoke.py time) give the same planes."""
    flat, kw = _any_set(level, label)
    assert np.array_equal(_schedule_sparse(flat, kw, group),
                          BT.idct_planes_sparse_model(flat, **kw))


@pytest.mark.parametrize("quality", [75, 95])
def test_schedule_sparse_on_the_transports_uploads(quality):
    """The main test images through the codec and the transport's host
    half (codec/host_glue), at quality 75 (no overflow row) and 95 (luma
    overflow rows)."""
    from imagegen import make_test_image

    rgbs = np.stack([make_test_image(64, 80, seed=440 + i)
                     for i in range(2)])
    flat, kw, *_ = TC._decode_host_prep(
        TC.encode_batch(rgbs, quality=quality, device="cpu"), gray=False,
        precision="fast", transport=None)
    assert np.array_equal(_schedule_sparse(flat, kw),
                          BT.idct_planes_sparse_model(flat, **kw))


@settings(max_examples=25, deadline=None, derandomize=True)
@given(st.integers(0, 2**31 - 1), st.sampled_from([128, 2048]),
       st.lists(st.tuples(st.integers(1, 4), st.integers(1, 4)), min_size=1,
                max_size=3),
       st.integers(1, 64), st.sampled_from([0.0, 0.3]),
       st.integers(1, 2), st.integers(1, 5))
def test_schedule_sparse_random_uploads(seed, level, factors, K, junk, n,
                                        mcus_x):
    """Seeded uploads at any sampling factors 1..4, K 1..64, masks with
    more than K set bits and odd MCU widths."""
    rng = np.random.default_rng(seed)
    scale = level // 128
    comps = [YU._random_blocks(rng, n, 2 * mcus_x * v * h, scale)
             for v, h in factors]
    flat, kw = YU.sparse_upload(comps, K=K)
    if junk:
        flat = YU.junk_masks(flat, kw, seed, junk)
    qt = tuple(tuple(int(x) for x in rng.integers(1, 9, 64))
               for _ in factors)
    kw.update(geom=YU.geometry(2, mcus_x, factors), level=level, qtuple=qt)
    assert np.array_equal(_schedule_sparse(flat, kw),
                          BT.idct_planes_sparse_model(flat, **kw))


def test_schedule_sparse_without_images():
    """N = 0: no plane, no walk (the wrapper launches nothing)."""
    flat = np.zeros(0, np.uint8)
    kw = dict(shapes=(4,), K=10, N=0, caps=(0,),
              geom=YU.geometry(1, 4, ((1, 1),)), level=128,
              qtuple=(tuple([1] * 64),))
    assert _schedule_sparse(flat, kw).shape == (0, 256)
    assert BT.idct_planes_sparse_model(flat, **kw).shape == (0, 256)
    assert tuple(BT.idct_planes_sparse(torch.from_numpy(flat), **kw).shape) \
        == (0, 256)


def _unit_starts(kw):
    """Per unit of an upload (component, image, unit): (the byte its value
    bytes start at, the byte its low mask words start at, its first
    sample's byte in the [N, P] planes, whether it ends an MCU row short of
    UNIT blocks)."""
    N, K = kw["N"], kw["K"]
    X = sum((8 + K) * bn for bn in kw["shapes"])
    P = sum(int(g[0]) * int(g[2]) * 8 * int(g[1]) * int(g[3]) * 8
            for g in kw["geom"])
    out, off, plane = [], 0, 0
    for bn, g in zip(kw["shapes"], kw["geom"]):
        mcus_y, mcus_x, v, h = (int(x) for x in g[:4])
        per = v * h
        mpu = UNIT // per if per < UNIT else 1
        width = mcus_x * h * 8
        for n in range(N):
            for my in range(mcus_y):
                for mx0 in range(0, mcus_x, mpu):
                    b0 = (my * mcus_x + mx0) * per
                    out.append((n * X + off + 8 * bn + b0 * K,
                                n * X + off + 4 * b0,
                                n * P + plane + my * v * 8 * width
                                + mx0 * h * 8,
                                mcus_x - mx0 < mpu))
        off += (8 + K) * bn
        plane += mcus_y * v * 8 * width
    return out


def test_sets_reach_every_hard_case():
    """The sets hold each case a union walk over sparse rows meets: masks
    with more than K set bits (which the cut to the first K changes);
    value bytes and mask words that start at every byte of a word, K 1, 64
    and odd, image rows whose length is not a multiple of 4; units that
    end an MCU row short, sampling factors 3 x 4 and 4 x 1; plane widths
    and unit destinations off a 16-byte boundary; one image; level 2048;
    sums that cancel to 0 and blocks adding -0 to a sum of +0 (a walk's
    union bit k > 0 where the block has none); samples clamped at 0 and at
    255; walks of DC-only groups and of wider unions."""
    every = [(lvl, lab) for lvl, lab in SPARSE_SETS + SETS]
    ks, rows, vals, masks, short, dests, widths, factors = (
        set(), set(), set(), set(), 0, set(), set(), set())
    junk = cancel = minus0 = low = high = dc_walks = wide_walks = 0
    ones = False
    for lvl, lab in every:
        flat, kw = _any_set(lvl, lab)
        X = sum((8 + kw["K"]) * bn for bn in kw["shapes"])
        ks.add(kw["K"])
        rows.add(X % 4)
        ones |= kw["N"] == 1
        for g in kw["geom"]:
            factors.add((int(g[2]), int(g[3])))
            widths.add(int(g[1]) * int(g[3]) * 8 % 16)
        for v0, m0, d0, end in _unit_starts(kw):
            vals.add(v0 % 4)
            masks.add(m0 % 4)
            dests.add(d0 % 16)
            short += end
        planes = BT.idct_planes_sparse_model(flat, **kw)
        low += int((planes == 0).sum())
        high += int((planes == 255).sum())
        for (keep, d), (bits, _), bn, g in zip(
                _sparse_rows(flat, kw), _sparse_rows(flat, kw, cut=False),
                kw["shapes"], kw["geom"]):
            N = kw["N"]
            junk += int((bits.sum(axis=1) > kw["K"]).sum())
            s = BT.sum_ascending(d.astype(np.float32), BASIS)
            cancel += int(((s == 0) & keep.any(axis=1)[:, None]).sum())
            walks = _unit_groups(*(int(x) for x in g[:4]))
            live = np.tile(walks >= 0, (N, 1))
            at = (np.maximum(walks, 0)[None]
                  + bn * np.arange(N)[:, None, None]).reshape(-1, GROUP)
            kept = np.where(live[..., None], keep[at], False)
            union = kept.any(axis=1)
            dc_walks += int((~union[:, 1:].any(axis=1)).sum())
            wide_walks += int((union.sum(axis=1) >= 8).sum())
            minus0 += int((union[:, None, 1:] & ~kept[:, :, 1:]
                           & live[..., None]).any(axis=2).sum())
    assert junk > 0
    assert {1, 64} <= ks and any(k % 2 for k in ks)
    assert rows - {0} and vals == {0, 1, 2, 3} and masks - {0}
    assert short > 0 and {(3, 4), (4, 1)} <= factors
    assert 8 in widths and dests - {0}
    assert ones and {128, 2048} <= {lvl for lvl, _ in every}
    assert min(cancel, minus0, low, high, dc_walks, wide_walks) > 0



def test_junk_masks_need_the_cut_to_k():
    """Walking every set bit of the junk masks, not their first K, gives
    other planes (at level 128; at 2048 most samples clamp): the sets
    hold the cut to a difference."""
    flat, kw = _sparse_set(128, "junk masks")
    assert not np.array_equal(_schedule_sparse(flat, kw, cut=False),
                              BT.idct_planes_sparse_model(flat, **kw))



# ---------------------------------------------------------------------------
# The dense launch's schedule (_schedule_dense)
# ---------------------------------------------------------------------------

DENSE_LABELS = ("ties", "mixed groups", "clamp", "noise", "random, padded")
DENSE_SETS = [(level, label) for level in (128, 2048)
              for label in DENSE_LABELS]
_DENSE_BUILT = {}


def _dense_set(level, label):
    if level not in _DENSE_BUILT:
        _DENSE_BUILT[level] = YU.dense_sets(level)
    return _DENSE_BUILT[level][label]


def _dense_walks(blocks, qarr, kw):
    """Per component, the dense launch's walks as it stages them: (the
    walks' block indices [N W, DENSE_UNIT] into the component's blocks of
    the batch, -1 past a unit's, the coefficients c [N W, DENSE_UNIT, 64]
    it copies from the scan's slots, n image_blocks + (m0 + i // per) 6 +
    slot0 + i % per for block i of a unit whose first MCU is m0, the
    image's quant table [N W, 64]), the units of one image, then the
    next's."""
    N, nseg, ri, geom = kw["N"], kw["nseg"], kw["ri"], kw["geom"]
    flat = np.asarray(blocks).reshape(-1, 64)
    image_blocks = nseg * ri * 6
    out, slot0 = [], 0
    for c, g in enumerate(geom):
        mcus_y, mcus_x, v, h = (int(x) for x in g[:4])
        per = v * h
        bn = mcus_y * mcus_x * per
        walks = _unit_groups(mcus_y, mcus_x, v, h, DENSE_UNIT, DENSE_UNIT)
        live = walks >= 0
        bi = np.maximum(walks, 0)
        slots = (bi // per) * 6 + slot0 + bi % per
        at, cs, qs = [], [], []
        for n in range(N):
            at.append(np.where(live, walks + n * bn, -1))
            cs.append(np.where(live[..., None],
                               flat[n * image_blocks + slots], 0))
            qs.append(np.repeat(np.asarray(qarr)[n, c][None], len(walks), 0))
        out.append((np.concatenate(at), np.concatenate(cs).astype(np.int32),
                    np.concatenate(qs).astype(np.int32)))
        slot0 += per
    return out


def _schedule_dense(blocks, bad, qarr, kw, threshold=DENSE_GROUP_TERMS):
    """The dense launch in numpy: per component its units of DENSE_UNIT
    blocks, one walk each (_dense_walks); the walk's union of the staged
    blocks' nonzero coefficients c != 0, or all 64 where it holds
    `threshold` or more (the straight run); each term's d = c q as a
    32-bit product, then a float; the union walk with one product a
    mirror quad and the k = 0 store (_tile_samples), sample_of's clamp
    (_sample_of); blocks past a unit's end store nothing; then each
    image's flag byte, the OR of its segments' flags."""
    N, nseg, geom, level = kw["N"], kw["nseg"], kw["geom"], kw["level"]
    planes = []
    for (at, c, q), g in zip(_dense_walks(blocks, qarr, kw), geom):
        mcus_y, mcus_x, v, h = (int(x) for x in g[:4])
        bn = mcus_y * mcus_x * v * h
        union = (c != 0).any(axis=1)
        union[union.sum(axis=1) >= threshold] = True
        d = (c.astype(np.int64) * q[:, None, :]).astype(np.int32)
        samples = _tile_samples(d.astype(np.float32), level, union,
                                finish=_sample_of)
        out = np.zeros((N * bn, 8, 8), np.uint8)
        out[at[at >= 0]] = samples[at >= 0]
        planes.append(BT._deblockify(out.reshape(N, bn, 64), mcus_y, mcus_x,
                                     v, h).reshape(N, bn * 64))
    flags = np.asarray(bad).reshape(N, nseg).any(axis=1).astype(np.uint8)
    return np.concatenate(planes + [flags[:, None]], axis=1)


@pytest.mark.parametrize("level, label", DENSE_SETS)
def test_schedule_dense_equals_model(level, label):
    """The dense launch's unions, straight runs, +-0 terms, mirror quads,
    k = 0 store and sample_of's clamp, on every set of ycc_uploads.
    dense_sets."""
    blocks, bad, qarr, kw = _dense_set(level, label)
    assert np.array_equal(_schedule_dense(blocks, bad, qarr, kw),
                          BT.idct_planes_dense_model(blocks, bad, qarr,
                                                     **kw))


@pytest.mark.parametrize("threshold", [1, 65])
def test_schedule_dense_any_threshold(threshold):
    """Every walk straight (1) or every walk skipping (65): the same
    planes, as the +-0 terms of the blocks without a coefficient add
    nothing."""
    blocks, bad, qarr, kw = _dense_set(128, "mixed groups")
    assert np.array_equal(
        _schedule_dense(blocks, bad, qarr, kw, threshold),
        BT.idct_planes_dense_model(blocks, bad, qarr, **kw))


@pytest.mark.parametrize("quality, restart", [(75, 3), (95, 8)])
def test_schedule_dense_on_the_transports_blocks(quality, restart):
    """The main test images through the codec, their blocks from the host
    decoder laid out as the scan lays them (ycc_uploads.scan_blocks, junk
    in the padding), each image its own tables (quality 75 and 95)."""
    from imagegen import make_test_image

    rgbs = np.stack([make_test_image(48, 80, seed=450 + i)
                     for i in range(2)])
    pjs = []
    for i, q in enumerate((quality, 100 - quality // 5)):
        pjs += TC._parse_batch(TC.encode_batch(rgbs[i:i + 1], quality=q,
                                               device="cpu"))[0]
    decoded = [HG.decode_entropy_host(pj) for pj in pjs]
    comps = [np.stack([b[c] for b in decoded]) for c in range(3)]
    blocks, bad, kw = YU.scan_blocks(comps, 5, restart,
                                     np.random.default_rng(quality),
                                     bad_segments=(0,))
    qarr = HG._quant_arr(pjs)
    kw["level"] = 128
    assert not np.array_equal(qarr[0], qarr[1])
    assert np.array_equal(_schedule_dense(blocks, bad, qarr, kw),
                          BT.idct_planes_dense_model(blocks, bad, qarr,
                                                     **kw))


def test_dense_sets_reach_both_walks_and_both_clamps():
    """The dense sets' walks take the straight run (DENSE_GROUP_TERMS or
    more union bits), the skipping walk and walks of no coefficient; their
    samples saturate at 0 and at 255; units end MCU rows short; segments
    hold junk past the images' MCUs; every set's images have tables of
    their own and a corrupt segment that flags its image."""
    straight = skipping = empty = low = high = short = padded = 0
    for level, label in DENSE_SETS:
        blocks, bad, qarr, kw = _dense_set(level, label)
        for at, c, _ in _dense_walks(blocks, qarr, kw):
            bits = (c != 0).any(axis=1).sum(axis=1)
            straight += int((bits >= DENSE_GROUP_TERMS).sum())
            skipping += int(((bits > 0) & (bits < DENSE_GROUP_TERMS)).sum())
            empty += int((bits == 0).sum())
            short += int(((at >= 0).sum(axis=1) < DENSE_UNIT).sum())
        nmcu = kw["geom"][0][0] * kw["geom"][0][1]
        b6 = blocks.reshape(kw["N"], kw["nseg"] * kw["ri"], 6, 64)
        padded += int((b6[:, nmcu:] != 0).any())
        planes = BT.idct_planes_dense_model(blocks, bad, qarr, **kw)
        low += int((planes[:, :-1] == 0).sum())
        high += int((planes[:, :-1] == 255).sum())
        assert planes[:, -1].tolist()[:2] == [0, 1], label
        assert kw["nseg"] * kw["ri"] > nmcu, label
        assert label == "mixed groups" or not np.array_equal(qarr[0], qarr[1])
    assert min(straight, skipping, empty, low, high, short, padded) > 0


def test_scan_blocks_is_the_scans_layout():
    """YU.scan_blocks puts MCU m of image n at segment n nseg + m // ri,
    slots 6 (m % ri) ..: idct_planes_dense_plain's planes of its blocks
    equal idct_planes_sparse_plain's of the same blocks in the ycc420
    upload."""
    blocks, bad, qarr, kw = _dense_set(128, "random, padded")
    nmcu = kw["geom"][0][0] * kw["geom"][0][1]
    b6 = blocks.reshape(kw["N"], kw["nseg"] * kw["ri"], 6, 64)[:, :nmcu]
    comps = [b6[:, :, :4].reshape(kw["N"], 4 * nmcu, 64), b6[:, :, 4],
             b6[:, :, 5]]
    geom = YU.geometry(kw["geom"][0][0], kw["geom"][0][1],
                       ((2, 2), (1, 1), (1, 1)))
    dense = BT.idct_planes_dense_plain(torch.from_numpy(blocks),
                                       torch.from_numpy(bad),
                                       torch.from_numpy(qarr), **kw)
    for n in range(kw["N"]):
        flat, skw = YU.sparse_upload([c[n:n + 1] for c in comps], K=10)
        sparse = BT.idct_planes_sparse_plain(
            torch.from_numpy(flat), geom=geom, level=128, **skw,
            qtuple=tuple(tuple(int(x) for x in qarr[n, c])
                         for c in range(3)))
        assert torch.equal(sparse[0], dense[n, :-1])
