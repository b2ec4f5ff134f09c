"""The ycc420 IDCT's overflow launch (csrc/block_transforms.cu,
idct_planes_overflow_kernel) in numpy: its schedule held to
block_transform.idct_planes_sparse_model bit for bit on uploads whose
overflow rows carry the float32 tie set, the mixed warp groups, blocks that
clamp at both ends, noise, other sampling factors, fields at odd byte
offsets, caps that are not multiples of 8 and padding rows (the
testing/ycc_uploads sets, at levels 128 and 2048); and the uploads those
sets are built with, held to the transport's own.  numpy and the host
library only: no JAX compile, no card."""
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


def _tile_samples(d, level):
    """idct_planes_overflow_kernel's float part on tiles d [T, 8, 64] of
    dequantized float32 rows: per tile the coefficients nonzero in any of
    its rows, in ascending k = 8 v + u (the other rows' zero coefficients
    adding +-0); per k and mirror quad (y, x < 4) one float32 product t =
    d[k] M[8 y + x][k], added as t into sample (y, x), as (-1)^u t into
    (y, 7 - x), (-1)^v t into (7 - y, x) and (-1)^(u + v) t into (7 - y,
    7 - x); the k = 0 term stored in place of its add onto +0; then + level
    in float32, truncated and clamped to [0, 255] -> [T, 8, 8, 8] uint8."""
    union = (d != 0).any(axis=1)
    q = np.arange(4)
    base = BASIS[(8 * q[:, None] + q[None, :]).ravel()].reshape(4, 4, 64)
    acc = np.zeros(d.shape[:2] + (4, 4, 4), np.float32)  # [T, b, i, y, x]
    for k in range(64):
        v, u = divmod(k, 8)
        g = union[:, k]
        t = d[g, :, k][:, :, None, None] * base[None, None, :, :, k]
        sign = np.array([1, (-1) ** u, (-1) ** v, (-1) ** (u + v)],
                        np.float32)
        term = t[:, :, None] * sign[None, None, :, None, None]  # exact
        acc[g] = term if k == 0 else acc[g] + term
    s = np.clip(np.trunc(acc + np.float32(level)), 0, 255).astype(np.uint8)
    out = np.zeros(d.shape[:2] + (8, 8), np.uint8)
    rows, cols = q[:, None], q[None, :]
    out[:, :, rows, cols] = s[:, :, 0]
    out[:, :, rows, 7 - cols] = s[:, :, 1]
    out[:, :, 7 - rows, cols] = s[:, :, 2]
    out[:, :, 7 - rows, 7 - cols] = s[:, :, 3]
    return out


def _schedule_overflow(flat, kw):
    """The sparse form's two launches with the overflow launch's schedule:
    the planes of the sparse launch (the model without the tails: an
    overflow block's mask is clear, so it holds its level), then per
    component its rows in tiles of 8 in upload order (the last tile padded
    with rows that are not there); a row whose index is outside [0, N B_c)
    is zero (no term) and stores nothing, each other row's 64 samples
    (_tile_samples) go to its block's place in the planes."""
    flat = np.asarray(flat, np.uint8)
    N, shapes, geom = kw["N"], kw["shapes"], kw["geom"]
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
