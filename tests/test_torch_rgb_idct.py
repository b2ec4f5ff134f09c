"""The fast rgb IDCT's kernel schedule (csrc/exact_transforms.cu,
idct_planes_rgb_kernel) in numpy, held to block_transform.inverse_model
bit for bit; the mirror symmetry of the float32 basis it relies on; its
float32 tie set (jpezy_tpu_torch/testing/rgb_ties.py); and the wrapper's
refusal of any other basis.  numpy only: no JAX compile, no card."""
from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from jpezy_tpu_torch.codec import oracle as O
from jpezy_tpu_torch.ops import block_transform as BT
from jpezy_tpu_torch.ops import exact_cuda
from jpezy_tpu_torch.testing import exact_ties as XT
from jpezy_tpu_torch.testing import rgb_ties as RT

BASIS = exact_cuda.INV_BASIS


# blocks a warp of the kernel takes together (kRgbTile)
TILE = 8


def _groups(a, n=TILE):
    """Blocks [B, 64] -> [G, n, 64], the last group padded with zero blocks,
    as a kernel warp takes them (n consecutive blocks of a component)."""
    out = np.zeros((-(-len(a) // n) * n, 64), a.dtype)
    out[:len(a)] = a
    return out.reshape(-1, n, 64)


def _schedule_inverse_rgb(deq, level):
    """idct_planes_rgb_kernel's float part: per group of 8 blocks the
    coefficients nonzero in any of them, in ascending k = 8 v + u (the
    other blocks' zero coefficients adding +-0); per k and mirror quad
    (y, x < 4) one float32 product t = d[k] M[8 y + x][k], added as t into
    sample (y, x), as (-1)^u t into (y, 7 - x), (-1)^v t into (7 - y, x)
    and (-1)^(u + v) t into (7 - y, 7 - x); the k = 0 term stored in place
    of its add onto +0; then + level in float32, truncated."""
    d = _groups(np.asarray(deq, np.int64)).astype(np.float32)  # [G, b, k]
    union = (d != 0).any(axis=1)
    q = np.arange(4)
    base = BASIS[(8 * q[:, None] + q[None, :]).ravel()].reshape(4, 4, 64)
    acc = np.zeros(d.shape[:2] + (4, 4, 4), np.float32)  # [G, b, i, y, x]
    for k in range(64):
        v, u = divmod(k, 8)
        g = union[:, k]
        t = d[g, :, k][:, :, None, None] * base[None, None, :, :, k]
        sign = np.array([1, (-1) ** u, (-1) ** v, (-1) ** (u + v)],
                        np.float32)
        term = t[:, :, None] * sign[None, None, :, None, None]  # exact
        acc[g] = term if k == 0 else acc[g] + term
    s = (acc + np.float32(level)).astype(np.int32)
    out = np.zeros(d.shape[:2] + (8, 8), np.int32)
    rows, cols = q[:, None], q[None, :]
    out[:, :, rows, cols] = s[:, :, 0]
    out[:, :, rows, 7 - cols] = s[:, :, 1]
    out[:, :, 7 - rows, cols] = s[:, :, 2]
    out[:, :, 7 - rows, 7 - cols] = s[:, :, 3]
    return out.reshape(-1, 64)[:len(deq)]


def _cancelling_blocks(n, seed):
    return XT.cancelling_coefficients(n, seed)


def _noise_q100(n, seed):
    """Dequantized coefficients of noise at quality 100 (quantizer 1)."""
    return O.forward_dct(np.random.default_rng(seed).integers(
        -128, 128, (n, 64)))


def _sparse(n, seed, per_block=3):
    rng = np.random.default_rng(seed)
    d = np.zeros((n, 64), np.int64)
    for blk in d:
        k = rng.choice(64, int(rng.integers(1, per_block + 1)), replace=False)
        blk[k] = rng.integers(-1024, 1025, len(k))
    return d


SETS = {
    "ties 128": (lambda: RT.inverse_tie_blocks(4096, 700, 128), 128),
    "ties 2048": (lambda: RT.inverse_tie_blocks(4096, 701, 2048), 2048),
    "cancelling": (lambda: _cancelling_blocks(512, 702), 128),
    "noise q100": (lambda: _noise_q100(512, 703), 128),
    "zero": (lambda: np.zeros((9, 64), np.int64), 128),
    "zero 2048": (lambda: np.zeros((9, 64), np.int64), 2048),
    "sparse": (lambda: _sparse(513, 704), 128),
    "mixed groups 128": (lambda: RT.mixed_coefficient_groups(64, 705), 128),
    "mixed groups 2048": (
        lambda: RT.mixed_coefficient_groups(64, 706, 2048), 2048),
}


@pytest.mark.parametrize("name", list(SETS))
def test_schedule_inverse_rgb_equals_model(name):
    make, level = SETS[name]
    d = np.asarray(make())
    assert np.array_equal(_schedule_inverse_rgb(d, level),
                          BT.inverse_model(d, level))


@settings(max_examples=25, deadline=None, derandomize=True)
@given(st.integers(0, 2**31 - 1), st.sampled_from([0.0, 0.05, 0.3]),
       st.sampled_from([128, 2048]))
def test_schedule_inverse_rgb_mixed_densities(seed, rest, level):
    """4 groups of 8: a dense block beside blocks at another density, in a
    seeded order, with cancelling and tie blocks among them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        dens = [0.9] + [rest] * (TILE - 1)
        rng.shuffle(dens)
        for p in dens:
            out.append(np.where(rng.random(64) < p,
                                rng.integers(-1024, 1025, 64), 0))
    d = np.stack(out) * (level // 128)
    d[4:8] = _cancelling_blocks(4, seed)
    ties = RT.inverse_tie_blocks(1024, seed % 1000, level)
    if len(ties):
        d[8:10] = ties[rng.integers(0, len(ties), 2)]
    assert np.array_equal(_schedule_inverse_rgb(d, level),
                          BT.inverse_model(d, level))


def test_mixed_groups_mix_dense_with_sparse_blocks():
    """rgb_ties.mixed_coefficient_groups in the kernel's groups of 8: even
    groups hold a dense block (the branch-free run), odd ones none (a small
    union, the skipping walk), and most coefficients a group takes are
    zero in another of its blocks (the +-0 terms, on both paths)."""
    nz = _groups(RT.mixed_coefficient_groups(64, 720)) != 0
    dense = nz.sum(axis=2).max(axis=1)
    assert np.all(dense[0::2] >= 60) and np.all(dense[1::2] <= 8)
    union = nz.any(axis=1)
    assert np.all(union[1::2].sum(axis=1) < 32)
    mixed = (union & ~nz.all(axis=1)).sum(axis=1)
    assert np.all(mixed >= union.sum(axis=1) // 2)


@pytest.mark.parametrize("layout", list(XT.upload_layouts(2, 4)))
def test_schedule_planes_equal_rgb_model(layout):
    """The kernel's groups run over a component's blocks of the whole batch
    (a group may straddle two images): the schedule, group by group over
    each component, deblockified, equals idct_planes_rgb_model's planes at
    every sampling of the rgb upload."""
    geom, sizes, gray = XT.upload_layouts(2, 4)[layout]
    rng = np.random.default_rng(len(layout))
    N = 3
    coeff = np.where(rng.random((N, sum(sizes), 64)) < 0.2,
                     rng.integers(-300, 301, (N, sum(sizes), 64)), 0)
    qtuple = tuple(tuple(int(v) for v in rng.integers(1, 9, 64))
                   for _ in sizes)
    want = BT.idct_planes_rgb_model(coeff, geom=geom, level=128, gray=gray,
                                    sizes=sizes, qtuple=qtuple)
    off = 0
    for c, plane in enumerate(want):
        blk = coeff[:, off:off + sizes[c]].reshape(-1, 64)
        off += sizes[c]
        deq = blk * np.asarray(qtuple[c], np.int64)[None]
        spat = _schedule_inverse_rgb(deq, 128).reshape(N, sizes[c], 64)
        assert np.array_equal(BT._deblockify(spat, *geom[c][:4]), plane)


def test_inverse_basis_is_mirror_symmetric():
    """inv64_f32 bit for bit: M[8 y + 7 - x][k] = (-1)^u M[p][k] and
    M[8 (7 - y) + x][k] = (-1)^v M[p][k] on all 4096 entries each, and
    M[p][0] = 0.125 for every p."""
    m = BT._basis("inv64_f32")
    assert m.dtype == np.float32 and m is not None
    assert exact_cuda.mirror_symmetric(m)
    assert np.array_equal(m.view(np.uint32), BASIS.view(np.uint32))
    bits = m.view(np.uint32).reshape(8, 8, 8, 8)          # [y, x, v, u]
    u = np.arange(8)
    neg_u = np.where(u % 2 == 1, np.uint32(1 << 31), np.uint32(0))
    assert np.array_equal(bits[:, ::-1], bits ^ neg_u[None, None, None, :])
    assert np.array_equal(bits[::-1], bits ^ neg_u[None, None, :, None])
    assert np.all(m[:, 0] == np.float32(0.125))


def test_quad_basis_holds_the_quads_rows_in_the_kernels_layout():
    """The table the kernel copies into shared memory: Q[k // 2, j, h,
    k % 2] = M[8 y + x][k] for quad q = j + 8 h = 4 y + x, as the schedule
    model reads the basis; with the mirror symmetry it determines all 4096
    entries."""
    quads = exact_cuda.quad_basis(BASIS)
    assert quads.shape == (32, 8, 2, 2) and quads.dtype == np.float32
    assert quads.flags["C_CONTIGUOUS"]
    for q in range(16):
        p = 8 * (q // 4) + q % 4
        for k in range(64):
            assert quads[k // 2, q % 8, q // 8, k % 2] == BASIS[p, k]


@pytest.mark.parametrize("k, p", [(1, 0), (9, 27), (63, 63), (0, 5)])
def test_mirror_symmetric_refuses_a_perturbed_basis(k, p):
    bad = BASIS.copy()
    bad[p, k] = np.nextafter(bad[p, k], np.float32(1))
    assert not exact_cuda.mirror_symmetric(bad)
    assert not exact_cuda.mirror_symmetric(BASIS.astype(np.float64))
    assert not exact_cuda.mirror_symmetric(BASIS[:, :32])


def test_negated_product_is_the_negated_product():
    """fl(d (-m)) == -fl(d m) bit for bit for every value m of the table
    and every int16 d (and a seeded sample of larger dequantized ones):
    rounding to nearest is symmetric, so a mirrored sample's term is the
    base sample's negated."""
    vals = np.unique(BASIS)
    d = np.concatenate([np.arange(-32768, 32768),
                        np.random.default_rng(7).integers(
                            -(1 << 26), 1 << 26, 4096)]).astype(np.float32)
    for m in vals:
        pos = (d * m).view(np.uint32)
        neg = (d * -m).view(np.uint32)
        assert np.array_equal(neg, pos ^ np.uint32(1 << 31))


def test_tie_set_splits_other_orders_from_the_model():
    """Every tie block truncates some sample differently in another order
    of the same float32 terms, and the set is not empty at either level:
    a kernel that summed in another order would miss on it."""
    for level, seed in ((128, 710), (2048, 711)):
        ties = RT.inverse_tie_blocks(4096, seed, level)
        assert len(ties) >= 10
        ref = BT.inverse_model(ties, level)
        split = np.zeros(len(ties), bool)
        for alt in RT._reordered(ties, level):
            split |= (alt != ref).any(axis=1)
        assert split.all()


def test_idct_planes_rgb_refuses_an_asymmetric_basis_before_building():
    """quad_basis, which makes the kernel's table on the host, refuses a
    basis that is not mirror-symmetric bit for bit; the codec's table is
    made at import and builds nothing, so a call on CPU tensors stops at the
    device check with no library built."""
    coeff = torch.zeros((1, 6, 64), dtype=torch.int16)
    q = torch.ones((3, 64), dtype=torch.int32)
    geom = ((1, 1, 2, 2, 1, 1), (1, 1, 1, 1, 2, 2), (1, 1, 1, 1, 2, 2))
    kw = dict(geom=geom, level=128, gray=False, sizes=(4, 1, 1))
    bad = BASIS.copy()
    bad[10, 3] = np.nextafter(bad[10, 3], np.float32(0))
    for basis in (bad, BASIS.astype(np.float64), BASIS[:32]):
        with pytest.raises(ValueError, match="mirror-symmetric"):
            exact_cuda.quad_basis(basis)
    assert np.array_equal(exact_cuda._INV_QUADS, exact_cuda.quad_basis(BASIS))
    with pytest.raises(ValueError, match="CUDA"):
        exact_cuda.idct_planes_rgb_cuda(coeff, q, **kw)
    assert exact_cuda.LIB.handle is None
