"""Tie sets of exact mode, for its tests and chip_smoke.py: blocks whose
float64 sums fall so near an integer that another summation order truncates
them differently, and the planes and upload layouts that carry them through
the block transforms (ops/block_transform.fdct_quantize_exact,
idct_planes_exact).  No codec path calls this module."""
from __future__ import annotations

import numpy as np

from ..codec import oracle as O
from ..ops import dct as D
from ..ops.block_transform import _deblockify


def _reordered_forward(blk: np.ndarray) -> list:
    """Two other orders of the forward sums: the oracle's 64 terms in
    descending k, and the product with the folded basis (dct._FWD64)."""
    pic = blk.astype(np.float64)
    s = np.zeros(pic.shape)
    for k in reversed(range(64)):
        s += (pic[:, k:k + 1] * O._FWD_C1[k][None]) * O._FWD_C2[k][None]
    s = s.reshape(-1, 8, 8)
    rev = ((s * O._CU_J[None, None, :]) * O._CU_J[None, :, None]) / 4.0
    return [rev.reshape(-1, 64).astype(np.int32),
            (pic @ D._FWD64.T).astype(np.int32)]


def _reordered_inverse(coef: np.ndarray, level: int) -> list:
    """Two other orders of the inverse sums: descending k, and the product
    with the folded basis (dct._INV64)."""
    d = coef.astype(np.float64)
    s = np.zeros(d.shape)
    for k in reversed(range(64)):
        s += ((O._INV_CUCV[k] * d[:, k:k + 1]) * O._INV_C1[k][None]) \
            * O._INV_C2[k][None]
    return [(s / 4.0 + level).astype(np.int32),
            (d @ D._INV64.T + level).astype(np.int32)]


def forward_tie_blocks(n: int, seed: int) -> np.ndarray:
    """Sample blocks [B, 64] int32 in [-128, 127] on which the oracle's
    forward DCT (codec/oracle.forward_dct) and another summation order
    truncate some coefficient differently: of n seeded modular ramps
    (a x + c y + d) mod 256 - 128, the ones where the descending-k sum or
    the folded-basis product disagrees with the oracle, then n // 16 flat
    blocks, where the DC's normalisation cu cu / 4 is rounded three times.
    A kernel that reorders, contracts or refolds the sums misses on them
    (jitted JAX does, fault K of ROADMAP.md)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:8, 0:8]
    a, c, d = (rng.integers(lo, hi, (n, 1, 1)) for lo, hi in
               ((-40, 41), (-40, 41), (0, 256)))
    ramps = ((a * x + c * y + d) % 256 - 128).reshape(n, 64).astype(np.int32)
    ref = O.forward_dct(ramps)
    tie = np.zeros(n, bool)
    for alt in _reordered_forward(ramps):
        tie |= (alt != ref).any(axis=1)
    flat = np.repeat(rng.integers(-128, 128, (n // 16, 1)), 64, axis=1)
    return np.concatenate([ramps[tie], flat.astype(np.int32)])


def inverse_tie_blocks(n: int, seed: int, level: int = 128) -> np.ndarray:
    """Dequantized coefficient blocks [B, 64] int32 on which the oracle's
    inverse DCT (codec/oracle.inverse_dct) and another summation order
    truncate some sample differently: of n seeded blocks with a DC that is
    a multiple of 8 and one to three pairs of coefficients at (u, v) and
    (v, u), equal or opposite (their terms cancel, in exact arithmetic, on
    or about the diagonal, so the samples land next to integers), the ones
    where the descending-k sum or the folded-basis product disagrees.  With
    level 2048 (12-bit samples) the values are 16 times larger."""
    rng = np.random.default_rng(seed)
    scale = level // 128
    coef = np.zeros((n, 64), np.int32)
    coef[:, 0] = rng.integers(-64, 64, n) * 8 * scale
    for i in range(n):
        for _ in range(int(rng.integers(1, 4))):
            u, v = rng.choice(8, 2, replace=False)
            m = int(rng.integers(1, 100 * scale)) * int(rng.choice([-1, 1]))
            coef[i, v * 8 + u] = m
            coef[i, u * 8 + v] = -m if i % 2 == 0 else m
    ref = O.inverse_dct(coef, level)
    tie = np.zeros(n, bool)
    for alt in _reordered_inverse(coef, level):
        tie |= (alt != ref).any(axis=1)
    return coef[tie]


def tie_planes(blocks: np.ndarray):
    """Sample blocks [B, 64] laid out as one image's planes (y, cb, cr)
    [1, 16, 16 mx] and [1, 8, 8 mx], mx = B // 4 MCUs: luma 2 x 2 blocks
    an MCU, and the first mx blocks again as each chroma plane, so that
    fdct_quantize's blocks come out in the given order."""
    mx = len(blocks) // 4
    y = _deblockify(blocks[None, :4 * mx], 1, mx, 2, 2)
    c = _deblockify(blocks[None, :mx], 1, mx, 1, 1)
    return y, c, c


def upload_layouts(mcus_y: int, mcus_x: int) -> dict:
    """{label: (geom, sizes, gray)}: ways to read the rgb transport's upload
    of a 4:2:0 frame of mcus_y x mcus_x MCUs (6 blocks an MCU; mcus_x even)
    as idct_planes_exact's input at other sampling factors with the same
    blocks an image: 4:2:0 itself, 4:2:2 and 4:4:4 on wider MCU grids, one
    component, and gray (component 0 of the 4:2:0 frame).  geom holds
    (mcus_y, mcus_x, v, h, 1, 1) a component."""
    def layout(mx, vh, gray=False):
        geom = tuple((mcus_y, mx, v, h, 1, 1) for v, h in vh)
        return geom, tuple(mcus_y * mx * v * h for v, h in vh), gray

    std = ((2, 2), (1, 1), (1, 1))
    return {"4:2:0": layout(mcus_x, std),
            "4:2:2": layout(3 * mcus_x // 2, ((1, 2), (1, 1), (1, 1))),
            "4:4:4": layout(2 * mcus_x, ((1, 1),) * 3),
            "1 component": layout(6 * mcus_x, ((1, 1),)),
            "gray": layout(mcus_x, std, True)}


def cancelling_coefficients(n: int, seed: int) -> np.ndarray:
    """Dequantized coefficient blocks [n, 64] int64: d[2] = a, d[16] = -a,
    whose terms are exact negatives on the diagonal samples, so the
    inverse's partial sum is exactly 0 there after k = 16; two more
    coefficients after it, zeros between."""
    rng = np.random.default_rng(seed)
    d = np.zeros((n, 64), np.int64)
    a = rng.integers(1, 500, n) * rng.choice([-1, 1], n)
    d[:, 2], d[:, 16] = a, -a
    later = rng.integers(17, 64, (n, 2))
    d[np.arange(n)[:, None], later] = rng.integers(-300, 301, (n, 2))
    return d


def cancelling_samples(n: int, seed: int) -> np.ndarray:
    """Sample blocks [n, 64] int32: p[y1][x] = a and p[y2][x] = -a (y1 < y2),
    whose terms in coefficient row i = 0 (COS[0][y] = 1) are exact
    negatives, so the forward's partial sums of that row are exactly 0
    after sample 8 y2 + x; two more samples after it, zeros between."""
    rng = np.random.default_rng(seed)
    p = np.zeros((n, 64), np.int32)
    idx = np.arange(n)
    x = rng.integers(0, 8, n)
    y1 = rng.integers(0, 4, n)
    y2 = rng.integers(4, 7, n)
    a = rng.integers(1, 128, n) * rng.choice([-1, 1], n)
    p[idx, 8 * y1 + x], p[idx, 8 * y2 + x] = a, -a
    later = 8 * y2 + x + 1 + rng.integers(0, 63 - (8 * y2 + x), (2, n))
    p[idx[None, :].repeat(2, 0), later] = rng.integers(-128, 128, (2, n))
    return p


def _in_groups(kinds: list, groups: int, rng) -> np.ndarray:
    """groups x 4 blocks in a seeded order.  Even groups: one of kinds[0]
    (the dense kind), one of kinds[1:4] (sparse, zero or cancelling) and
    two drawn from all kinds.  Odd groups: four drawn from kinds[1:4], so
    that their union of nonzero entries stays small (a kernel warp takes
    such a group on its skipping path, a dense one on its straight one)."""
    out = []
    for g in range(groups):
        if g % 2 == 0:
            pick = [0, int(rng.integers(1, 4))] + list(
                rng.integers(0, len(kinds), 2))
        else:
            pick = list(rng.integers(1, 4, 4))
        rng.shuffle(pick)
        out += [kinds[i][rng.integers(0, len(kinds[i]))] for i in pick]
    return np.stack(out)


def mixed_sample_groups(groups: int, seed: int) -> np.ndarray:
    """Sample blocks [4 groups, 64] int32 in [-128, 127], in the groups of 4
    that fdct_quantize_exact's warps take together (with tie_planes: the
    luma blocks of one MCU): every other group a dense noise block beside
    sparse blocks (1 to 4 nonzero samples), all-zero blocks, blocks whose
    sums cancel to 0 on the way and tie blocks, the others sparse, zero
    and cancelling blocks alone (see _in_groups), so that most samples a
    group takes are zero in some of its blocks and nonzero in others."""
    rng = np.random.default_rng(seed)
    n = 64
    dense = rng.integers(-128, 128, (n, 64)).astype(np.int32)
    sparse = np.zeros((n, 64), np.int32)
    for blk in sparse:
        k = rng.choice(64, int(rng.integers(1, 5)), replace=False)
        blk[k] = rng.integers(-128, 128, len(k))
    return _in_groups([dense, sparse, np.zeros((1, 64), np.int32),
                       cancelling_samples(n, seed + 1),
                       forward_tie_blocks(256, seed + 2)], groups, rng)


def mixed_coefficient_groups(groups: int, seed: int, level: int = 128,
                             ties=inverse_tie_blocks) -> np.ndarray:
    """Dequantized coefficient blocks [4 groups, 64] int32, in the groups of
    4 that idct_planes_exact's warps take together (4 consecutive blocks
    of a component): every other group a dense block (every coefficient
    nonzero) beside sparse blocks (1 to 3 nonzero), all-zero blocks,
    blocks whose partial sums cancel to 0 and tie blocks at `level`
    (ties(n, seed, level): this module's, or the fast IDCT's of
    testing/rgb_ties), the others sparse, zero and cancelling blocks alone
    (see _in_groups)."""
    rng = np.random.default_rng(seed)
    n = 64
    scale = level // 128
    dense = (rng.integers(1, 1025, (n, 64)) * rng.choice([-1, 1], (n, 64))
             * scale).astype(np.int32)
    sparse = np.zeros((n, 64), np.int32)
    for blk in sparse:
        k = rng.choice(64, int(rng.integers(1, 4)), replace=False)
        blk[k] = rng.integers(-1024, 1025, len(k)) * scale
    return _in_groups([dense, sparse, np.zeros((1, 64), np.int32),
                       cancelling_coefficients(n, seed + 1).astype(np.int32),
                       ties(512, seed + 2, level)], groups, rng)
