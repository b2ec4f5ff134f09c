"""The float32 tie set of the fast rgb IDCT (ops/exact_cuda.
idct_planes_rgb_cuda), for its tests and chip_smoke.py: dequantized blocks
on which block_transform.inverse_model, the ascending float32 sum that the
kernel makes, truncates some sample differently from the same 64 float32
terms summed in another order, and the kernel's mixed warp groups that
carry them.  No codec path calls this module."""
from __future__ import annotations

import numpy as np

from ..ops import block_transform as BT
from . import exact_ties as XT


def _reordered(coef: np.ndarray, level: int) -> list:
    """The samples of three other orders of the same float32 terms
    fl(d[k] M[p][k]): descending k, a pairwise tree over k, and the float64
    sum rounded to float32; each + level in float32, truncated."""
    terms = (coef.astype(np.float32)[:, None, :]
             * BT._basis("inv64_f32")[None])               # [B, p, k]
    rev = np.zeros(terms.shape[:2], np.float32)
    for k in reversed(range(64)):
        rev += terms[:, :, k]
    tree = terms
    while tree.shape[2] > 1:
        tree = tree[:, :, 0::2] + tree[:, :, 1::2]
    wide = terms.astype(np.float64).sum(axis=2).astype(np.float32)
    return [(s + np.float32(level)).astype(np.int32)
            for s in (rev, tree[:, :, 0], wide)]


def inverse_tie_blocks(n: int, seed: int, level: int = 128,
                       ac_limit: int | None = None) -> np.ndarray:
    """Dequantized coefficient blocks [B, 64] int32 on which inverse_model
    and another order of its float32 terms (_reordered) truncate some
    sample differently: of n seeded blocks with a DC that is a multiple of
    8 and one to three pairs of coefficients at (u, v) and (v, u), equal or
    opposite (exact_ties.inverse_tie_blocks' candidates: samples next to
    integers), the ones where an order disagrees; about 0.7 % of them.  A
    kernel that reorders or contracts the sums misses on them.  ac_limit:
    the pairs' coefficients within [-ac_limit, ac_limit] (127: int8 with
    quantizer 1, so that the blocks can travel in the ycc420 upload's
    sparse rows, their DC as an int8 times 8 level / 128)."""
    rng = np.random.default_rng(seed)
    scale = level // 128
    top = 100 * scale if ac_limit is None else min(100 * scale, ac_limit + 1)
    coef = np.zeros((n, 64), np.int32)
    coef[:, 0] = rng.integers(-64, 64, n) * 8 * scale
    for i in range(n):
        for _ in range(int(rng.integers(1, 4))):
            u, v = rng.choice(8, 2, replace=False)
            m = int(rng.integers(1, top)) * int(rng.choice([-1, 1]))
            coef[i, v * 8 + u] = m
            coef[i, u * 8 + v] = -m if i % 2 == 0 else m
    tie = np.zeros(n, bool)
    for i in range(0, n, 1024):      # [1024, 64, 64] terms at a time
        part = coef[i:i + 1024]
        ref = BT.inverse_model(part, level)
        for alt in _reordered(part, level):
            tie[i:i + 1024] |= (alt != ref).any(axis=1)
    return coef[tie]


def _group_ties(n: int, seed: int, level: int) -> np.ndarray:
    # ties are rarer in float32: search 8 times the candidates
    return inverse_tie_blocks(8 * n, seed, level)


def mixed_coefficient_groups(groups: int, seed: int,
                             level: int = 128) -> np.ndarray:
    """Dequantized coefficient blocks [8 groups, 64] int32 in the groups of
    8 that idct_planes_rgb's warps take together (8 consecutive blocks of a
    component; groups even): every other group holds dense blocks (every
    coefficient nonzero) beside sparse, zero, cancelling and float32 tie
    blocks (the kernel's branch-free run), the others sparse, zero and
    cancelling blocks alone (its skipping walk): exact_ties'
    mixed_coefficient_groups with this module's ties, its groups of 4
    paired."""
    four = XT.mixed_coefficient_groups(2 * groups, seed, level,
                                       ties=_group_ties).reshape(-1, 4, 64)
    dense, sparse = (x.reshape(-1, 8, 64) for x in (four[0::2], four[1::2]))
    return np.stack([dense, sparse], axis=1).reshape(-1, 64)
