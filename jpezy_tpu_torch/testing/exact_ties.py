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
