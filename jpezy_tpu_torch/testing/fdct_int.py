"""The fDCT kernel's integer form (ops/transform_cuda.fdct_quantize_cuda),
for its tests and chip_smoke.py: the extreme sample blocks that push each
digit's sum and each coefficient to its largest magnitude, planes made of
them, and a numpy model of one warp tile's int8 tensor-core products,
register by register as the PTX ISA lays out mma.m16n8k32's s8 fragments.
No codec path calls this module."""
from __future__ import annotations

import numpy as np

from ..constants import FDCT_DIGITS, FDCT_INT
from ..ops import block_transform as BT
from ..ops import transform_cuda as TC

_LO, _HI = -128, 127


def extreme_blocks(seed: int = 19) -> np.ndarray:
    """[B, 64] int32 level-shifted blocks within [-128, 127]: flat at both
    ends, the two checkerboards of -128 and 127, for each digit d, each
    coefficient k and each sign the block whose sum with digit d at k is
    the largest (127 where the digit is positive, -128 where negative) or
    the least, the same for W_int itself (each coefficient's largest and
    least), and 64 seeded blocks of -128 and 127 alone."""
    yy, xx = np.mgrid[0:8, 0:8]
    board = np.where((yy + xx) % 2 == 0, _HI, _LO).reshape(64)
    out = [np.full(64, _LO), np.full(64, _HI), board, _LO + _HI - board]
    for w in list(FDCT_DIGITS.astype(np.int64)) + [FDCT_INT]:
        for k in range(64):
            for sign in (1, -1):
                out.append(np.where(sign * w[:, k] > 0, _HI, _LO))
    rng = np.random.default_rng(seed)
    out += list(rng.choice([_LO, _HI], (64, 64)))
    return np.stack(out).astype(np.int32)


def planes_of(blocks: np.ndarray, mcus_y: int = 4, mcus_x: int = 8):
    """(y, cb, cr) int8 4:2:0 planes [N, 16 mcus_y, 16 mcus_x] (chroma
    half) whose luma blocks are `blocks` in order and whose chroma blocks
    are `blocks` from a third and from two thirds on, each repeated to fill
    the N images that the luma needs."""
    nm = mcus_y * mcus_x
    n = -(-blocks.shape[0] // (4 * nm))
    planes = []
    for c, (per, v) in enumerate(((4, 2), (1, 1), (1, 1))):
        start = c * blocks.shape[0] // 3
        idx = (start + np.arange(n * per * nm)) % blocks.shape[0]
        b = blocks[idx].reshape(n, per * nm, 64)
        planes.append(BT._deblockify(b, mcus_y, mcus_x, v, v)
                      .astype(np.int8))
    return tuple(planes)


def a_registers(tile: np.ndarray) -> np.ndarray:
    """A warp tile's 16 blocks [16, 64] of samples -> the lanes' A
    fragments as loaded, [2 k-steps, 32 lanes, 4 registers] uint32: lane
    4 g + t loads rows 2 t and 2 t + 1 of blocks g and g + 8, 8 bytes each;
    k-step j takes row 2 t + j, register 2 h of block g and 2 h + 1 of
    block g + 8 its half h (low byte: the leftmost sample)."""
    b = (np.asarray(tile).astype(np.int64) & 0xFF).reshape(16, 8, 2, 4)
    words = (b << (8 * np.arange(4))).sum(axis=3)          # [blk, row, h]
    out = np.zeros((2, 32, 4), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j in range(2):
            for h in range(2):
                out[j, lane, 2 * h] = words[g, 2 * t + j, h]
                out[j, lane, 2 * h + 1] = words[g + 8, 2 * t + j, h]
    return out.astype(np.uint32)


def _bytes(words: np.ndarray) -> np.ndarray:
    """uint32 [...] -> their 4 signed bytes [..., 4], the low byte first."""
    w = np.asarray(words).astype(np.int64)
    b = (w[..., None] >> (8 * np.arange(4))) & 0xFF
    return np.where(b >= 128, b - 256, b)


def mma_m16n8k32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 on the lanes'
    registers: a [32, 4], b [32, 2] uint32 of 4 s8 each, c [32, 4] int64 ->
    d [32, 4].  With g = lane / 4, t = lane % 4: A's register i byte e is
    row g + 8 (i & 1), column 4 t + e + 16 (i >> 1); B's register r byte e
    is row 4 t + e + 16 r, column g; C and D's register i are row g + 8
    (i >> 1), column 2 t + (i & 1)."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    ab, bb = _bytes(a), _bytes(b)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            A[g + 8 * (i & 1), 4 * t + 16 * (i >> 1) + np.arange(4)] = ab[
                lane, i]
        for r in range(2):
            B[4 * t + 16 * r + np.arange(4), g] = bb[lane, r]
    D = A @ B
    d = np.array(c, np.int64, copy=True)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            d[lane, i] += D[g + 8 * (i >> 1), 2 * t + (i & 1)]
    return d


def warp_digit_sums(tile: np.ndarray) -> np.ndarray:
    """One warp tile's products as the kernel makes them: for each digit d
    and n-tile u, two MMAs (k-steps 0 and 1) of the lanes' A registers with
    transform_cuda.fragment_table's B words, the accumulators placed by
    D's layout (register i of lane 4 g + t: block g + 8 (i >> 1),
    coefficient 8 u + 2 t + (i & 1)) -> [3, 16, 64] int64, which must equal
    block_transform.digit_sums of the tile's blocks."""
    a = a_registers(tile)
    table = TC.fragment_table().view(np.uint32)
    out = np.zeros((3, 16, 64), np.int64)
    for d in range(3):
        for u in range(8):
            acc = np.zeros((32, 4), np.int64)
            for j in range(2):
                acc = mma_m16n8k32(a[j], table[d, u, :, 2 * j:2 * j + 2],
                                   acc)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for i in range(4):
                    out[d, g + 8 * (i >> 1), 8 * u + 2 * t + (i & 1)] = acc[
                        lane, i]
    return out
