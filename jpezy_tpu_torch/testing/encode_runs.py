"""A model of the fused entropy kernel's schedule and arithmetic
(csrc/entropy_pack.cu, jz_encode_blocks_batch), for the CPU tests and
chip_smoke.py: which thread block codes which blocks, which table sets it
stages, where each block's DC predictor comes from, and the lane's
sequential bit writer.  No codec path calls this module; the kernel is
held to encode_blocks_batch_plain on the card, and this model to the same
plain form (and the JAX package) on the CPU.

The kernel cuts each component's N * B_c blocks (image-major) into runs of
RUN_BLOCKS consecutive blocks; with a table set an image and images of
fewer blocks, a run is one image's blocks, so that a run meets at most two
images.  A thread block (one warp) takes one run, Y's runs first, then
Cb's, then Cr's, a lane a block.  It stages the component's fixed table
row, or one set, or the sets of the one or two images its run touches.  A
lane's DC predictor is 0 at a restart segment's start ("zero"), the carry
or 0 at its image's first block ("carry", "zero"), else the previous
block's DC: the neighbouring lane's ("lane"), or for the run's first block
one 4-byte load ("load").  The lane walks its coefficients in zigzag order
and appends each emission to a 64-bit accumulator whose top 32 bits leave
as a word whenever it holds 32 (words past the 64th dropped)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core import tables as T

RUN_BLOCKS = 32   # kRunBlocks: a lane a block
RUN_SETS = 2      # kRunSets: the table sets a run may meet
WORDS = 64
M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1


class Run(NamedTuple):
    """One thread block: its component (0 Y, 1 Cb, 2 Cr), first block and
    block count (in the component's image-major blocks), the images whose
    table sets it stages (() for the fixed tables or the one set), and per
    block its predictor source and its staged set (0 or 1)."""
    comp: int
    b0: int
    count: int
    staged: tuple
    sources: tuple
    slots: tuple


def run_length(per_image: int, nsets: int) -> int:
    """Blocks a run of a component with per_image blocks an image."""
    return per_image if nsets > 1 and per_image < RUN_BLOCKS else RUN_BLOCKS


def schedule(nimages: int, luma_blocks: int, chroma_blocks: int,
             restart_interval: int = 0, nsets: int = 1,
             carry: bool = False) -> list:
    """The kernel's thread blocks, in launch order (Run each)."""
    runs = []
    for comp, per_image, seg in ((0, luma_blocks, 4 * restart_interval),
                                 (1, chroma_blocks, restart_interval),
                                 (2, chroma_blocks, restart_interval)):
        length = run_length(per_image, nsets)
        total = nimages * per_image
        for b0 in range(0, total, length):
            count = min(length, total - b0)
            n0 = b0 // per_image
            two = nsets > 1 and (b0 + count - 1) // per_image != n0
            sources, slots = [], []
            for lane in range(count):
                n, at = divmod(b0 + lane, per_image)
                if seg > 0 and at % seg == 0:
                    sources.append("zero")
                elif at == 0:
                    sources.append("carry" if carry else "zero")
                else:
                    sources.append("load" if lane == 0 else "lane")
                slots.append(int(two and n != n0))
            staged = ((n0, n0 + 1) if two else (n0,)) if nsets > 1 else ()
            runs.append(Run(comp, b0, count, staged, tuple(sources),
                            tuple(slots)))
    return runs


def _category(v: int) -> int:
    return abs(v).bit_length()


def _extra(v: int, s: int) -> int:
    return (v - 1 if v < 0 else v) & ((1 << s) - 1)


def lane_words(block: np.ndarray, pred: int, tables) -> tuple:
    """One lane's block (64 coefficients, natural order), its DC predictor
    and its table set (dc_size, dc_code, ac_size, ac_code; 1-D, the JAX
    order) -> (words [64] int64 in [0, 2**32), bits): the kernel's walk
    and bit writer."""
    dc_size, dc_code, ac_size, ac_code = (np.asarray(t).astype(np.int64)
                                          for t in tables)
    row = [0] * (WORDS + 1)   # the last entry: the row's padding
    acc, held, words = 0, 0, 0

    def put(v: int, n: int):
        nonlocal acc, held, words
        acc = ((acc << n) | v) & M64
        held += n
        if held >= 32:
            held &= 31
            row[min(words, WORDS)] = (acc >> held) & M32
            words += 1

    diff = int(block[0]) - pred
    s = min(_category(diff), len(dc_size) - 1)
    put((int(dc_code[s]) << s) | _extra(diff, s), int(dc_size[s]) + s)
    last = 0
    for j in range(1, 64):
        v = int(block[T.ZIGZAG[j]])
        if v:
            run = j - last - 1
            while run >= 16:
                put(int(ac_code[T.ZRL_INDEX]), int(ac_size[T.ZRL_INDEX]))
                run -= 16
            s = _category(v)
            e = min(run * 10 + s + (run == 15), len(ac_size) - 1)
            put((int(ac_code[e]) << s) | _extra(v, s), int(ac_size[e]) + s)
            last = j
    if last != 63:
        put(int(ac_code[T.EOB_INDEX]), int(ac_size[T.EOB_INDEX]))
    if held > 0:
        row[min(words, WORDS)] = (acc << (32 - held)) & M32
    return np.array(row[:WORDS], np.int64), 32 * words + held


def _sets(tables, chroma: bool, nimages: int):
    """A component's table sets: [one] or one an image, each (dc_size,
    dc_code, ac_size, ac_code) 1-D; None for the fixed Annex K tables."""
    if tables is None:
        return [(T.C_DC_SIZE, T.C_DC_CODE, T.C_AC_SIZE, T.C_AC_CODE)
                if chroma else
                (T.Y_DC_SIZE, T.Y_DC_CODE, T.Y_AC_SIZE, T.Y_AC_CODE)]
    arrays = [np.asarray(t) for t in tables]
    if arrays[0].ndim == 1:
        return [tuple(arrays)]
    return [tuple(a[i] for a in arrays) for i in range(nimages)]


def encode(yq, cbq, crq, restart_interval: int = 0, carry=None,
           tables=(None, None)):
    """encode_blocks_batch_plain's (words, bits) as the kernel's schedule
    makes them: each run's blocks lane by lane, each lane's predictor from
    its source and its table set from its staged slot.  yq [N, B_Y, 64],
    cbq and crq [N, B_C, 64] (numpy or torch), carry [N, 3] or None,
    tables as in encode_blocks_batch_plain.  Returns ((words_Y, words_Cb,
    words_Cr) int64 [N, B_c, 64], (bits_Y, bits_Cb, bits_Cr) int32 [N,
    B_c]) as numpy arrays."""
    comps = [np.asarray(c).astype(np.int64) for c in (yq, cbq, crq)]
    N = comps[0].shape[0]
    carry = None if carry is None else np.asarray(carry).astype(np.int64)
    sets = [_sets(tables[0], False, N), _sets(tables[1], True, N),
            _sets(tables[1], True, N)]
    nsets = len(sets[0])
    words = [np.zeros((N, c.shape[1], WORDS), np.int64) for c in comps]
    bits = [np.zeros((N, c.shape[1]), np.int32) for c in comps]
    for u in schedule(N, comps[0].shape[1], comps[1].shape[1],
                      restart_interval, nsets, carry is not None):
        q = comps[u.comp]
        per_image = q.shape[1]
        flat = q.reshape(-1, 64)
        for lane in range(u.count):
            b = u.b0 + lane
            n, at = divmod(b, per_image)
            src = u.sources[lane]
            pred = (0 if src == "zero" else
                    int(carry[n, u.comp]) if src == "carry" else
                    int(flat[b - 1, 0]))
            if nsets > 1:
                image = u.staged[u.slots[lane]]
                if image != n:
                    raise AssertionError(f"run {u}: block {b} of image {n} "
                                         f"takes image {image}'s set")
                tabs = sets[u.comp][image]
            else:
                tabs = sets[u.comp][0]
            w, nb = lane_words(flat[b], pred, tabs)
            words[u.comp][n, at] = w
            bits[u.comp][n, at] = nb
    return tuple(words), tuple(bits)


def longest_tables(seed: int = 23):
    """A table set (JAX order) whose every code has 16 bits: no prefix
    code, but the encode takes any set, and under it a block of 63
    category-12 coefficients codes into 63 x 28 + 27 = 1,791 bits
    (longest_blocks): the longest block on which the kernel's magnitude
    category (a bit length) and the plain form's ladder (capped at 12)
    agree, words 0 to 55; no block the two code alike reaches word 63."""
    rng = np.random.default_rng(seed)
    return (np.full(12, 16, np.int32), rng.integers(0, 1 << 16, 12),
            np.full(162, 16, np.int32), rng.integers(0, 1 << 16, 162))


def longest_blocks(n: int, seed: int = 17) -> np.ndarray:
    """[n, 64] int32 blocks for longest_tables: every AC coefficient of
    category 12 (2048 <= |v| < 4096), DCs within +-1023."""
    rng = np.random.default_rng(seed)
    q = rng.integers(2048, 4096, (n, 64)) * rng.choice([-1, 1], (n, 64))
    q[:, 0] = rng.integers(-1023, 1024, n)
    return q.astype(np.int32)

