"""ycc420 uploads of chosen coefficient blocks, for the tests of the ycc420
IDCT (block_transform.idct_planes_sparse and its kernel's sparse and
overflow launches) and chip_smoke.py: each image's blocks go through the
host library's jz_sparsify_i8 (runtime/native.sparsify8) as the
transport's host half sends them (codec/host_glue._ycc420_host_frontend),
or all of them become overflow rows; the overflow rows of a component can
be padded with the host's sentinel to any count, and masks can be given
more set bits than the values they carry (junk_masks).  No codec path
calls this module."""
from __future__ import annotations

import numpy as np


def host_cap(rows: int) -> int:
    """The transport's cap of a component with `rows` overflow rows: 0
    without any, else a power of two from 16."""
    return max(16, 1 << (rows - 1).bit_length()) if rows else 0


def sparse_upload(comps, *, K: int = 10, pad=None,
                  all_overflow: bool = False, junk_seed=None):
    """comps: per component its quantized blocks [N, B_c, 64] (values in
    int16) -> (flat uint8 upload, dict(shapes, K, N, caps)), the arguments
    of idct_planes_sparse without geom, level and qtuple.

    Per image and component the mask words and K value bytes of every
    block, then per component with rows its overflow tail: oidx [cap]
    int32 (n B_c + b) and orows [cap, 64] int16.  A block with more than K
    nonzero coefficients or a value outside int8 is an overflow row (its
    mask cleared), or every block is with all_overflow; the rows in block
    order.  pad: None, the transport's cap (host_cap); an int, that many
    rows of the sentinel N B_c after the real ones.  junk_seed: the
    padding rows carry seeded coefficients, and indices below 0, the
    sentinel and past it, in place of the host's zeros and sentinel (rows
    that must add nothing and store nothing either way)."""
    from ..runtime import native

    N = comps[0].shape[0]
    rows, tails, shapes, caps = [], [], [], []
    for blocks in comps:
        blocks = np.asarray(blocks)
        if blocks.ndim != 3 or blocks.shape[0] != N \
                or blocks.shape[2] != 64:
            raise ValueError(f"sparse_upload: blocks of shape "
                             f"{blocks.shape}, want [{N}, B_c, 64]")
        if blocks.size and (blocks.min() < -32768 or blocks.max() > 32767):
            raise ValueError("sparse_upload: a coefficient outside int16")
        Bn = blocks.shape[1]
        dense = blocks.astype(np.int16)
        parts, oidx, orows = [], [], []
        for n in range(N):
            if all_overflow:
                ml = mh = np.zeros(Bn, np.uint32)
                vals = np.zeros((Bn, K), np.int8)
                idx, ovf = np.arange(Bn), dense[n]
            else:
                ml, mh, vals, idx, ovf = native.sparsify8(dense[n], K)
            parts.append(np.concatenate([ml.view(np.uint8), mh.view(np.uint8),
                                         vals.view(np.uint8).reshape(-1)]))
            oidx.append(idx.astype(np.int64) + n * Bn)
            orows.append(ovf.reshape(-1, 64))
        rows.append(np.stack(parts))
        oi = np.concatenate(oidx).astype(np.int32)
        ow = np.concatenate(orows).astype(np.int16)
        cap = host_cap(len(oi)) if pad is None else len(oi) + int(pad)
        if cap:
            extra = cap - len(oi)
            if junk_seed is None:
                fill = np.full(extra, N * Bn, np.int64)
                rows_pad = np.zeros((extra, 64), np.int16)
            else:
                rng = np.random.default_rng(junk_seed + len(caps))
                fill = np.array([-1, N * Bn, N * Bn + 1, -(1 << 31),
                                 (1 << 31) - 1])[np.arange(extra) % 5]
                rows_pad = rng.integers(-500, 500, (extra, 64)).astype(
                    np.int16)
            oi = np.concatenate([oi, fill.astype(np.int32)])
            ow = np.concatenate([ow, rows_pad])
            tails += [oi.view(np.uint8), ow.view(np.uint8).reshape(-1)]
        shapes.append(Bn)
        caps.append(cap)
    flat = np.concatenate([np.concatenate(rows, axis=1).reshape(-1)] + tails)
    return flat, dict(shapes=tuple(shapes), K=K, N=N, caps=tuple(caps))


def overflow_tails(flat, kw) -> list:
    """Per component of an upload its overflow rows [cap, 64] int32 and
    their indices [cap] int64, read from the upload's tail."""
    flat = np.asarray(flat, np.uint8)
    off = kw["N"] * sum((8 + kw["K"]) * bn for bn in kw["shapes"])
    out = []
    for cap in kw["caps"]:
        oidx = np.frombuffer(flat[off:off + 4 * cap].tobytes(), "<i4")
        rows = np.frombuffer(flat[off + 4 * cap:off + 132 * cap].tobytes(),
                             "<i2").reshape(cap, 64)
        out.append((rows.astype(np.int32), oidx.astype(np.int64)))
        off += 132 * cap
    return out


def overflow_rows(flat, kw) -> list:
    """Per component the overflow rows of an upload that name a block
    (index in [0, N B_c)); the rest of each cap is padding."""
    return [int(((oidx >= 0) & (oidx < kw["N"] * bn)).sum())
            for (_, oidx), bn in zip(overflow_tails(flat, kw), kw["shapes"])]


def geometry(mcus_y: int, mcus_x: int, factors) -> tuple:
    """geom of idct_planes_sparse for components with sampling factors
    (v, h) each on a mcus_y x mcus_x MCU grid: (mcus_y, mcus_x, v, h, 1, 1)
    a component."""
    return tuple((mcus_y, mcus_x, v, h, 1, 1) for v, h in factors)


def _ones(ncomp: int) -> tuple:
    return (tuple([1] * 64),) * ncomp


def _random_blocks(rng, n, nblocks, scale, densities=(0.02, 0.2, 0.9)):
    """[n, nblocks, 64] coefficients, each block at one of `densities`."""
    dens = rng.choice(densities, (n, nblocks, 1))
    return np.where(rng.random((n, nblocks, 64)) < dens,
                    rng.integers(-300, 301, (n, nblocks, 64)) * scale, 0)


def overflow_sets(level: int, ties: int = 4096) -> dict:
    """{label: (flat, kwargs of idct_planes_sparse)} at `level` (128, or
    2048 for 12-bit frames): uploads whose overflow rows carry the cases
    that the IDCT's overflow launch must give bit for bit, each as its
    rows' component, tiles and caps make it:

    ties           the float32 tie set (rgb_ties.inverse_tie_blocks of
                   `ties` candidates, about 0.7 % of them kept) at K = 1,
                   so that nearly every block is an overflow row (one
                   component, quantizer 1; zero blocks after them to a
                   multiple of 4, so that the image row is whole words, as
                   block_transform.idct_planes_sparse_plain reads it);
    mixed groups   rgb_ties.mixed_coefficient_groups, every block an
                   overflow row, so the kernel's tiles of 8 rows are the
                   set's groups: dense blocks beside sparse, zero,
                   cancelling and tie ones (the branch-free run), and
                   sparse groups alone (the skipping walk);
    clamp          blocks far below 0 and far above 255, every block an
                   overflow row, 5 sentinel rows (a cap not a multiple of
                   8);
    noise          the dequantized coefficients of noise (quantizer 1),
                   4:2:0 in 3 components, the host's rule at K = 10;
    samplings      3 components at 4x1, 2x3 and 1x1 and one at 3x4,
                   random densities and quant tables, K = 7 (fields at odd
                   byte offsets), caps of real rows plus 3 sentinels;
    junk padding   4:2:0, 11 padding rows that carry coefficients and
                   indices below 0, at the sentinel and past it."""
    from ..codec import oracle
    from . import rgb_ties

    scale = level // 128
    rng = np.random.default_rng(900 + scale)
    out = {}

    def one(blocks):
        blocks = np.asarray(blocks)
        blocks = np.concatenate([blocks, np.zeros((-len(blocks) % 4, 64),
                                                  blocks.dtype)])
        return [blocks[None]], geometry(1, len(blocks), ((1, 1),))

    ties = rgb_ties.inverse_tie_blocks(ties, 700 + scale, level)
    mixed = rgb_ties.mixed_coefficient_groups(16, 705 + scale, level)
    clamp = rng.integers(-300, 301, (64, 64)) * scale
    # a DC of d moves every sample by d / 8
    clamp[:, 0] = np.where(np.arange(64) % 2 == 0,
                           rng.integers(2000, 4000, 64),
                           -rng.integers(2100, 3700, 64) * 8)
    for label, (comps, geom), qt, up in (
            ("ties", one(ties), _ones(1), dict(K=1)),
            ("mixed groups", one(mixed), _ones(1), dict(all_overflow=True)),
            ("clamp", one(clamp), _ones(1), dict(all_overflow=True, pad=5))):
        flat, kw = sparse_upload(comps, **up)
        out[label] = (flat, dict(kw, geom=geom, level=level, qtuple=qt))
    # noise: 2 images of 2 x 4 MCUs at 4:2:0
    samples = rng.integers(-128, 128, (2 * 48, 64)) * scale
    dense = oracle.forward_dct(samples).reshape(2, 48, 64)
    flat, kw = sparse_upload([dense[:, :32], dense[:, 32:40],
                              dense[:, 40:]])
    out["noise"] = (flat, dict(kw, geom=geometry(2, 4, ((2, 2), (1, 1),
                                                        (1, 1))),
                               level=level, qtuple=_ones(3)))
    for label, factors, up in (
            ("samplings, 3 components", ((4, 1), (2, 3), (1, 1)),
             dict(K=7, pad=3)),
            ("samplings, 1 component", ((3, 4),), dict(K=7, pad=3)),
            ("junk padding", ((2, 2), (1, 1), (1, 1)),
             dict(pad=11, junk_seed=910 + scale))):
        comps = [_random_blocks(rng, 2, 2 * 3 * v * h, scale)
                 for v, h in factors]
        qt = tuple(tuple(int(x) for x in rng.integers(1, 9, 64))
                   for _ in factors)
        flat, kw = sparse_upload(comps, **up)
        out[label] = (flat, dict(kw, geom=geometry(2, 3, factors),
                                 level=level, qtuple=qt))
    return out


def junk_masks(flat, kw, seed: int, share: float = 0.3) -> np.ndarray:
    """A copy of the upload flat in which about `share` of the blocks carry
    a seeded mask with K + 1 to 64 set bits and seeded value bytes (the
    transport sends at most K; only the first K set bits take values)."""
    flat = np.array(flat, np.uint8)
    N, K = kw["N"], kw["K"]
    X = sum((8 + K) * bn for bn in kw["shapes"])
    rows = flat[:N * X].reshape(N, X)
    rng = np.random.default_rng(seed)
    off = 0
    for bn in kw["shapes"]:
        pick = rng.random((N, bn)) < share
        n_bits = rng.integers(min(K + 1, 64), 65, (N, bn))
        order = np.argsort(rng.random((N, bn, 64)), axis=2)
        bits = (order < n_bits[..., None]).astype(np.uint64)
        mask = (bits << np.arange(64, dtype=np.uint64)).sum(
            axis=2, dtype=np.uint64)
        lo = np.where(pick, mask & np.uint64(0xFFFFFFFF), 0).astype("<u4")
        hi = np.where(pick, mask >> np.uint64(32), 0).astype("<u4")
        vals = rng.integers(-128, 128, (N, bn, K)).astype(np.int8)
        for field, new in ((rows[:, off:off + 4 * bn], lo),
                           (rows[:, off + 4 * bn:off + 8 * bn], hi)):
            old = field.copy().view("<u4")
            field[:] = np.where(pick, new, old).view(np.uint8)
        v = rows[:, off + 8 * bn:off + (8 + K) * bn].reshape(N, bn, K)
        v[pick] = vals[pick].view(np.uint8)
        off += (8 + K) * bn
    return flat


def sparse_sets(level: int, ties: int = 8192) -> dict:
    """{label: (flat, kwargs of idct_planes_sparse)} at `level` (128 or
    2048): uploads whose sparse rows carry the cases that the IDCT's
    sparse launch must give bit for bit:

    sparse ties    rgb_ties.inverse_tie_blocks of `ties` candidates (their
                   pairs within int8), interleaved with flat, DC-only and
                   cancelling blocks, at K = 10 with the quantizer 8 level
                   / 128 at the DC and 1 elsewhere: every block in the
                   sparse rows (one component), each group of blocks a
                   mix of ties, walks and flat blocks;
    junk masks     4:2:0 on 2 images of 3 x 5 MCUs (a luma unit of one
                   MCU at each row's end, chroma widths of 40), K = 7,
                   random densities (overflow rows too), then
                   junk_masks: masks with more than K set bits;
    K = 1          2 images of 2 x 3 MCUs at 4:2:0: most blocks DC-only
                   or flat, the rest overflow rows;
    K = 13         2 images of 3 x 7 MCUs at 3 x 3, 1 x 1, 1 x 1: an image
                   row of 4,851 bytes, so that units' value bytes start at
                   every byte of a word; plane widths of 168 and 56, luma
                   units of 3 MCUs (one from x = 72, off a 16-byte
                   boundary) and one of 1 MCU at each row's end;
    K = 64, N = 1  one image of 2 x 3 MCUs at 1 x 2, 1 x 1, 1 x 1 whose
                   blocks hold up to 64 int8 values (none overflows)."""
    from . import rgb_ties

    scale = level // 128
    rng = np.random.default_rng(950 + scale)
    out = {}
    tie = rgb_ties.inverse_tie_blocks(ties, 960 + scale, level, ac_limit=127)
    n_t = len(tie)
    dc_only = np.zeros((n_t, 64), np.int64)
    dc_only[:, 0] = rng.integers(-64, 64, n_t) * 8 * scale
    cancel = np.zeros((n_t, 64), np.int64)
    k = rng.integers(1, 8, n_t)
    m = rng.integers(1, 128, n_t)
    cancel[np.arange(n_t), 8 * k] = m
    cancel[np.arange(n_t), k] = -m
    blocks = np.stack([tie, dc_only, np.zeros((n_t, 64), np.int64),
                       cancel], axis=1).reshape(-1, 64)
    qt = np.ones(64, np.int64)
    qt[0] = 8 * scale
    flat, kw = sparse_upload([(blocks // qt)[None]], K=10)
    if any(kw["caps"]):
        raise AssertionError("sparse_sets: a tie block is an overflow row")
    out["sparse ties"] = (flat, dict(
        kw, geom=geometry(1, len(blocks), ((1, 1),)), level=level,
        qtuple=(tuple(int(x) for x in qt),)))
    for label, (my, mx), factors, K, n, dens in (
            ("junk masks", (3, 5), ((2, 2), (1, 1), (1, 1)), 7, 2,
             (0.02, 0.2, 0.9)),
            ("K = 1", (2, 3), ((2, 2), (1, 1), (1, 1)), 1, 2,
             (0.0, 0.016, 0.05)),
            ("K = 13", (3, 7), ((3, 3), (1, 1), (1, 1)), 13, 2,
             (0.02, 0.1, 0.2)),
            ("K = 64, N = 1", (2, 3), ((1, 2), (1, 1), (1, 1)), 64, 1,
             (0.3, 0.7, 1.0))):
        comps = [_random_blocks(rng, n, my * mx * v * h, scale, dens)
                 for v, h in factors]
        if K == 64:
            comps = [np.clip(c, -127, 127) for c in comps]
        qt = tuple(tuple(int(x) for x in rng.integers(1, 9, 64))
                   for _ in factors)
        flat, kw = sparse_upload(comps, K=K)
        if label == "junk masks":
            flat = junk_masks(flat, kw, 970 + scale)
        out[label] = (flat, dict(kw, geom=geometry(my, mx, factors),
                                 level=level, qtuple=qt))
    return out


def scan_blocks(comps, mcus_x: int, ri: int, rng, bad_segments=()):
    """comps: the 4:2:0 components' quantized blocks, Y [N, 4 nmcu, 64] (an
    MCU's TL, TR, BL, BR after one another), Cb and Cr [N, nmcu, 64], in
    MCU-raster order -> (blocks [N nseg, ri 6, 64] int16, bad [N nseg]
    bool, kwargs N, nseg, ri, geom of idct_planes_dense without level), the
    Huffman scan's layout: MCU m of image n at segment n nseg + m // ri,
    slots 6 (m % ri) .. + 5 (4 Y, Cb, Cr).  The slots past the image's
    nmcu MCUs in its last segment hold seeded junk (a kernel that reads
    them shows it); the segments of bad_segments are flagged corrupt."""
    y, cb, cr = (np.asarray(c) for c in comps)
    N, nmcu = cb.shape[:2]
    if y.shape != (N, 4 * nmcu, 64) or cr.shape != cb.shape \
            or nmcu % mcus_x:
        raise ValueError("scan_blocks: want Y [N, 4 nmcu, 64] and Cb, Cr "
                         "[N, nmcu, 64] on whole MCU rows")
    nseg = -(-nmcu // ri)
    out = rng.integers(-500, 500, (N, nseg * ri, 6, 64))
    out[:, :nmcu, :4] = y.reshape(N, nmcu, 4, 64)
    out[:, :nmcu, 4] = cb
    out[:, :nmcu, 5] = cr
    if out.min() < -32768 or out.max() > 32767:
        raise ValueError("scan_blocks: a coefficient outside int16")
    bad = np.zeros(N * nseg, bool)
    bad[list(bad_segments)] = True
    my = nmcu // mcus_x
    geom = ((my, mcus_x, 2, 2, 2, 2), (my, mcus_x, 1, 1, 2, 2),
            (my, mcus_x, 1, 1, 2, 2))
    return (out.astype(np.int16).reshape(N * nseg, ri * 6, 64), bad,
            dict(N=N, nseg=nseg, ri=ri, geom=geom))


def dense_sets(level: int, ties: int = 4096) -> dict:
    """{label: (blocks, bad, qarr, kwargs of idct_planes_dense)} at `level`
    (128 or 2048): the scan's blocks (scan_blocks: junk in the slots past
    each image's MCUs, a corrupt segment in the second image) of 2 images
    (3 for the last set) that carry the cases the IDCT's dense launch must
    give bit for bit, with a quant table of its own for each image:

    ties           the float32 tie set (rgb_ties.inverse_tie_blocks) in
                   every component, the first image at quantizer 1, the
                   second at 8 level / 128 for the DC (the ties' DCs are
                   its multiples) and 1 elsewhere, the second's Cr blocks
                   zero (walks of no coefficient); 2 x 6 MCUs, ri = 5;
    mixed groups   rgb_ties.mixed_coefficient_groups (groups of 8 blocks,
                   dense ones beside sparse, zero, cancelling and tie
                   blocks, then sparse ones alone) at quantizer 1, so
                   that a walk of 16 blocks (4 luma MCUs, 16 chroma ones)
                   is a dense group and a sparse one in Y, two sparse
                   groups in Cb (the skipping walk) and two dense ones in
                   Cr, the roles turned in the second image; 2 x 8 MCUs,
                   ri = 3;
    clamp          blocks far below 0 and far above 255 (every other DC),
                   random tables 1..8; 2 x 4 MCUs, ri = 3;
    noise          the forward DCT of noise (every coefficient nonzero),
                   quantizer 1 and random tables 1..3; 2 x 4 MCUs, ri = 3;
    random, padded 3 images of 3 x 5 MCUs (luma units of 4 MCUs and of 1
                   at each row's end) at densities 0.02, 0.2 and 0.9 a
                   block, random tables 1..8, ri = 4."""
    from ..codec import oracle
    from . import rgb_ties

    scale = level // 128
    rng = np.random.default_rng(980 + scale)
    out = {}

    def tables(n, top):
        q = rng.integers(1, top + 1, (n, 3, 64)) if top > 1 \
            else np.ones((n, 3, 64), np.int64)
        return q.astype(np.int32)

    def split(blocks, N, nmcu):
        b = np.asarray(blocks).reshape(N, 6 * nmcu, 64)
        return b[:, :4 * nmcu], b[:, 4 * nmcu:5 * nmcu], b[:, 5 * nmcu:]

    tie = rgb_ties.inverse_tie_blocks(ties, 990 + scale, level)
    nmcu = 12
    y, cb, cr = split(np.resize(tie, (2 * 6 * nmcu, 64)), 2, nmcu)
    q = np.ones((2, 3, 64), np.int32)
    q[1, :, 0] = 8 * scale
    y, cb, cr = (c.copy() for c in (y, cb, cr))
    for c in (y, cb, cr):
        c[1, :, 0] //= 8 * scale
    cr[1] = 0
    out["ties"] = (y, cb, cr), 6, 5, q
    mixed = rgb_ties.mixed_coefficient_groups(8, 995 + scale, level)
    dense, sparse = (mixed.reshape(-1, 2, 8, 64)[:, i].reshape(-1, 64)
                     for i in (0, 1))
    nmcu = 16
    y0 = mixed                                        # dense, sparse, ...
    y1 = np.concatenate([sparse, dense])              # sparse, then dense
    out["mixed groups"] = ((np.stack([y0, y1]), np.stack([sparse[:16],
                                                          dense[:16]]),
                            np.stack([dense[:16], sparse[16:]])), 8, 3,
                           tables(2, 1))
    nmcu = 8
    clamp = rng.integers(-300, 301, (2 * 6 * nmcu, 64)) * scale
    clamp[:, 0] = np.where(np.arange(len(clamp)) % 2 == 0,
                           rng.integers(2000, 4000, len(clamp)),
                           -rng.integers(2100, 3700, len(clamp)) * 8)
    out["clamp"] = split(clamp, 2, nmcu), 4, 3, tables(2, 8)
    samples = rng.integers(-128, 128, (2 * 6 * nmcu, 64)) * scale
    noise = oracle.forward_dct(samples)
    q = tables(2, 3)
    q[0] = 1
    out["noise"] = split(noise, 2, nmcu), 4, 3, q
    nmcu = 15
    comps = [_random_blocks(rng, 3, k * nmcu, scale) for k in (4, 1, 1)]
    out["random, padded"] = tuple(comps), 5, 4, tables(3, 8)
    sets = {}
    for label, (comps, mcus_x, ri, q) in out.items():
        N = len(q)
        nseg = -(-comps[1].shape[1] // ri)
        blocks, bad, kw = scan_blocks(comps, mcus_x, ri, rng,
                                      bad_segments=(nseg + 1,))
        sets[label] = (blocks, bad, q, dict(kw, level=level))
    return sets
