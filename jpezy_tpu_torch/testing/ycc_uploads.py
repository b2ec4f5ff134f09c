"""ycc420 uploads of chosen coefficient blocks, for the tests of the ycc420
IDCT (block_transform.idct_planes_sparse and its kernel's sparse and
overflow launches) and chip_smoke.py: each image's blocks go through the
host library's jz_sparsify_i8 (runtime/native.sparsify8) as the
transport's host half sends them (codec/host_glue._ycc420_host_frontend),
or all of them become overflow rows; the overflow rows of a component can
be padded with the host's sentinel to any count.  No codec path calls this
module."""
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
