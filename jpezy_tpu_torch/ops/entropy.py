"""Huffman entropy ENCODE as a batched tensor program (torch).

Counterpart of jpezy_tpu/ops/entropy.py, same formulation:

 1. Every block's emission stream is exactly 64 merged emissions: slot 0 =
    DC code + extra bits, slot j = zigzag position j (up to 3 ZRLs + code +
    extra, <= 59 bits, or EOB at slot 63), computed data-parallel.
 2. Bit offsets are exclusive cumsums of emission lengths.
 3. Per-block packing aligns each emission into a 96-bit window of three
    32-bit words and ORs the windows into the block's 64-word buffer.
 3'. On a CUDA device steps 1-3 are ONE hand-written kernel
    (encode_block_words -> ops/pack_cuda.py, csrc/entropy_pack.cu): a warp
    per block computes the 64 emissions in registers and packs them
    through a shared-memory word buffer, so the emissions (768 bytes per
    block) never reach device memory; per block it moves the 260 bytes of
    coefficients and predictor in and the words and bit count out.  The
    same source holds the pack alone (pack_block_words), the one-to-one
    counterpart of the JAX package's Pallas kernel.  For CPU tensors both
    take the plain tensor programs below (block_emissions and the
    masked-reduce pack), which are also what the kernels are held to.
 4. Cross-block concatenation funnel-shifts block words to their global
    bit phase and adds them into per-image streams.

Word convention: CPU torch implements no shifts, adds or compares on
uint32, so 32-bit words are held as int64 values in [0, 2**32) and masked
with & 0xFFFFFFFF.  An emission (<= 59 bits) is one int64 `v`; the
(hi, lo) pair of the JAX package is `v >> 32, v & 0xFFFFFFFF`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import codec_constants
from ..core import tables as T

WORDS_PER_BLOCK = 64  # 2048 bits >= worst-case block (<= ~1700 bits)
M32 = 0xFFFFFFFF


def bit_category(v: torch.Tensor, max_bits: int = 12) -> torch.Tensor:
    """Magnitude category: bit length of |v| (exact comparison ladder).
    |v| < 2**max_bits required."""
    a = v.abs()
    s = torch.zeros_like(v)
    for k in range(max_bits):
        s = s + (a >= (1 << k)).to(v.dtype)
    return s


def _append(v, n, bits, nbits):
    """Append (bits, nbits <= 16) to an int64 MSB-first accumulator (v, n).

    Replaces the JAX package's (hi, lo) funnel: every emission fits in 59
    bits, so one int64 holds it and no shift reaches 64."""
    v = torch.where(nbits > 0, (v << nbits) | bits, v)
    return v, n + nbits


def dc_predictors(dc: torch.Tensor) -> torch.Tensor:
    """Previous DC along the last axis; 0 for each chain's first block
    (the reference's pre_DC chain; sharded._emit_local with tile_axis=None
    for [N, B] inputs)."""
    return torch.cat([torch.zeros_like(dc[..., :1]), dc[..., :-1]], dim=-1)


def dc_predictors_restart(dc: torch.Tensor, seg_blocks: int) -> torch.Tensor:
    """dc_predictors with a reset to 0 at every restart-segment start
    (T.81 F.2.1.3.1), along the last axis.

    seg_blocks: blocks per restart segment FOR THIS COMPONENT
    (= restart_interval * blocks_per_mcu); <= 0 means one unbroken chain.
    """
    pred = dc_predictors(dc)
    if seg_blocks <= 0:
        return pred
    idx = torch.arange(dc.shape[-1], device=dc.device)
    return torch.where(idx % seg_blocks == 0, torch.zeros_like(pred), pred)


def _ac_run_size(qblocks: torch.Tensor, zigzag: torch.Tensor):
    """Shared AC run-length derivation over zigzag positions 1..63.

    Returns (zz [B,63] zigzag AC values, nz nonzero mask, zrl_count ZRL
    emissions before each nonzero, rem run&15, s_ac magnitude category).
    """
    B = qblocks.shape[0]
    zz = qblocks.to(torch.int64)[:, zigzag][:, 1:]          # [B, 63]
    nz = zz != 0
    pos = torch.arange(1, 64, dtype=torch.int64, device=zz.device)[None, :]
    marked = torch.where(nz, pos, torch.zeros_like(pos))
    prev_incl = torch.cummax(marked, dim=1).values
    prev_excl = torch.cat(
        [torch.zeros((B, 1), dtype=torch.int64, device=zz.device),
         prev_incl[:, :-1]], dim=1)
    run = pos - prev_excl - 1
    zrl_count = torch.where(nz, run >> 4, torch.zeros_like(run))
    rem = run & 15
    s_ac = bit_category(zz)
    return zz, nz, zrl_count, rem, s_ac


def block_emissions(qblocks: torch.Tensor, dc_pred: torch.Tensor,
                    chroma: bool):
    """[B, 64] quantized blocks -> merged emissions (hi, lo, nbits) [B, 64].

    hi, lo: int64 holding the uint32 halves of each emission (MSB-justified
    in the low bits of hi:lo); nbits: int32 emission lengths (<= 59).
    Uses the fixed Annex K Huffman tables.  Plain table indexing replaces
    the JAX package's select chains (a TPU gather workaround).
    """
    c = codec_constants(qblocks.device)
    p = "c_" if chroma else "y_"
    dc_size, dc_code = c[p + "dc_size"], c[p + "dc_code"]
    ac_size, ac_code = c[p + "ac_size"], c[p + "ac_code"]
    zrl_s, zrl_c = ac_size[T.ZRL_INDEX], ac_code[T.ZRL_INDEX]
    eob_s, eob_c = ac_size[T.EOB_INDEX], ac_code[T.EOB_INDEX]
    zero = torch.zeros((), dtype=torch.int64, device=qblocks.device)

    # ---- DC: code + extra bits (one's complement for negatives)
    diff = qblocks[:, 0].to(torch.int64) - dc_pred.to(torch.int64)
    s = bit_category(diff)
    v0 = torch.zeros_like(diff)
    n0 = torch.zeros_like(diff)
    v0, n0 = _append(v0, n0, dc_code[s], dc_size[s])
    extra = torch.where(diff < 0, diff - 1, diff) & ((1 << s) - 1)
    v0, n0 = _append(v0, n0, extra, s)

    # ---- AC: up to 3 ZRLs + code + extra per nonzero zigzag position
    zz, nz, zrl_count, rem, s_ac = _ac_run_size(qblocks, c["zigzag"])
    idx = rem * 10 + s_ac + (rem == 15).to(torch.int64)
    v = torch.zeros_like(zz)
    n = torch.zeros_like(zz)
    for k in range(3):  # the `while run > 15` ZRL loop, unrolled (max 3)
        on = nz & (zrl_count > k)
        v, n = _append(v, n, torch.where(on, zrl_c, zero),
                       torch.where(on, zrl_s, zero))
    v, n = _append(v, n, torch.where(nz, ac_code[idx], zero),
                   torch.where(nz, ac_size[idx], zero))
    extra_ac = torch.where(zz < 0, zz - 1, zz) & ((1 << s_ac) - 1)
    v, n = _append(v, n, torch.where(nz, extra_ac, zero),
                   torch.where(nz, s_ac, zero))

    # EOB at slot 63 when zigzag position 63 is zero
    eob = ~nz[:, -1]
    v[:, -1] = torch.where(eob, eob_c, v[:, -1])
    n[:, -1] = torch.where(eob, eob_s, n[:, -1])

    v_all = torch.cat([v0[:, None], v], dim=1)
    n_all = torch.cat([n0[:, None], n], dim=1)
    return v_all >> 32, v_all & M32, n_all.to(torch.int32)


def _window_words(hi, lo, nbits, off):
    """Align each emission's <= 59 bits into a 96-bit window of 3 words.

    Returns (w0 start word index, (W0, W1, W2) int64 window word values).
    """
    nb = nbits.to(torch.int64)
    v = (hi << 32) | lo
    w0 = off >> 5
    p = off & 31
    sh = 96 - p - nb                                  # in [6, 96]
    wwords = []
    for k in range(3):
        d = 32 * (2 - k) - sh                         # W_k = low32(v >> d)
        pos_part = (v >> d.clamp(0, 63)) & M32
        neg_part = (lo << (-d).clamp(0, 31)) & M32    # low32(v << -d)
        wk = torch.where(d >= 0, torch.where(d < 64, pos_part, 0),
                         torch.where(-d < 32, neg_part, 0))
        wwords.append(torch.where(nb > 0, wk, 0))
    return w0, wwords


def _pack_words_reduce(w0, wwords):
    """Masked-sum pack: packed[b, w] = sum_e sum_j Wj[b,e] * [w0[b,e]+j == w].

    Emission bit ranges are disjoint, so integer ADD == OR."""
    iota = torch.arange(WORDS_PER_BLOCK, dtype=w0.dtype,
                        device=w0.device)[None, None, :]
    t = w0[:, :, None]                                  # [B, E, 1]
    contrib = (torch.where(t == iota, wwords[0][:, :, None], 0)
               + torch.where(t + 1 == iota, wwords[1][:, :, None], 0)
               + torch.where(t + 2 == iota, wwords[2][:, :, None], 0))
    return contrib.sum(dim=1)                           # [B, W]


def pack_block_words_plain(hi, lo, nbits):
    """Plain torch pack (the `_pack_words_reduce` form of the JAX package).

    Returns (words [B, 64] int64 values in [0, 2**32) MSB-first,
    bits [B] int32)."""
    nb = nbits.to(torch.int64)
    off = torch.cumsum(nb, dim=1) - nb                # exclusive
    total = off[:, -1] + nb[:, -1]
    w0, wwords = _window_words(hi.to(torch.int64), lo.to(torch.int64),
                               nbits, off)
    return _pack_words_reduce(w0, wwords), total.to(torch.int32)


def pack_block_words(hi, lo, nbits):
    """Pack merged emissions into per-block 32-bit words.

    hi, lo: [B, 64] int64 uint32 halves of each emission; nbits: [B, 64]
    lengths.  Returns (words [B, 64] int64 in [0, 2**32), bits [B] int32).
    CUDA tensors go through the hand-written kernel (ops/pack_cuda.py), CPU
    tensors through pack_block_words_plain.  The choice follows the
    tensors' device; a kernel that fails to build or launch raises.
    """
    if hi.is_cuda:
        from .pack_cuda import pack_words_cuda

        return pack_words_cuda(hi, lo, nbits)
    if hi.device.type != "cpu":
        raise ValueError(f"pack_block_words: unsupported device {hi.device}")
    return pack_block_words_plain(hi, lo, nbits)


def encode_block_words_plain(qblocks, dc_pred, chroma: bool):
    """Plain torch entropy encode of blocks: block_emissions followed by
    pack_block_words_plain.  Returns (words [B, 64] int64 in [0, 2**32),
    bits [B] int32)."""
    return pack_block_words_plain(*block_emissions(qblocks, dc_pred, chroma))


def encode_block_words(qblocks, dc_pred, chroma: bool):
    """[B, 64] int32 quantized blocks (natural order) and [B] DC predictors
    -> (words [B, 64] int64 in [0, 2**32), bits [B] int32), with the
    component's fixed Annex K Huffman tables.

    CUDA tensors go through the fused hand-written kernel
    (pack_cuda.encode_blocks_cuda), which never stores the emissions; CPU
    tensors through encode_block_words_plain.  The choice follows the
    tensors' device; a kernel that fails to build or launch raises.
    """
    if qblocks.is_cuda:
        from .pack_cuda import encode_blocks_cuda

        return encode_blocks_cuda(qblocks, dc_pred.to(torch.int32),
                                  bool(chroma))
    if qblocks.device.type != "cpu":
        raise ValueError(
            f"encode_block_words: unsupported device {qblocks.device}")
    return encode_block_words_plain(qblocks, dc_pred, chroma)


# zero-run lengths before a nonzero that the ZRL logic turns on: 0-3 ZRLs,
# and run & 15 == 15, which shifts the flat table index by one
EDGE_RUNS = (0, 1, 14, 15, 16, 17, 30, 31, 32, 33, 46, 47, 48, 49, 61, 62)


def edge_case_blocks(seed: int = 0) -> np.ndarray:
    """Seeded quantized blocks [B, 64] int32 (natural order) that reach the
    corners of the entropy encode; one chain, DC predictors from
    dc_predictors over the whole array.  In order:

    - for each run in EDGE_RUNS and several start positions: `run` zeros,
      then a nonzero (so 0-3 ZRLs and both rem == 15 cases), the rest of
      the block sparse at random;
    - a nonzero at zigzag position 63 (no EOB), alone and after a long run;
    - all-zero blocks (DC category 0 + EOB only) and DC-only blocks;
    - DC steps between -1024 and 1016 (difference category 11, both
      signs), equal DCs (category 0), and every category between;
    - AC magnitudes at every category edge, 2**k - 1 and 2**k for both
      signs up to +-1023 (one's-complement extras);
    - dense blocks with all 63 AC coefficients of category 10, which
      exceed 1,592 bits and cross word 49.
    """
    rng = np.random.default_rng(seed)
    zz_blocks = []

    def sign():
        return int(rng.choice([-1, 1]))

    for run in EDGE_RUNS:
        for start in sorted({1, 2, 17, 63 - run}):
            if start + run > 63:
                continue
            zz = np.zeros(64, np.int64)
            if start > 1:
                zz[start - 1] = sign() * int(rng.integers(1, 1024))
            zz[start + run] = sign() * int(rng.integers(1, 1024))
            tail = np.arange(start + run + 1, 64)
            keep = tail[rng.random(tail.size) < 0.2]
            zz[keep] = rng.integers(1, 64, keep.size) * rng.choice(
                [-1, 1], keep.size)
            zz[0] = int(rng.integers(-1024, 1017))
            zz_blocks.append(zz)

    for first in (63, 1, 47):  # nonzero at 63: no EOB
        zz = np.zeros(64, np.int64)
        zz[63] = sign() * int(rng.integers(1, 1024))
        if first != 63:
            zz[first] = sign()
        zz_blocks.append(zz)

    # all-zero and DC-only blocks; DC chain through the extremes
    for dc in (0, 0, 5, 5, -1024, 1016, -1024, -1024, 1016, 1016, 0, -1, 1):
        zz = np.zeros(64, np.int64)
        zz[0] = dc
        zz_blocks.append(zz)
    # DC steps of +m and -m at both edges of every category 1..11
    for m in sorted({min(e, 2040) for k in range(11)
                     for e in ((1 << k), (2 << k) - 1)}):
        a = max(-1024, min(-(m // 2), 1016 - m))
        for dc in (a, a + m, a):
            zz = np.zeros(64, np.int64)
            zz[0] = dc
            zz[1:4] = rng.integers(-3, 4, 3)
            zz_blocks.append(zz)

    # AC magnitudes at the category edges, both signs
    mags = sorted({m for k in range(10) for m in ((1 << k), (2 << k) - 1)})
    for sgn in (1, -1):
        zz = np.zeros(64, np.int64)
        zz[1:1 + len(mags)] = [sgn * m for m in mags]
        zz[40] = -sgn * 1023
        zz_blocks.append(zz)

    # dense worst case: every AC coefficient in category 10
    for _ in range(4):
        zz = rng.integers(512, 1024, 64) * rng.choice([-1, 1], 64)
        zz[0] = int(rng.integers(-1024, 1017))
        zz_blocks.append(zz)

    zz_all = np.stack(zz_blocks)
    q = np.zeros_like(zz_all)
    q[:, T.ZIGZAG] = zz_all          # zigzag position k -> natural index
    return q.astype(np.int32)


def stream_offsets_batch(bits: torch.Tensor):
    """Global bit offsets for stream-ordered blocks: [N, B] bits ->
    (goff [N, B] int64, total [N] int64)."""
    b = bits.to(torch.int64)
    goff = torch.cumsum(b, dim=1) - b
    total = goff[:, -1] + b[:, -1]
    return goff, total


def stream_offsets_restart_batch(bits: torch.Tensor, seg_blocks: int):
    """Segment-aligned bit offsets (restart encode): [N, B] stream-ordered
    bits -> (goff [N, B], total [N], seg_bits [N, S]), all int64.  Each
    segment starts byte-aligned (RSTn markers sit on byte boundaries); the
    tail segment is padded to S * seg_blocks blocks of 0 bits."""
    N, B = bits.shape
    S = -(-B // seg_blocks)
    bp = torch.nn.functional.pad(bits.to(torch.int64),
                                 (0, S * seg_blocks - B))
    bseg = bp.reshape(N, S, seg_blocks)
    seg_bits = bseg.sum(dim=2)
    seg_span = ((seg_bits + 7) // 8) * 8            # byte-aligned span
    base = torch.cumsum(seg_span, dim=1) - seg_span
    within = torch.cumsum(bseg, dim=2) - bseg
    goff = (base[:, :, None] + within).reshape(N, -1)[:, :B]
    total = base[:, -1] + seg_span[:, -1]
    return goff, total, seg_bits


def _concat_batch_scatter(words, goff, maxw: int):
    """Funnel-shift each block's words to its per-image global bit offset
    and add them into [N, maxw] streams (int64 words in [0, 2**32)).

    words: [N, B, W] int64; goff: [N, B] int64.  Blocks touch disjoint bits
    of shared boundary words, so add == or.  Contributions past an image's
    budget go to one extra drop slot at index N*maxw (torch has no
    mode="drop"), so they can never wrap into the next image's stream.
    The caller detects overflow from the totals.  The JAX form's `bits`
    argument only picked its TPU-specific window-width tiers, so the port
    takes none.
    """
    N, B, W = words.shape
    dev = words.device
    rr = goff & 31
    q = goff >> 5
    ext = torch.cat([torch.zeros((N, B, 1), dtype=torch.int64, device=dev),
                     words], dim=2)
    sh = torch.where(rr > 0, rr, 1)[..., None]
    shifted = torch.where(
        rr[..., None] > 0,
        (ext[..., 1:] >> sh) | ((ext[..., :-1] << (32 - sh)) & M32),
        ext[..., 1:])
    carry = torch.where(rr > 0, (words[..., -1] << (32 - sh[..., 0])) & M32,
                        0)[..., None]
    contrib = torch.cat([shifted, carry], dim=2)               # [N, B, W+1]
    woff = q[..., None] + torch.arange(W + 1, dtype=torch.int64,
                                       device=dev)[None, None, :]
    img = torch.arange(N, dtype=torch.int64, device=dev)[:, None, None] * maxw
    idx = torch.where(woff < maxw, img + woff, N * maxw)
    out = torch.zeros(N * maxw + 1, dtype=torch.int64, device=dev)
    out.index_add_(0, idx.reshape(-1), contrib.reshape(-1))
    return out[:N * maxw].reshape(N, maxw)
