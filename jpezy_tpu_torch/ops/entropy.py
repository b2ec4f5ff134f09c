"""Huffman entropy ENCODE as a batched tensor program (torch).

Counterpart of jpezy_tpu/ops/entropy.py, same formulation:

 1. Every block's emission stream is exactly 64 merged emissions: slot 0 =
    DC code + extra bits, slot j = zigzag position j (up to 3 ZRLs + code +
    extra, or EOB at slot 63), computed data-parallel.  With the fixed
    Annex K tables an emission has <= 59 bits; with optimal per-image
    tables (`optimize`) it can reach 74, so the plain encode keeps each
    slot's ZRL prefix apart from its code and extra bits.
 2. Bit offsets are exclusive cumsums of emission lengths.
 3. Per-block packing aligns each emission into a 96-bit window of three
    32-bit words and ORs the windows into the block's 64-word buffer.
 3'. On a CUDA device steps 1-3, and the DC predictor chains of every
    image and component, are ONE hand-written kernel launch for the
    batch's three components (encode_blocks_batch -> ops/pack_cuda.py,
    csrc/entropy_pack.cu): a warp stages a run of 32 blocks and its
    table sets in shared memory, a lane per block finds its predictor and
    codes its nonzero coefficients in zigzag order into its words, so
    neither the emissions (768 bytes per block) nor the predictors reach
    device memory; per block it moves the 256 bytes of coefficients in and
    the 32-bit words and bit count out.  The same source
    holds the pack alone (pack_block_words), the one-to-one counterpart of
    the JAX package's Pallas kernel.  For CPU tensors both take the plain
    tensor programs below (dc_predictors_restart, block_emissions and the
    masked-reduce pack), which are also what the kernels are held to.
 4. Cross-block concatenation funnel-shifts block words to their global
    bit phase and adds them into per-image streams (concat_streams; on
    CUDA tensors a hand-written kernel, ops/concat_cuda.py,
    csrc/stream_concat.cu).

Pass 1 of the optimized encode counts the symbols the encode would emit,
per image (symbol_histograms_batch; a hand-written kernel on CUDA
tensors, in the same source as the entropy kernel).

Word convention: CPU torch implements no shifts, adds or compares on
uint32, so the plain forms hold 32-bit words as int64 values in [0,
2**32) and mask with & 0xFFFFFFFF.  An emission part of <= 59 bits is one
int64 `v`; the (hi, lo) pair of the JAX package is `v >> 32, v &
0xFFFFFFFF`.  On the card the entropy kernel writes the words as int32
tensors of their 32-bit patterns, half the bytes, and the concat kernel
reads them so; torch compares and shifts them as signed there, so only
the kernels and the host (words64, or a numpy view as uint32) read
them.
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


def dc_predictors(dc: torch.Tensor) -> torch.Tensor:
    """Previous DC along the last axis; 0 for each chain's first block
    (the reference's pre_DC chain; sharded._emit_local with tile_axis=None
    for [N, B] inputs)."""
    return torch.cat([torch.zeros_like(dc[..., :1]), dc[..., :-1]], dim=-1)


def dc_predictors_restart(dc: torch.Tensor, seg_blocks: int,
                          first: torch.Tensor | None = None) -> torch.Tensor:
    """dc_predictors with a reset to 0 at every restart-segment start
    (T.81 F.2.1.3.1), along the last axis.

    seg_blocks: blocks per restart segment FOR THIS COMPONENT
    (= restart_interval * blocks_per_mcu); <= 0 means one unbroken chain.
    first: the predictor of each chain's first block (dc without its last
    axis), None for 0: a tile shard's carry, the previous shard's last DC
    (parallel/sharded.py).  A segment that starts at the chain's first
    block still resets to 0.
    """
    pred = dc_predictors(dc)
    if first is not None:
        pred[..., 0] = first.to(pred.dtype)
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


_TABLE_LENGTHS = (12, 12, 162, 162)  # dc_size, dc_code, ac_size, ac_code


def _table_sets(tables, device):
    """Huffman tables as four int64 tensors [T, n] on `device` (None: where
    they are), in the JAX order of block_emissions(tables=...): (dc_size
    [T, 12], dc_code, ac_size [T, 162], ac_code).  tables: one set (1-D
    arrays) or one set per image (a leading [N] axis); numpy or torch."""
    out = []
    for t in tables:
        t = torch.as_tensor(t).to(device=device, dtype=torch.int64)
        out.append(t.reshape(1, -1) if t.dim() == 1 else t)
    if len(out) != 4 or len({t.shape[0] for t in out}) != 1 or tuple(
            t.shape[1] for t in out) != _TABLE_LENGTHS:
        raise ValueError("tables must be (dc_size [12], dc_code [12], "
                         "ac_size [162], ac_code [162]) with one leading "
                         "set axis")
    return tuple(out)


def annex_k_tables(device, chroma: bool):
    """The component's fixed Annex K Huffman tables in the JAX order, one
    set [1, n] of int64 tensors on `device`."""
    c = codec_constants(device)
    p = "c_" if chroma else "y_"
    return tuple(c[p + k][None, :]
                 for k in ("dc_size", "dc_code", "ac_size", "ac_code"))


def kernel_tables(tables, device) -> torch.Tensor:
    """JAX-ordered tables (dc_size, dc_code, ac_size, ac_code), one set or
    one per image, numpy or torch -> the rows the CUDA entropy kernel
    takes: int32 [T, 348] on `device`, each row dc_code [12], dc_size
    [12], ac_code [162], ac_size [162].  Host tables are laid out on the
    host and uploaded once.  The one place the two orders meet; the
    tables are int32 arrays of equal lengths, so a swap would still run
    (tests/test_torch_optimize.py holds it)."""
    dc_size, dc_code, ac_size, ac_code = _table_sets(tables, None)
    return torch.cat([dc_code, dc_size, ac_code, ac_size], dim=1).to(
        device=device, dtype=torch.int32).contiguous()


def _set_index(B: int, nsets: int, blocks_per_image, device):
    """Table set of each of B blocks: block b takes set b // bpi."""
    if nsets == 1:
        return torch.zeros(B, dtype=torch.int64, device=device)
    bpi = blocks_per_image if blocks_per_image is not None else B // nsets
    if bpi <= 0 or bpi * nsets != B:
        raise ValueError(f"{nsets} table sets do not divide {B} blocks "
                         f"into images of {blocks_per_image}")
    return torch.arange(B, dtype=torch.int64, device=device) // bpi


def _emission_parts(qblocks, dc_pred, chroma: bool, tables=None,
                    blocks_per_image=None):
    """Every slot's emission in two parts, [B, 64] int64 each:
    (zv, zn) the ZRL prefix (up to 3 codes of <= 16 bits: <= 48 bits; 0
    but on a nonzero AC after 16 or more zeros) and (v, n) the code and
    extra bits (<= 16 + 11 bits).  The whole emission is zv followed by v,
    zn + n <= 74 bits with optimal tables, so it is kept in two parts.
    Plain table indexing replaces the JAX package's select chains (a TPU
    gather workaround)."""
    dev = qblocks.device
    dc_size, dc_code, ac_size, ac_code = (
        annex_k_tables(dev, chroma) if tables is None
        else _table_sets(tables, dev))
    sel = _set_index(qblocks.shape[0], dc_size.shape[0], blocks_per_image,
                     dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    # ---- DC: code + extra bits (one's complement for negatives)
    diff = qblocks[:, 0].to(torch.int64) - dc_pred.to(torch.int64)
    s = bit_category(diff)
    extra = torch.where(diff < 0, diff - 1, diff) & ((1 << s) - 1)
    v0 = (dc_code[sel, s] << s) | extra
    n0 = dc_size[sel, s] + s

    # ---- AC: ZRL prefix, then code + extra per nonzero zigzag position
    zz, nz, zrl_count, rem, s_ac = _ac_run_size(qblocks, codec_constants(
        dev)["zigzag"])
    idx = rem * 10 + s_ac + (rem == 15).to(torch.int64)
    row = sel[:, None]
    extra_ac = torch.where(zz < 0, zz - 1, zz) & ((1 << s_ac) - 1)
    v = torch.where(nz, (ac_code[row, idx] << s_ac) | extra_ac, zero)
    n = torch.where(nz, ac_size[row, idx] + s_ac, zero)
    zrl_s = ac_size[row, T.ZRL_INDEX]
    zrl_c = ac_code[row, T.ZRL_INDEX]
    zv = torch.zeros_like(zz)
    for k in range(3):  # the `while run > 15` ZRL loop, unrolled (max 3)
        zv = torch.where(zrl_count > k, (zv << zrl_s) | zrl_c, zv)
    zn = zrl_count * zrl_s

    # EOB at slot 63 when zigzag position 63 is zero
    eob = ~nz[:, -1]
    v[:, -1] = torch.where(eob, ac_code[sel, T.EOB_INDEX], v[:, -1])
    n[:, -1] = torch.where(eob, ac_size[sel, T.EOB_INDEX], n[:, -1])

    first = torch.zeros_like(diff)[:, None]
    return (torch.cat([first, zv], dim=1), torch.cat([first, zn], dim=1),
            torch.cat([v0[:, None], v], dim=1),
            torch.cat([n0[:, None], n], dim=1))


def block_emissions(qblocks: torch.Tensor, dc_pred: torch.Tensor,
                    chroma: bool, tables=None, blocks_per_image=None):
    """[B, 64] quantized blocks -> merged emissions (hi, lo, nbits) [B, 64].

    hi, lo: int64 holding the uint32 halves of the LOW 64 bits of each
    emission (MSB-justified in the low bits of hi:lo); nbits: int32
    emission lengths.  tables: None for the fixed Annex K tables of the
    component, else (dc_size, dc_code, ac_size, ac_code) as in the JAX
    package, one set or one per image (leading [N] axis; block b takes set
    b // blocks_per_image).  With optimal tables an emission can reach 74
    bits (3 ZRLs of 16 bits, a 16-bit code, 10 extra bits); the JAX
    package's (hi, lo) accumulator then keeps its low 64 bits, and so does
    this, so the two agree on every slot.  What packs such an emission
    whole is encode_block_words_plain, which keeps the ZRL prefix apart.
    """
    zv, zn, v, n = _emission_parts(qblocks, dc_pred, chroma, tables,
                                   blocks_per_image)
    # merged = (zv << n) | v, n <= 27: low 32 bits and bits 32..63
    lo = (((zv & M32) << n) | v) & M32
    hi = (zv >> (32 - n)) & M32
    return hi, lo, (zn + n).to(torch.int32)


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


def _pack_at(v, nbits, off):
    """Pack emissions of <= 59 bits (int64 values) at the given bit offsets
    into per-block words [B, 64] (the masked-reduce form)."""
    w0, wwords = _window_words(v >> 32, v & M32, nbits, off)
    return _pack_words_reduce(w0, wwords)


def encode_block_words_plain(qblocks, dc_pred, chroma: bool, tables=None,
                             blocks_per_image=None):
    """Plain torch entropy encode of blocks: the emissions of
    block_emissions, packed.  Each slot's ZRL prefix (<= 48 bits) and its
    code and extra bits (<= 27) are packed as two emissions, the second
    right behind the first, so a whole emission may exceed 64 bits (up to
    74 with optimal tables).  Emission bit ranges are disjoint, so the two
    packs add.  Returns (words [B, 64] int64 in [0, 2**32), bits [B]
    int32)."""
    zv, zn, v, n = _emission_parts(qblocks, dc_pred, chroma, tables,
                                   blocks_per_image)
    tot = zn + n
    off = torch.cumsum(tot, dim=1) - tot                # exclusive
    words = _pack_at(zv, zn, off) + _pack_at(v, n, off + zn)
    return words, tot.sum(dim=1).to(torch.int32)


def encode_block_words(qblocks, dc_pred, chroma: bool, tables=None,
                       blocks_per_image=None):
    """[B, 64] int32 quantized blocks (natural order) and [B] DC predictors
    -> (words [B, 64] int64 in [0, 2**32), bits [B] int32):
    encode_block_words_plain on CPU tensors.  tables: None for the
    component's fixed Annex K Huffman tables, else (dc_size, dc_code,
    ac_size, ac_code) in the JAX package's order, one set or one per image
    (leading [N] axis; block b takes set b // blocks_per_image, by default
    B // N).  The card has no per-component kernel: a batch's CUDA blocks
    go through encode_blocks_batch, which finds the predictors itself, so
    CUDA tensors raise here."""
    if qblocks.device.type != "cpu":
        raise ValueError(
            f"encode_block_words: unsupported device {qblocks.device} (CUDA "
            "blocks take encode_blocks_batch, one kernel for the batch)")
    return encode_block_words_plain(qblocks, dc_pred, chroma, tables,
                                    blocks_per_image)


def encode_blocks_batch_plain(yq, cbq, crq, restart_interval: int = 0,
                              carry=None, tables=(None, None)):
    """Plain torch entropy encode of a batch's three components
    (jpezy_tpu/parallel/sharded.py:_emit_local with interleave=False, the
    carry given in place of its ppermute): per component the DC predictor
    chain of each image (dc_predictors_restart: reset every
    restart_interval MCUs, 4 blocks of Y and 1 of Cb and of Cr per MCU;
    carry[:, c] or 0 at the image's first block), then
    encode_block_words_plain over the flattened blocks.

    yq [N, B_Y, 64], cbq and crq [N, B_C, 64] quantized blocks; carry:
    [N, 3] or None; tables: (luma, chroma) Huffman tables in the JAX
    order, each None (the fixed tables) or one set, or one set per image
    with a leading [N] axis.  Returns ((words_Y, words_Cb, words_Cr) [N,
    B_c, 64] int64 in [0, 2**32), (bits_Y, bits_Cb, bits_Cr) [N, B_c]
    int32)."""
    words, bits = [], []
    for c, (q, chroma, bpm, tabs) in enumerate((
            (yq, False, 4, tables[0]), (cbq, True, 1, tables[1]),
            (crq, True, 1, tables[1]))):
        n, b, _ = q.shape
        pred = dc_predictors_restart(
            q[:, :, 0], restart_interval * bpm,
            None if carry is None else carry[:, c])
        w_c, b_c = encode_block_words_plain(q.reshape(-1, 64),
                                            pred.reshape(-1), chroma, tabs, b)
        words.append(w_c.reshape(n, b, w_c.shape[-1]))
        bits.append(b_c.reshape(n, b))
    return tuple(words), tuple(bits)


def encode_blocks_batch(yq, cbq, crq, restart_interval: int = 0, carry=None,
                        tables=(None, None)):
    """encode_blocks_batch_plain's (words, bits).  CUDA tensors go through
    the hand-written kernel (pack_cuda.encode_blocks_batch_cuda: one launch
    for the three components, every set of tables in it, the predictors
    found in it; tables in the JAX order are laid out as its rows by
    kernel_tables, and a table given as a tensor is taken as such rows),
    whose words are int32 tensors of the 32-bit patterns (words64 widens
    them to the plain form's values); CPU tensors through
    encode_blocks_batch_plain; a kernel that fails to build or launch
    raises."""
    if yq.is_cuda:
        from .pack_cuda import encode_blocks_batch_cuda

        rows = None
        if tables[0] is not None or tables[1] is not None:
            rows = tuple(
                t if isinstance(t, torch.Tensor) else kernel_tables(
                    annex_k_tables("cpu", chroma) if t is None else t,
                    yq.device)
                for t, chroma in zip(tables, (False, True)))
        return encode_blocks_batch_cuda(
            yq, cbq, crq, restart_interval=restart_interval,
            carry=None if carry is None else carry.to(torch.int32),
            tables=rows)
    if yq.device.type != "cpu":
        raise ValueError(
            f"encode_blocks_batch: unsupported device {yq.device}")
    return encode_blocks_batch_plain(yq, cbq, crq, restart_interval, carry,
                                     tables)


HIST_BINS = 256


def symbol_histograms_plain(qblocks, dc_pred, blocks_per_image=None):
    """Per-image Huffman symbol counts [N, 2, 256] int32 (row 0: DC
    magnitude categories, row 1: AC RRRRSSSS symbols with ZRL 0xF0 and EOB
    0x00), exactly the symbols the entropy encode emits; the counterpart
    of jpezy_tpu/ops/entropy.py:symbol_histograms vmapped over images.
    Blocks [B, 64] hold N images of blocks_per_image blocks each (default:
    one image of all B)."""
    dev = qblocks.device
    B = qblocks.shape[0]
    bpi = B if blocks_per_image is None else blocks_per_image
    if bpi <= 0 or B % bpi:
        raise ValueError(f"{B} blocks are no whole number of images of "
                         f"{bpi}")
    N = B // bpi
    base = (torch.arange(B, dtype=torch.int64, device=dev)
            // bpi) * (2 * HIST_BINS)                          # [B]
    diff = qblocks[:, 0].to(torch.int64) - dc_pred.to(torch.int64)
    _, nz, zrl_count, rem, s_ac = _ac_run_size(
        qblocks, codec_constants(dev)["zigzag"])
    ac = base[:, None] + HIST_BINS
    idx = torch.cat([
        base + bit_category(diff),                            # DC
        (ac + ((rem << 4) | s_ac))[nz],                       # AC symbols
        ac[:, 0] + 0xF0,                                      # ZRLs
        ac[:, 0],                                             # EOB
    ])
    weight = torch.cat([
        torch.ones(B + int(nz.sum()), dtype=torch.int64, device=dev),
        zrl_count.sum(dim=1),
        (~nz[:, -1]).to(torch.int64),
    ])
    hist = torch.zeros(N * 2 * HIST_BINS, dtype=torch.int64, device=dev)
    hist.index_add_(0, idx, weight)
    return hist.reshape(N, 2, HIST_BINS).to(torch.int32)


def symbol_histograms_batch_plain(yq, cbq, crq, restart_interval: int = 0,
                                  carry=None):
    """Per-image symbol counts [N, 4, 256] int32 of a batch's three
    components (jpezy_tpu/codec/jax_codec.py:_symbol_histograms_batch):
    Y-DC, Y-AC, C-DC, C-AC, chroma summed over Cb and Cr.  yq [N, B_Y,
    64], cbq and crq [N, B_C, 64] quantized blocks; each component of an
    image is one DC chain, reset every restart_interval MCUs (4 blocks of
    Y, 1 of Cb and of Cr per MCU).  carry: [N, 3] first DC predictor of
    each image's Y, Cb and Cr chain (a tile shard's carry-in), None for
    0."""
    hists = []
    for c, (q, bpm) in enumerate(((yq, 4), (cbq, 1), (crq, 1))):
        n, b, _ = q.shape
        pred = dc_predictors_restart(
            q[:, :, 0], restart_interval * bpm,
            None if carry is None else carry[:, c])
        hists.append(symbol_histograms_plain(q.reshape(-1, 64),
                                             pred.reshape(-1), b))
    y, cb, cr = hists
    return torch.cat([y, cb + cr], dim=1)


def symbol_histograms_batch(yq, cbq, crq, restart_interval: int = 0,
                            carry=None):
    """symbol_histograms_batch_plain's counts.  CUDA tensors go through
    the hand-written kernel (pack_cuda.symbol_histograms_batch_cuda: one
    launch for the three components, the DC predictors derived in it),
    CPU tensors through symbol_histograms_batch_plain; a kernel that fails
    to build or launch raises."""
    if yq.is_cuda:
        from .pack_cuda import symbol_histograms_batch_cuda

        return symbol_histograms_batch_cuda(
            yq, cbq, crq, restart_interval=restart_interval,
            carry=None if carry is None else carry.to(torch.int32))
    if yq.device.type != "cpu":
        raise ValueError(
            f"symbol_histograms_batch: unsupported device {yq.device}")
    return symbol_histograms_batch_plain(yq, cbq, crq, restart_interval,
                                         carry)


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


def long_emission_tables():
    """Optimal Huffman tables (core.tables.optimal_flat_tables) of a legal
    histogram under which ZRL and the symbol 0xEA (run 14, category 10)
    both get 16-bit codes, so a block whose only nonzero AC coefficient is
    +-512..1023 at zigzag position 63 emits 3 ZRLs, that code and 10 extra
    bits in one slot: 74 bits, more than one 64-bit word holds.  Common
    symbols get halving counts, which makes the code lengths a chain.

    Returns ((dc_bits, dc_vals), (ac_bits, ac_vals), dc_size, dc_code,
    ac_size, ac_code) as optimal_flat_tables does."""
    syms = [0x00] + [(r << 4) | s for r in range(3) for s in range(1, 11)]
    ac = np.zeros(256, np.int64)
    for k, sym in enumerate(syms):
        ac[sym] = 1 << (24 - k) if k < 20 else 2
    ac[0xF0] = ac[0xEA] = 1
    dc = np.zeros(256, np.int64)
    dc[:12] = 100
    return T.optimal_flat_tables(dc, ac)


def long_emission_blocks() -> np.ndarray:
    """Quantized blocks [8, 64] int32 (natural order) for
    long_emission_tables: the 74-bit slot with both signs and small DCs,
    then 1 and 2 ZRLs before 0xEA-like symbols and an all-zero block."""
    zz = np.zeros((8, 64), np.int64)
    zz[0, 63], zz[1, 63], zz[1, 0] = 700, -1023, 5
    zz[2, 0], zz[2, 63] = -3, 512
    zz[3, 40] = 600                        # 2 ZRLs + run 7
    zz[4, 1], zz[4, 63] = 1, 900           # 3 ZRLs + run 13
    zz[5, 20], zz[5, 50] = -2, -1000       # 1 ZRL + run 13
    zz[6, 0] = 7
    q = np.zeros_like(zz)
    q[:, T.ZIGZAG] = zz
    return q.astype(np.int32)


def stream_blocks(n: int, nm: int, seed: int = 0):
    """Seeded per-component packed blocks (words, bits) for the stream
    concat, as _emit_local returns them: words (Y, Cb, Cr) int64 [n, B_c,
    64] in [0, 2**32), zero past each block's bits; bits int32 [n, B_c] in
    [0, 2048]; B_Y = 4 nm, B_Cb = B_Cr = nm.  Every fifth block is empty
    and every eleventh (from the fourth) has bits reaching word 63."""
    rng = np.random.default_rng(seed)
    words, bits = [], []
    pos = np.arange(WORDS_PER_BLOCK)
    for per_mcu in (4, 1, 1):
        b = rng.integers(0, 700, (n, per_mcu * nm))
        b[:, ::5] = 0
        b[:, 3::11] = rng.integers(2017, 2049, b[:, 3::11].shape)
        full, tail = (b // 32)[..., None], (b % 32)[..., None]
        keep = np.where(pos < full, M32, np.where(
            (pos == full) & (tail > 0), (M32 << (32 - tail)) & M32, 0))
        w = rng.integers(0, 2 ** 32, (*b.shape, WORDS_PER_BLOCK),
                         dtype=np.int64)
        words.append(torch.from_numpy(w & keep))
        bits.append(torch.from_numpy(b.astype(np.int32)))
    return tuple(words), tuple(bits)


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


def concat_streams_plain(words, bits, restart_interval: int, maxw: int):
    """Plain torch stream concat from PER-COMPONENT packed blocks
    (jpezy_tpu/codec/jax_codec.py:_concat_batch_combined_comp, and with
    the caller's maxw the JAX concat_device_batch and
    concat_device_restart_batch of its sharded encode).

    words: (Y, Cb, Cr) [N, B_c, 64] int64 words in [0, 2**32); bits: (Y,
    Cb, Cr) [N, B_c]; B_Y = 4 nm, B_Cb = B_Cr = nm.  The scatter is
    order-independent, so blocks scatter from component order with
    MCU-ordered global bit offsets; only the small [N, nm*6] bits array is
    interleaved.  Returns combined [N, 1 + S + maxw] int64: column 0 =
    total bits, then with restart_interval the S per-segment bit counts
    (each segment starts byte-aligned in the stream), then the stream;
    writes past maxw are dropped and the caller checks total <= 32 *
    maxw."""
    N, nm = bits[1].shape
    bits_mcu = torch.cat(
        [bits[0].reshape(N, nm, 4), bits[1].reshape(N, nm, 1),
         bits[2].reshape(N, nm, 1)], dim=2).reshape(N, nm * 6)
    head = []
    if restart_interval:
        goff, total, seg_bits = stream_offsets_restart_batch(
            bits_mcu, 6 * restart_interval)
        head = [seg_bits]
    else:
        goff, total = stream_offsets_batch(bits_mcu)
    g6 = goff.reshape(N, nm, 6)
    goff_c = torch.cat(
        [g6[:, :, :4].reshape(N, nm * 4), g6[:, :, 4], g6[:, :, 5]], dim=1)
    stream = _concat_batch_scatter(torch.cat(words, dim=1), goff_c, maxw)
    return torch.cat([total[:, None]] + head + [stream], dim=1)


def words32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> int32 tensor of the same 32-bit
    patterns (words at or above 2**31 become negative): the layout the
    entropy kernel writes on the card.  Exact arithmetic, no wrapping
    cast."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def words64(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 words in [0, 2**32), the plain forms'
    convention; int64 words pass unchanged."""
    if words.dtype == torch.int32:
        return words.to(torch.int64) & M32
    return words


def concat_streams(words, bits, restart_interval: int, maxw: int):
    """concat_streams_plain's combined.  words: either layout, int32
    tensors holding the 32-bit patterns (what the entropy kernel writes
    on the card) or int64 values in [0, 2**32) (the plain forms').  CUDA
    tensors go through the hand-written kernel (concat_cuda.
    concat_streams_cuda, which takes int32 words: it reads each block's
    used words where they lie, so the words are neither interleaved nor
    concatenated first; int64 words are narrowed first), CPU tensors
    through concat_streams_plain (int32 words widened first); a kernel
    that fails to build or launch raises."""
    if words[0].is_cuda:
        from .concat_cuda import concat_streams_cuda

        return concat_streams_cuda(
            tuple(w if w.dtype == torch.int32 else words32(w)
                  for w in words),
            tuple(b.to(torch.int32) for b in bits), maxw=maxw,
            restart_interval=restart_interval)
    if words[0].device.type != "cpu":
        raise ValueError(
            f"concat_streams: unsupported device {words[0].device}")
    return concat_streams_plain(tuple(words64(w) for w in words), bits,
                                restart_interval, maxw)
