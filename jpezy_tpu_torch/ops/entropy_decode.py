"""Device-side Huffman entropy DECODE over restart segments (torch).

Counterpart of jpezy_tpu/ops/entropy_decode.py in its LUT mode.  Restart
segments are byte-aligned and reset the DC predictors, so each decodes on
its own: a batch of restart streams gives thousands of independent lanes.
The `indexed` transport gets the same shape out of restart-free streams:
a length-only host scan records a bit offset and the DC predictors every
few MCUs, and each pseudo-segment starts from them (skip0, preds0).

Per lane: a 64-bit window register refilled 32 bits at a time from the
lane's row of destuffed big-endian words, one read of the combined LUT
([T, 6, 65536]: table set x (component, DC/AC) rows, entry =
(HUFFVAL << 8) | code length, -1 invalid; the layout of the host LUT in
runtime/native.py) per symbol, T.81 F.2.2.1 sign extension, ZRL/EOB
control, and a store of each coefficient at its natural position.

decode_segments runs the hand-written CUDA kernel (ops/scan_cuda.py,
csrc/huffman_scan.cu: one warp per lane) for CUDA tensors and
decode_segments_plain, the same steps as lockstep tensor operations over
all lanes, for CPU tensors.  The two give identical blocks and flags on
valid and on corrupt input; the plain version is what the kernel is held
to.  The kernel answers short codes from a first-level table that it
builds from the LUT by the rule of first_level_table.

CORRUPTION SIGNAL: a per-lane `bad` flag is set by
  - an invalid LUT window (no code matches; 8 bits are skipped),
  - an AC coefficient index past 63 (the run crosses the block end),
  - a ZRL whose 16 zeros pass position 63 (kk + 15 > 63: the bound of
    the reference decoder; a ZRL at kk == 48 ends the block exactly and
    is valid),
  - a DC symbol above 15 or a table-set index outside the LUT (tables no
    baseline stream carries; they would make the shifts undefined),
  - and, with `rawlen` given, a final bit position outside the segment's
    last destuffed byte: any drift in code lengths that a bit flip causes
    is caught even when every window stays decodable.

The chain tables, scan_mode and sym_unroll of the JAX package are TPU
workarounds and are not ported.
"""
from __future__ import annotations

import collections
import hashlib

import numpy as np
import torch

from ..core import tables as T

M32 = 0xFFFFFFFF
_STD_TDTA = ((0, 0), (1, 1), (1, 1))


def _tdta(scan_components):
    tdta = (_STD_TDTA if scan_components is None
            else [(sc.Td, sc.Ta) for sc in scan_components])
    if len(tdta) != 3:
        raise ValueError("device decode LUT needs 3 scan components")
    return tdta


def build_decode_lut(huff, scan_components=None) -> np.ndarray:
    """[6, 65536] int32 combined decode LUT from parsed DHT tables.

    huff: ParsedJpeg.huff ({0: dc tables, 1: ac tables} keyed by table id).
    scan_components: the stream's Td/Ta assignment (ParsedJpeg
    .scan_components); None = the standard Y->0, C->1 assignment.
    Rows: comp c's DC at 2c, AC at 2c+1.
    Entry = (HUFFVAL << 8) | code_bits for the 16-bit window, -1 invalid
    (same contract as the host LUT, runtime/native.py:_huff_lut).
    """
    from ..runtime.native import _huff_lut

    rows = []
    for td, ta in _tdta(scan_components):
        rows.append(_huff_lut(huff[0][td]))
        rows.append(_huff_lut(huff[1][ta]))
    return np.stack(rows)


def lut_content_key(huff, scan_components=None) -> bytes:
    """Content hash of the table set a stream resolves to -- the dedup key
    for batching streams with mixed DHT tables."""
    hsh = hashlib.sha1()
    for td, ta in _tdta(scan_components):
        for cls, tid in ((0, td), (1, ta)):
            t = huff[cls][tid]
            hsh.update(np.asarray(t.sizes, np.int32).tobytes())
            hsh.update(np.asarray(t.codes, np.int32).tobytes())
            hsh.update(np.asarray(t.values, np.int32).tobytes())
    return hsh.digest()


_LUT_CACHE_SIZE = 8
_lut_cache: collections.OrderedDict = collections.OrderedDict()


def device_lut(lut: np.ndarray, device) -> torch.Tensor:
    """int32 LUT tensor on `device`, cached by device and content: standard
    streams all share the Annex K tables, so the 1.5 MiB upload happens
    once per process and device, not once per batch."""
    arr = np.ascontiguousarray(lut, np.int32)
    key = (str(torch.device(device)), arr.shape,
           hashlib.sha1(arr.tobytes()).digest())
    hit = _lut_cache.get(key)
    if hit is None:
        hit = torch.from_numpy(arr.copy()).to(device)
        _lut_cache[key] = hit
        while len(_lut_cache) > _LUT_CACHE_SIZE:
            _lut_cache.popitem(last=False)
    else:
        _lut_cache.move_to_end(key)
    return hit


# Index bits of the scan kernel's first-level table (kFirstBits of
# csrc/huffman_scan.cu): 6 rows x 512 entries x 4 bytes of shared memory.
FIRST_LEVEL_BITS = 9


def first_level_table(lut: np.ndarray,
                      bits: int = FIRST_LEVEL_BITS) -> np.ndarray:
    """[..., 65536] int32 LUT rows -> [..., 2**bits] uint16 first-level
    rows: which prefixes the scan kernel's shared-memory table answers,
    and with which LUT entry (the kernel stores that entry split into the
    fields its decode step reads).

    Entry p is the LUT's entry for the first window with the `bits`-bit
    prefix p where that entry fits 16 bits and its code length is 1..bits,
    else 0 ("read the full LUT").  A code of at most `bits` bits that
    matches p matches every window with that prefix, so for the LUT of a
    prefix code (build_decode_lut) the entry answers all of them.

    A model of the kernel's table, which the kernel builds on its own in
    CUDA: nothing in the package calls this, the tests hold it to the full
    LUT.  The kernel also leaves to the full LUT a DC entry whose symbol is
    above 15 (it flags the segment), which changes no result."""
    lut = np.asarray(lut, np.int32)
    e = lut[..., ::1 << (16 - bits)]
    ln = e & 0xFF
    ok = (e > 0) & (e < 65536) & (ln >= 1) & (ln <= bits)
    return np.where(ok, e, 0).astype(np.uint16)


def words_tensor(words: np.ndarray) -> torch.Tensor:
    """[S, Lw] numpy uint32 rows -> int32 tensor holding the same bit
    patterns (a view of the memory, not a wrapping cast): the form
    decode_segments takes its words in."""
    return torch.from_numpy(np.ascontiguousarray(words, np.uint32)
                            .view(np.int32))


def corrupt_rows(words: np.ndarray, rawlen: np.ndarray,
                 seed: int = 0) -> np.ndarray:
    """Seeded corruption of segment rows [S, Lw] uint32, for holding
    decode_segments to its plain version and to the JAX package on input
    that is not a valid stream.  Each row gets one of: a few bit flips, a
    zeroed head, a zeroed (truncated) tail, an all-ones tail, or nothing,
    within the rawlen bytes it uses."""
    rng = np.random.default_rng(seed)
    w = np.array(words, np.uint32)
    for s in range(w.shape[0]):
        used = max(1, int(rawlen[s]) // 4)
        kind = rng.integers(0, 5)
        if kind == 0:
            for _ in range(int(rng.integers(1, 4))):
                w[s, rng.integers(0, used)] ^= np.uint32(
                    1 << int(rng.integers(0, 32)))
        elif kind == 1:
            w[s, :rng.integers(1, used + 1)] = 0
        elif kind == 2:
            w[s, rng.integers(0, used):] = 0
        elif kind == 3:
            w[s, rng.integers(0, used):] = 0xFFFFFFFF
    return w


def _wrap(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Two's-complement wrap of int64 values to `bits` bits."""
    half = 1 << (bits - 1)
    return ((x + half) & ((1 << bits) - 1)) - half


def decode_segments_plain(words, nblk, lut, tsel=None, rawlen=None,
                          skip0=None, preds0=None, *, max_blocks: int):
    """decode_segments as lockstep tensor operations (any device).

    A Python loop over block slots around a loop over symbols that runs
    until every lane has finished its current block; each symbol step
    handles all S lanes at once with finished lanes masked out.  Words
    and window halves are int64 values in [0, 2**32).
    """
    if lut.dim() == 2:
        lut = lut[None]
    S, Lw = words.shape
    dev = words.device
    i64 = torch.int64
    wds = words.to(i64) & M32
    lutf = lut.reshape(-1)
    ntab = lut.shape[0]
    zz = torch.as_tensor(np.asarray(T.ZIGZAG), dtype=i64, device=dev)
    nblk = nblk.to(i64)
    bad = torch.zeros(S, dtype=torch.bool, device=dev)
    if tsel is None:
        base6 = torch.zeros(S, dtype=i64, device=dev)
    else:
        ts = tsel.to(i64)
        off = (ts < 0) | (ts >= ntab)
        bad = bad | off
        base6 = torch.where(off, 0, ts) * 6

    def refill(hi, lo, navail, widx, active):
        need = active & (navail < 32)
        w = wds.gather(1, widx.clamp(max=Lw - 1)[:, None])[:, 0]
        na = navail.clamp(0, 31)
        hi2 = hi | (w >> na)
        lo2 = lo | torch.where(navail > 0, (w << (32 - na)) & M32, 0)
        return (torch.where(need, hi2, hi), torch.where(need, lo2, lo),
                torch.where(need, navail + 32, navail),
                torch.where(need, widx + 1, widx))

    def consume(hi, lo, navail, k, take):
        """k in [0, 31]; lanes outside `take` (or with k == 0) keep theirs."""
        take = take & (k > 0)
        hi2 = ((hi << k) & M32) | (lo >> (32 - k.clamp(min=1)))
        lo2 = (lo << k) & M32
        return (torch.where(take, hi2, hi), torch.where(take, lo2, lo),
                torch.where(take, navail - k, navail))

    def step(c, row):
        hi, lo, navail, widx, kk, blk, pred, done, bad = c
        active = ~done
        hi, lo, navail, widx = refill(hi, lo, navail, widx, active)
        is_dc = kk == 0
        e = lutf[(row + (~is_dc).to(i64)) * 65536 + (hi >> 16)].to(i64)
        # an invalid window is skipped as 8 bits and flags the lane
        badsym = e < 0
        ln = torch.where(badsym, 8, e & 0xFF)
        val = torch.where(badsym, 0, e >> 8)
        dc_wide = is_dc & (val > 15)
        val = torch.where(dc_wide, 0, val)
        run = val >> 4
        s_ = val & 15
        ncat = torch.where(is_dc, val, s_)        # extra (category) bits
        # the extra bits follow the code inside the same 32-bit half
        # (ln <= 16, ncat <= 15)
        extra = ((hi << ln) & M32) >> ((32 - ncat) & 31)
        extra = torch.where(ncat == 0, 0, extra)
        # T.81 F.2.2.1 sign extension
        top = (extra >> (ncat - 1).clamp(min=0)) & 1
        v = torch.where((ncat > 0) & (top == 0),
                        extra - ((1 << ncat) - 1), extra)
        is_eob = ~is_dc & (s_ == 0) & (run != 15)
        is_zrl = ~is_dc & (s_ == 0) & (run == 15)
        dc_new = _wrap(pred + v, 32)
        kk_ac = kk + run                          # this AC's zigzag index
        ac_over = ~is_dc & (s_ > 0) & (kk_ac > 63)
        zrl_over = is_zrl & (kk + 15 > 63)   # 16 zeros past the block end
        bad = bad | (active & (badsym | dc_wide | ac_over | zrl_over))
        write = active & ~is_eob & ~is_zrl & (is_dc | (kk_ac <= 63))
        wval = torch.where(write, torch.where(is_dc, dc_new, v), 0)
        wpos = torch.where(is_dc, 0, kk_ac).clamp(max=63)
        # kk only grows within a block, so no position is written twice
        blk = blk.scatter_add(1, zz[wpos][:, None], wval[:, None])
        pred = torch.where(active & is_dc, dc_new, pred)
        kk = torch.where(
            active,
            torch.where(is_dc, 1, torch.where(is_zrl, kk + 16, kk_ac + 1)),
            kk)
        hi, lo, navail = consume(hi, lo, navail, ln + ncat, active)
        # kk > 63 ends the block; the word-index bound ends lanes that run
        # off their row on corrupt input
        done = done | (active & (is_eob | (kk > 63))) | (widx > Lw)
        return hi, lo, navail, widx, kk, blk, pred, done, bad

    zero = torch.zeros(S, dtype=i64, device=dev)
    hi, lo, navail, widx = zero, zero, zero, zero
    if skip0 is not None:
        # pre-consume the bit phase of each lane's start within its byte
        all_on = torch.ones(S, dtype=torch.bool, device=dev)
        hi, lo, navail, widx = refill(hi, lo, navail, widx, all_on)
        hi, lo, navail = consume(hi, lo, navail, skip0.to(i64) & 7, all_on)
    preds = (torch.zeros((S, 3), dtype=i64, device=dev) if preds0 is None
             else _wrap(preds0.to(i64), 32).clone())
    out = torch.zeros((S, max_blocks, 64), dtype=torch.int16, device=dev)
    for b in range(max_blocks):
        slot = b % 6                               # Y0..Y3, Cb, Cr
        comp = 0 if slot < 4 else slot - 3
        row = base6 + comp * 2                     # lane's DC row of the LUT
        c = (hi, lo, navail, widx, zero,
             torch.zeros((S, 64), dtype=i64, device=dev), preds[:, comp],
             b >= nblk, bad)
        while not bool(c[7].all()):
            c = step(c, row)
        hi, lo, navail, widx, _, blk, pred, _, bad = c
        preds[:, comp] = pred
        out[:, b] = _wrap(blk, 16).to(torch.int16)
    if rawlen is not None:
        # a valid segment's last payload bit lies in its last destuffed
        # byte: consumed in (8*(rawlen-1), 8*rawlen]
        consumed = widx * 32 - navail
        exp = rawlen.to(i64) * 8
        bad = bad | (consumed > exp) | (consumed <= exp - 8)
    return out, bad


def decode_segments(words, nblk, lut, tsel=None, rawlen=None, skip0=None,
                    preds0=None, *, max_blocks: int):
    """Decode S restart segments (or pseudo-segments) -> dense blocks.

    words: [S, Lw] int32 holding the uint32 bit patterns of the
      big-endian-packed DESTUFFED segment bytes (words_tensor), zero-padded
      (>= 4 pad bytes past the last entropy byte per row).
    nblk:  [S] int32, blocks to decode per lane (tail segments decode
      fewer; the remaining blocks stay zero).
    lut:   [T, 6, 65536] int32 ([6, 65536] accepted as T == 1), entries as
      build_decode_lut makes them.
    tsel:  [S] int32 table-set index per lane (None = set 0).
    rawlen: [S] int32 destuffed byte length per lane; when given, a final
      bit position outside the last byte sets the lane's bad flag.
    skip0: [S] int32 bits to pre-consume per lane (0..7): the bit phase of
      a pseudo-segment's start within its row's first byte.
    preds0: [S, 3] int32 initial DC predictors per lane (None = zeros, the
      restart semantics).
    max_blocks: blocks per lane in the output (restart interval * 6).

    Returns (blocks [S, max_blocks, 64] int16, natural order, DC absolute
    within each segment; bad [S] bool corruption flags).

    CUDA tensors go through the hand-written kernel
    (scan_cuda.decode_segments_cuda), CPU tensors through
    decode_segments_plain.  The choice follows the tensors' device; a
    kernel that fails to build or launch raises.
    """
    if words.is_cuda:
        from .scan_cuda import decode_segments_cuda

        return decode_segments_cuda(words, nblk, lut, tsel, rawlen, skip0,
                                    preds0, max_blocks=max_blocks)
    if words.device.type != "cpu":
        raise ValueError(f"decode_segments: unsupported device {words.device}")
    return decode_segments_plain(words, nblk, lut, tsel, rawlen, skip0,
                                 preds0, max_blocks=max_blocks)
