"""Cross-block bitstring splice (host side, numpy-vectorized).

Device entropy encode produces per-block packed words + bit lengths
(jpezy_tpu.ops.entropy.pack_block_words).  Concatenating them needs
byte/bit-granular shifts at data-dependent offsets -- host work, like the
reference's buffered stream flush (srook bofstream, SURVEY.md section 2.5).
Vectorized: shift every block's words right by its global bit phase and
scatter-add into the output word array (adjacent blocks only ever share
disjoint bits of a boundary word, so add == or).
"""
from __future__ import annotations

import numpy as np


def splice_blocks(words: np.ndarray, bits: np.ndarray) -> tuple[bytes, int]:
    """words: [B, W] uint32 MSB-first per-block streams; bits: [B] lengths.

    Returns (packed bytes, total bit count), final partial byte 1-padded
    (T.81 F.1.2.3).  Uses the C++ runtime when available.
    """
    try:
        from ..runtime import native

        return native.splice_bits(words, bits)
    except ImportError:
        pass
    return splice_blocks_numpy(words, bits)


def splice_blocks_numpy(words: np.ndarray, bits: np.ndarray) -> tuple[bytes, int]:
    """Pure-numpy splice (fallback + differential-testing reference)."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    bits = np.ascontiguousarray(bits, dtype=np.int64)
    B, W = words.shape
    goff = np.concatenate([[0], np.cumsum(bits)])
    total = int(goff[-1])
    if total == 0:
        return b"", 0
    r = (goff[:-1] & 31).astype(np.uint32)          # per-block bit phase
    q = (goff[:-1] >> 5).astype(np.int64)           # per-block word offset
    # every block contributes W+1 (zero-padded) words starting at its q
    nwords_out = int(q.max()) + W + 2

    # shift each block's words right by r: produces W+1 words per block
    ext = np.concatenate([np.zeros((B, 1), np.uint32), words], axis=1)  # [B, W+1]
    rr = r[:, None]
    with np.errstate(over="ignore"):
        shifted = np.where(
            rr > 0,
            (ext[:, 1:] >> rr) | (ext[:, :-1] << (32 - np.where(rr > 0, rr, 1))),
            ext[:, 1:],
        )
        carry_last = np.where(r > 0, words[:, -1] << (32 - np.where(r > 0, r, 1)),
                              0).astype(np.uint32)
    contrib = np.concatenate([shifted, carry_last[:, None]], axis=1)  # [B, W+1]

    out = np.zeros(nwords_out, dtype=np.uint64)
    idx = q[:, None] + np.arange(W + 1)[None, :]
    np.add.at(out, idx.ravel(), contrib.ravel().astype(np.uint64))
    out32 = out.astype(np.uint32)

    # 1-pad to byte boundary
    used = total
    pad = (-used) % 8
    if pad:
        wi, bi = used >> 5, used & 31
        mask = ((1 << pad) - 1) << (32 - bi - pad)
        out32[wi] |= np.uint32(mask)
        used += pad
    nbytes = used // 8
    return out32.byteswap().tobytes()[:nbytes], total
