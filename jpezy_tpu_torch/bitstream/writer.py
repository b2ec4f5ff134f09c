"""JFIF segment writer + entropy bit packing (host side).

Header serialization is byte-compatible with the reference's jpezy_writer
(src/encoder/jpezy_writer.hpp:20-94): same segment order (SOI, APP0, COM, DQT x2,
DHT x4, SOF0, SOS), same quirks kept deliberately for compatibility:
  - component ids 0,1,2 in SOF0/SOS (jpezy_writer.hpp:74-90)
  - DQT values serialized in zigzag order (jpezy_writer.hpp:50-57)
  - COM segment includes a trailing NUL (jpezy_writer.hpp:42-43)

The entropy packer replaces the reference's serial bit cursor
(srook bofstream ``Bits(n)``, call sites jpezy_encoder.hpp:189-220) with a
vectorized pack: all (code, length) emissions are laid out in order, expanded
to a bit matrix, masked, packed with numpy, 1-padded, and byte-stuffed.
"""
from __future__ import annotations

import numpy as np

from ..core import tables as T
from ..core.props import ImageProps

MAX_CODE_BITS = 16


def _word(v: int) -> bytes:
    return bytes([(v >> 8) & 0xFF, v & 0xFF])


def _marker(m: int) -> bytes:
    return bytes([0xFF, m])


def write_header(pr: ImageProps, restart_interval: int = 0,
                 quant_tables=None, huff_tables=None) -> bytes:
    """Serialize SOI..SOS headers for the fixed 4:2:0 Annex-K encoder.

    restart_interval > 0 inserts a DRI segment before SOS (extension; the
    reference never emits one, README.md:33).  quant_tables overrides the
    (luma, chroma) quantization tables (extension: quality scaling).
    huff_tables overrides the four DHT segments (extension: per-image
    optimal tables): ((dc0_bits, dc0_vals), (dc1_bits, dc1_vals),
    (ac0_bits, ac0_vals), (ac1_bits, ac1_vals)).
    """
    out = bytearray()
    # SOI (jpezy_writer.hpp:26)
    out += _marker(T.Marker.SOI)

    # APP0 / JFIF (jpezy_writer.hpp:29-37)
    out += _marker(T.Marker.APP0)
    out += _word(16)
    out += b"JFIF\x00"
    out += bytes([pr.major_rev, pr.minor_rev])
    out += bytes([int(pr.units)])
    out += _word(pr.h_density)
    out += _word(pr.v_density)
    out += bytes([pr.h_thumbnail, pr.v_thumbnail])

    # COM (jpezy_writer.hpp:40-44): length = len+3, data = comment + NUL
    if pr.comment:
        com = pr.comment.encode("latin-1")
        out += _marker(T.Marker.COM)
        out += _word(len(com) + 3)
        out += com + b"\x00"

    # DQT x2, values in zigzag order (jpezy_writer.hpp:47-58)
    yq, cq = quant_tables if quant_tables is not None else (T.Y_QUANT, T.C_QUANT)
    for table_id, qt in ((0, yq), (1, cq)):
        out += _marker(T.Marker.DQT)
        out += _word(67)
        out += bytes([table_id])
        out += bytes(int(qt[T.ZIGZAG[i]]) for i in range(64))

    # DHT x4 (jpezy_writer.hpp:61-64)
    if huff_tables is None:
        out += T.dht_segment(0, 0, T.DC_LUMA_BITS, T.DC_LUMA_VALS)
        out += T.dht_segment(0, 1, T.DC_CHROMA_BITS, T.DC_CHROMA_VALS)
        out += T.dht_segment(1, 0, T.AC_LUMA_BITS, T.AC_LUMA_VALS)
        out += T.dht_segment(1, 1, T.AC_CHROMA_BITS, T.AC_CHROMA_VALS)
    else:
        dc0, dc1, ac0, ac1 = huff_tables
        out += T.dht_segment(0, 0, *dc0)
        out += T.dht_segment(0, 1, *dc1)
        out += T.dht_segment(1, 0, *ac0)
        out += T.dht_segment(1, 1, *ac1)

    # SOF0 (jpezy_writer.hpp:67-81) -- component ids 0,1,2; sampling 0x22/0x11
    dim = pr.dimension
    out += _marker(T.Marker.SOF0)
    out += _word(3 * dim + 8)
    out += bytes([pr.sample_precision])
    out += _word(pr.height)
    out += _word(pr.width)
    out += bytes([dim])
    out += bytes([0, 0x22, 0])
    for i in range(1, dim):
        out += bytes([i, 0x11, 1])

    if restart_interval:
        out += _marker(T.Marker.DRI)
        out += _word(4)
        out += _word(restart_interval)

    # SOS (jpezy_writer.hpp:84-93)
    out += _marker(T.Marker.SOS)
    out += _word(2 * dim + 6)
    out += bytes([dim])
    for i in range(dim):
        out += bytes([i, 0x00 if i == 0 else 0x11])
    out += bytes([0, 63, 0])

    return bytes(out)


EOI = _marker(T.Marker.EOI)


def dri_segment(restart_interval: int) -> bytes:
    """DRI marker segment (T.81 B.2.4.4)."""
    return _marker(T.Marker.DRI) + _word(4) + _word(restart_interval)


def pack_bits(
    codes: np.ndarray, lengths: np.ndarray, max_bits: int = MAX_CODE_BITS
) -> tuple[bytes, int]:
    """Pack (code, length) emissions MSB-first into bytes.

    ``codes[i]``'s low ``lengths[i]`` bits are emitted in order.  The final
    partial byte is padded with 1-bits (T.81 F.1.2.3).  Returns
    (packed bytes WITHOUT stuffing, total payload bit count).
    ``max_bits``: maximum emission length (16 for raw codes, 32 for
    pre-merged emission words).
    """
    codes = np.ascontiguousarray(codes, dtype=np.uint32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    total = int(lengths.sum())
    if total == 0:
        return b"", 0
    # bit j of row i (MSB first): (code >> (len-1-j)) & 1, valid when j < len
    j = np.arange(max_bits, dtype=np.int32)
    shifts = lengths[:, None] - 1 - j[None, :]
    valid = shifts >= 0
    bits = (codes[:, None] >> np.minimum(np.maximum(shifts, 0), 31).astype(np.uint32)) & 1
    flat = bits[valid].astype(np.uint8)  # C-order mask selection == emission order
    pad = (-total) % 8
    if pad:
        flat = np.concatenate([flat, np.ones(pad, dtype=np.uint8)])
    return np.packbits(flat).tobytes(), total


def byte_stuff(entropy: bytes) -> bytes:
    """Insert 0x00 after every 0xFF in entropy-coded data (T.81 B.1.1.5)."""
    arr = np.frombuffer(entropy, dtype=np.uint8)
    ff = np.nonzero(arr == 0xFF)[0]
    if len(ff) == 0:
        return entropy
    try:
        from ..runtime import native

        return native.byte_stuff(entropy)
    except ImportError:
        return np.insert(arr, ff + 1, 0).tobytes()


def assemble(header: bytes, entropy_packed: bytes) -> bytes:
    """Header + stuffed entropy + EOI."""
    return header + byte_stuff(entropy_packed) + EOI
