"""Core JPEG constant tables (ISO/IEC 10918-1 Annex K) and marker codes.

These pin the exact constants the reference uses:
  - zigzag permutation            (reference: src/jpezy.hpp:36-45)
  - Annex K.1/K.2 quant tables    (reference: src/jpezy.hpp:131-152)
  - Annex K.3-K.6 Huffman tables  (reference: src/encoder/huffman_table.hpp:27-195)
  - raw DHT segment byte blobs    (reference: src/encoder/huffman_table.hpp:199-282)
  - marker enum                   (reference: src/jpezy.hpp:47-127)

Everything here is host-side numpy; device code converts to jnp on demand.
"""
from __future__ import annotations

import enum

import numpy as np

BLOCK = 8
BLOCK_SIZE = BLOCK * BLOCK  # 64

# ---------------------------------------------------------------------------
# Zigzag: ZZ[k] = natural-order (row-major) index of the k-th zigzag element.
# reference: src/jpezy.hpp:36-45
# ---------------------------------------------------------------------------
ZIGZAG = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10,
        17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34,
        27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36,
        29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46,
        53, 60, 61, 54, 47, 55, 62, 63,
    ],
    dtype=np.int32,
)

# Inverse: NATURAL_TO_ZIGZAG[n] = zigzag position of natural index n.
NATURAL_TO_ZIGZAG = np.zeros(BLOCK_SIZE, dtype=np.int32)
NATURAL_TO_ZIGZAG[ZIGZAG] = np.arange(BLOCK_SIZE, dtype=np.int32)


# ---------------------------------------------------------------------------
# Annex K quantization tables (natural / row-major order).
# reference: src/jpezy.hpp:131-152
# ---------------------------------------------------------------------------
Y_QUANT = np.array(
    [
        16, 11, 10, 16, 24, 40, 51, 61,
        12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56,
        14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77,
        24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101,
        72, 92, 95, 98, 112, 100, 103, 99,
    ],
    dtype=np.int32,
)

C_QUANT = np.array(
    [
        17, 18, 24, 47, 99, 99, 99, 99,
        18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99,
        47, 66, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
    ],
    dtype=np.int32,
)


# ---------------------------------------------------------------------------
# Markers. reference: src/jpezy.hpp:47-127
# ---------------------------------------------------------------------------
class Marker(enum.IntEnum):
    SOF0 = 0xC0
    SOF1 = 0xC1
    SOF2 = 0xC2
    SOF3 = 0xC3
    DHT = 0xC4
    SOF5 = 0xC5
    SOF6 = 0xC6
    SOF7 = 0xC7
    JPG = 0xC8
    SOF9 = 0xC9
    SOF10 = 0xCA
    SOF11 = 0xCB
    DAC = 0xCC
    SOF13 = 0xCD
    SOF14 = 0xCE
    SOF15 = 0xCF
    RST0 = 0xD0
    RST1 = 0xD1
    RST2 = 0xD2
    RST3 = 0xD3
    RST4 = 0xD4
    RST5 = 0xD5
    RST6 = 0xD6
    RST7 = 0xD7
    SOI = 0xD8
    EOI = 0xD9
    SOS = 0xDA
    DQT = 0xDB
    DNL = 0xDC
    DRI = 0xDD
    DHP = 0xDE
    EXP = 0xDF
    APP0 = 0xE0
    APP1 = 0xE1
    APP2 = 0xE2
    APP3 = 0xE3
    APP4 = 0xE4
    APP5 = 0xE5
    APP6 = 0xE6
    APP7 = 0xE7
    APP8 = 0xE8
    APP9 = 0xE9
    APP10 = 0xEA
    APP11 = 0xEB
    APP12 = 0xEC
    APP13 = 0xED
    APP14 = 0xEE
    APP15 = 0xEF
    JPG0 = 0xF0
    JPG1 = 0xF1
    JPG2 = 0xF2
    JPG3 = 0xF3
    JPG4 = 0xF4
    JPG5 = 0xF5
    JPG6 = 0xF6
    JPG7 = 0xF7
    JPG8 = 0xF8
    JPG9 = 0xF9
    JPG10 = 0xFA
    JPG11 = 0xFB
    JPG12 = 0xFC
    JPG13 = 0xFD
    COM = 0xFE
    TEM = 0x01
    FF = 0xFF


UNSUPPORTED_SOF = frozenset(
    {
        Marker.SOF1, Marker.SOF2, Marker.SOF3, Marker.SOF5, Marker.SOF6,
        Marker.SOF7, Marker.SOF9, Marker.SOF10, Marker.SOF11, Marker.SOF13,
        Marker.SOF14, Marker.SOF15, Marker.EXP, Marker.DAC, Marker.DHP,
    }
)


# ---------------------------------------------------------------------------
# Annex K.3-K.6 Huffman code tables, in the reference's flat layout.
#
# DC tables: index = magnitude category (0..11).
# AC tables: index 0 = EOB; run r in 0..14, size s in 1..10 -> r*10+s;
#            ZRL = 151; run 15, size s -> 151+s.   (total 162 entries)
# reference: src/encoder/huffman_table.hpp:27-195
# ---------------------------------------------------------------------------
Y_DC_SIZE = np.array([2, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9], dtype=np.int32)
Y_DC_CODE = np.array(
    [0x0000, 0x0002, 0x0003, 0x0004, 0x0005, 0x0006, 0x000E, 0x001E,
     0x003E, 0x007E, 0x00FE, 0x01FE],
    dtype=np.int32,
)

C_DC_SIZE = np.array([2, 2, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], dtype=np.int32)
C_DC_CODE = np.array(
    [0x0000, 0x0001, 0x0002, 0x0006, 0x000E, 0x001E, 0x003E, 0x007E,
     0x00FE, 0x01FE, 0x03FE, 0x07FE],
    dtype=np.int32,
)

Y_AC_SIZE = np.array(
    [
        4, 2, 2, 3, 4, 5, 7, 8,
        10, 16, 16, 4, 5, 7, 9, 11,
        16, 16, 16, 16, 16, 5, 8, 10,
        12, 16, 16, 16, 16, 16, 16, 6,
        9, 12, 16, 16, 16, 16, 16, 16,
        16, 6, 10, 16, 16, 16, 16, 16,
        16, 16, 16, 7, 11, 16, 16, 16,
        16, 16, 16, 16, 16, 7, 12, 16,
        16, 16, 16, 16, 16, 16, 16, 8,
        12, 16, 16, 16, 16, 16, 16, 16,
        16, 9, 15, 16, 16, 16, 16, 16,
        16, 16, 16, 9, 16, 16, 16, 16,
        16, 16, 16, 16, 16, 9, 16, 16,
        16, 16, 16, 16, 16, 16, 16, 10,
        16, 16, 16, 16, 16, 16, 16, 16,
        16, 10, 16, 16, 16, 16, 16, 16,
        16, 16, 16, 11, 16, 16, 16, 16,
        16, 16, 16, 16, 16, 16, 16, 16,
        16, 16, 16, 16, 16, 16, 16, 11,
        16, 16, 16, 16, 16, 16, 16, 16,
        16, 16,
    ],
    dtype=np.int32,
)
Y_AC_CODE = np.array(
    [
        0x000A, 0x0000, 0x0001, 0x0004,
        0x000B, 0x001A, 0x0078, 0x00F8,
        0x03F6, 0xFF82, 0xFF83, 0x000C,
        0x001B, 0x0079, 0x01F6, 0x07F6,
        0xFF84, 0xFF85, 0xFF86, 0xFF87,
        0xFF88, 0x001C, 0x00F9, 0x03F7,
        0x0FF4, 0xFF89, 0xFF8A, 0xFF8B,
        0xFF8C, 0xFF8D, 0xFF8E, 0x003A,
        0x01F7, 0x0FF5, 0xFF8F, 0xFF90,
        0xFF91, 0xFF92, 0xFF93, 0xFF94,
        0xFF95, 0x003B, 0x03F8, 0xFF96,
        0xFF97, 0xFF98, 0xFF99, 0xFF9A,
        0xFF9B, 0xFF9C, 0xFF9D, 0x007A,
        0x07F7, 0xFF9E, 0xFF9F, 0xFFA0,
        0xFFA1, 0xFFA2, 0xFFA3, 0xFFA4,
        0xFFA5, 0x007B, 0x0FF6, 0xFFA6,
        0xFFA7, 0xFFA8, 0xFFA9, 0xFFAA,
        0xFFAB, 0xFFAC, 0xFFAD, 0x00FA,
        0x0FF7, 0xFFAE, 0xFFAF, 0xFFB0,
        0xFFB1, 0xFFB2, 0xFFB3, 0xFFB4,
        0xFFB5, 0x01F8, 0x7FC0, 0xFFB6,
        0xFFB7, 0xFFB8, 0xFFB9, 0xFFBA,
        0xFFBB, 0xFFBC, 0xFFBD, 0x01F9,
        0xFFBE, 0xFFBF, 0xFFC0, 0xFFC1,
        0xFFC2, 0xFFC3, 0xFFC4, 0xFFC5,
        0xFFC6, 0x01FA, 0xFFC7, 0xFFC8,
        0xFFC9, 0xFFCA, 0xFFCB, 0xFFCC,
        0xFFCD, 0xFFCE, 0xFFCF, 0x03F9,
        0xFFD0, 0xFFD1, 0xFFD2, 0xFFD3,
        0xFFD4, 0xFFD5, 0xFFD6, 0xFFD7,
        0xFFD8, 0x03FA, 0xFFD9, 0xFFDA,
        0xFFDB, 0xFFDC, 0xFFDD, 0xFFDE,
        0xFFDF, 0xFFE0, 0xFFE1, 0x07F8,
        0xFFE2, 0xFFE3, 0xFFE4, 0xFFE5,
        0xFFE6, 0xFFE7, 0xFFE8, 0xFFE9,
        0xFFEA, 0xFFEB, 0xFFEC, 0xFFED,
        0xFFEE, 0xFFEF, 0xFFF0, 0xFFF1,
        0xFFF2, 0xFFF3, 0xFFF4, 0x07F9,
        0xFFF5, 0xFFF6, 0xFFF7, 0xFFF8,
        0xFFF9, 0xFFFA, 0xFFFB, 0xFFFC,
        0xFFFD, 0xFFFE,
    ],
    dtype=np.int64,
).astype(np.int32)

C_AC_SIZE = np.array(
    [
        2, 2, 3, 4, 5, 5, 6, 7,
        9, 10, 12, 4, 6, 8, 9, 11,
        12, 16, 16, 16, 16, 5, 8, 10,
        12, 15, 16, 16, 16, 16, 16, 5,
        8, 10, 12, 16, 16, 16, 16, 16,
        16, 6, 9, 16, 16, 16, 16, 16,
        16, 16, 16, 6, 10, 16, 16, 16,
        16, 16, 16, 16, 16, 7, 11, 16,
        16, 16, 16, 16, 16, 16, 16, 7,
        11, 16, 16, 16, 16, 16, 16, 16,
        16, 8, 16, 16, 16, 16, 16, 16,
        16, 16, 16, 9, 16, 16, 16, 16,
        16, 16, 16, 16, 16, 9, 16, 16,
        16, 16, 16, 16, 16, 16, 16, 9,
        16, 16, 16, 16, 16, 16, 16, 16,
        16, 9, 16, 16, 16, 16, 16, 16,
        16, 16, 16, 11, 16, 16, 16, 16,
        16, 16, 16, 16, 16, 14, 16, 16,
        16, 16, 16, 16, 16, 16, 16, 10,
        15, 16, 16, 16, 16, 16, 16, 16,
        16, 16,
    ],
    dtype=np.int32,
)
C_AC_CODE = np.array(
    [
        0x0000, 0x0001, 0x0004, 0x000A,
        0x0018, 0x0019, 0x0038, 0x0078,
        0x01F4, 0x03F6, 0x0FF4, 0x000B,
        0x0039, 0x00F6, 0x01F5, 0x07F6,
        0x0FF5, 0xFF88, 0xFF89, 0xFF8A,
        0xFF8B, 0x001A, 0x00F7, 0x03F7,
        0x0FF6, 0x7FC2, 0xFF8C, 0xFF8D,
        0xFF8E, 0xFF8F, 0xFF90, 0x001B,
        0x00F8, 0x03F8, 0x0FF7, 0xFF91,
        0xFF92, 0xFF93, 0xFF94, 0xFF95,
        0xFF96, 0x003A, 0x01F6, 0xFF97,
        0xFF98, 0xFF99, 0xFF9A, 0xFF9B,
        0xFF9C, 0xFF9D, 0xFF9E, 0x003B,
        0x03F9, 0xFF9F, 0xFFA0, 0xFFA1,
        0xFFA2, 0xFFA3, 0xFFA4, 0xFFA5,
        0xFFA6, 0x0079, 0x07F7, 0xFFA7,
        0xFFA8, 0xFFA9, 0xFFAA, 0xFFAB,
        0xFFAC, 0xFFAD, 0xFFAE, 0x007A,
        0x07F8, 0xFFAF, 0xFFB0, 0xFFB1,
        0xFFB2, 0xFFB3, 0xFFB4, 0xFFB5,
        0xFFB6, 0x00F9, 0xFFB7, 0xFFB8,
        0xFFB9, 0xFFBA, 0xFFBB, 0xFFBC,
        0xFFBD, 0xFFBE, 0xFFBF, 0x01F7,
        0xFFC0, 0xFFC1, 0xFFC2, 0xFFC3,
        0xFFC4, 0xFFC5, 0xFFC6, 0xFFC7,
        0xFFC8, 0x01F8, 0xFFC9, 0xFFCA,
        0xFFCB, 0xFFCC, 0xFFCD, 0xFFCE,
        0xFFCF, 0xFFD0, 0xFFD1, 0x01F9,
        0xFFD2, 0xFFD3, 0xFFD4, 0xFFD5,
        0xFFD6, 0xFFD7, 0xFFD8, 0xFFD9,
        0xFFDA, 0x01FA, 0xFFDB, 0xFFDC,
        0xFFDD, 0xFFDE, 0xFFDF, 0xFFE0,
        0xFFE1, 0xFFE2, 0xFFE3, 0x07F9,
        0xFFE4, 0xFFE5, 0xFFE6, 0xFFE7,
        0xFFE8, 0xFFE9, 0xFFEA, 0xFFEB,
        0xFFEC, 0x3FE0, 0xFFED, 0xFFEE,
        0xFFEF, 0xFFF0, 0xFFF1, 0xFFF2,
        0xFFF3, 0xFFF4, 0xFFF5, 0x03FA,
        0x7FC3, 0xFFF6, 0xFFF7, 0xFFF8,
        0xFFF9, 0xFFFA, 0xFFFB, 0xFFFC,
        0xFFFD, 0xFFFE,
    ],
    dtype=np.int64,
).astype(np.int32)

EOB_INDEX = 0    # reference: src/encoder/huffman_table.hpp:122,194
ZRL_INDEX = 151  # reference: src/encoder/huffman_table.hpp:123,195


def ac_symbol_index(run: int, size: int) -> int:
    """Flat AC table index for (run, size), reference layout.

    reference: src/encoder/jpezy_encoder.hpp:206 (run*10 + s + (run==15))
    """
    return run * 10 + size + (1 if run == 15 else 0)


# ---------------------------------------------------------------------------
# DHT segments: BITS (16 length counts) + HUFFVAL, per Annex K.3-K.6.
# The reference stores them as raw byte blobs including the 0xFFC4 marker and
# length; we store (table_class, table_id, bits, huffval) and serialize.
# reference: src/encoder/huffman_table.hpp:199-282
# ---------------------------------------------------------------------------
DC_LUMA_BITS = bytes(
    [0x00, 0x01, 0x05, 0x01, 0x01, 0x01, 0x01, 0x01,
     0x01, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00]
)
DC_LUMA_VALS = bytes(range(12))

DC_CHROMA_BITS = bytes(
    [0x00, 0x03, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01,
     0x01, 0x01, 0x01, 0x00, 0x00, 0x00, 0x00, 0x00]
)
DC_CHROMA_VALS = bytes(range(12))

AC_LUMA_BITS = bytes(
    [0x00, 0x02, 0x01, 0x03, 0x03, 0x02, 0x04, 0x03,
     0x05, 0x05, 0x04, 0x04, 0x00, 0x00, 0x01, 0x7D]
)
AC_LUMA_VALS = bytes(
    [
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
        0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
        0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
        0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
        0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
        0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
        0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
        0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
        0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
        0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
        0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
        0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
        0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
        0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
        0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
        0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
        0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
        0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
        0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
        0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
        0xF9, 0xFA,
    ]
)

AC_CHROMA_BITS = bytes(
    [0x00, 0x02, 0x01, 0x02, 0x04, 0x04, 0x03, 0x04,
     0x07, 0x05, 0x04, 0x04, 0x00, 0x01, 0x02, 0x77]
)
AC_CHROMA_VALS = bytes(
    [
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
        0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
        0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
        0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
        0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
        0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
        0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
        0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
        0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
        0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
        0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
        0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
        0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
        0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
        0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
        0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
        0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
        0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
        0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
        0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
        0xF9, 0xFA,
    ]
)


def scale_quant_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """libjpeg-style quality scaling of the Annex K tables (extension; the
    reference always uses the unscaled tables).

    quality 50 returns the Annex K tables unchanged; 1 = coarsest,
    100 = finest.  Entries clamp to [1, 255] (8-bit DQT).
    """
    if not 1 <= quality <= 100:
        raise ValueError("quality must be in 1..100")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    def s(tbl):
        out = (tbl.astype(np.int64) * scale + 50) // 100
        return np.clip(out, 1, 255).astype(np.int32)
    return s(Y_QUANT), s(C_QUANT)


def optimal_huffman_table(freq: np.ndarray) -> tuple[bytes, bytes]:
    """Derive optimal Huffman code lengths from symbol frequencies.

    T.81 Annex K.2 procedure (the libjpeg `-optimize` analog; an extension --
    the reference only ever uses the fixed Annex K.3-K.6 tables): pair-merge
    by lowest frequency, limit code lengths to 16 bits, and reserve one
    pseudo-symbol so no real symbol is assigned the all-ones codeword.

    freq: [256] counts.  Returns (bits [16] bytes, huffval bytes) for a DHT
    segment; huffval lists symbols by ascending code length then value.
    """
    MAX_CLEN = 32
    f = np.zeros(257, dtype=np.int64)
    f[:256] = np.asarray(freq, dtype=np.int64)
    if not f[:256].any():
        raise ValueError("optimal_huffman_table: all symbol frequencies zero")
    f[256] = 1  # reserved: claims the all-ones code (T.81 K.2 note)
    codesize = np.zeros(257, dtype=np.int64)
    others = np.full(257, -1, dtype=np.int64)

    while True:
        # two least-frequent chains; ties pick the larger symbol value
        c1 = c2 = -1
        v1 = v2 = np.iinfo(np.int64).max
        for i in range(257):
            if f[i] == 0:
                continue
            if f[i] <= v1:
                v1 = f[i]
                c1 = i
        for i in range(257):
            if f[i] == 0 or i == c1:
                continue
            if f[i] <= v2:
                v2 = f[i]
                c2 = i
        if c2 < 0:
            break
        f[c1] += f[c2]
        f[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1

    bits = np.zeros(MAX_CLEN + 1, dtype=np.int64)
    for i in range(257):
        if codesize[i]:
            if codesize[i] > MAX_CLEN:
                # only pathological (Fibonacci-like) frequency sets over
                # astronomically large inputs can get here (libjpeg ERREXITs)
                raise ValueError(
                    "optimal_huffman_table: code length exceeds 32 bits")
            bits[codesize[i]] += 1

    # limit code lengths to 16 bits (T.81 K.2 "Adjust_BITS")
    for i in range(MAX_CLEN, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # drop the reserved pseudo-symbol

    huffval = bytes(
        sym
        for size in range(1, MAX_CLEN + 1)
        for sym in range(256)
        if codesize[sym] == size
    )
    return bytes(int(b) for b in bits[1:17]), huffval


def optimal_flat_tables(dc_freq: np.ndarray, ac_freq: np.ndarray):
    """Optimal tables in the encoder's flat lookup layouts.

    Returns ((dc_bits, dc_vals), (ac_bits, ac_vals),
             dc_size [12], dc_code [12], ac_size [162], ac_code [162])
    where the flat arrays are indexed by DC category / ac_symbol_index.
    """
    dc_bits, dc_vals = optimal_huffman_table(dc_freq)
    ac_bits, ac_vals = optimal_huffman_table(ac_freq)
    dsz, dcd = build_canonical_codes(dc_bits)
    dc_size = np.zeros(12, dtype=np.int32)
    dc_code = np.zeros(12, dtype=np.int32)
    for v, size, code in zip(dc_vals, dsz, dcd):
        dc_size[v] = size
        dc_code[v] = code
    asz, acd = build_canonical_codes(ac_bits)
    ac_size, ac_code = huffval_to_flat_ac(ac_vals, asz, acd)
    return (dc_bits, dc_vals), (ac_bits, ac_vals), dc_size, dc_code, ac_size, ac_code


def dht_segment(table_class: int, table_id: int, bits: bytes, vals: bytes) -> bytes:
    """Serialize one DHT segment (marker + length + Tc/Th + BITS + HUFFVAL).

    Byte-compatible with the reference's raw blobs
    (src/encoder/huffman_table.hpp:205-282).
    """
    payload = bytes([(table_class << 4) | table_id]) + bits + vals
    length = len(payload) + 2
    return bytes([0xFF, Marker.DHT, length >> 8, length & 0xFF]) + payload


def build_canonical_codes(bits: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Build canonical Huffman (sizes, codes) from the 16 BITS counts.

    Mirrors the decoder's canonical reconstruction
    (reference: src/decoder/jpezy_decoder.hpp:223-239): codes of the same
    length increment by 1; on a length change the code is left-shifted.

    Returns (sizes[n], codes[n]) aligned with HUFFVAL order.
    """
    sizes = []
    for length_minus_1, count in enumerate(bits):
        sizes.extend([length_minus_1 + 1] * count)
    sizes = np.asarray(sizes, dtype=np.int32)
    codes = np.zeros_like(sizes)
    code = 0
    prev_size = sizes[0] if len(sizes) else 0
    for k, size in enumerate(sizes):
        while prev_size != size:
            code <<= 1
            prev_size += 1
        codes[k] = code
        code += 1
    return sizes, codes


def huffval_to_flat_ac(
    huffval: bytes, sizes: np.ndarray, codes: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Scatter canonical (size, code) pairs into the flat 162-entry AC layout
    keyed by ac_symbol_index(run, size)."""
    flat_size = np.zeros(162, dtype=np.int32)
    flat_code = np.zeros(162, dtype=np.int32)
    for v, size, code in zip(huffval, sizes, codes):
        run, s = v >> 4, v & 0xF
        idx = ac_symbol_index(run, s)
        flat_size[idx] = size
        flat_code[idx] = code
    return flat_size, flat_code
