"""JPEG marker/header parser (host side).

Mirrors the reference decoder's header analysis
(src/decoder/jpezy_decoder.hpp:171-502): SOI scan, per-marker dispatch until
SOS, DHT canonical code reconstruction (:223-239), DQT de-zigzag on read
(:258-277), SOF0 (:279-305), SOS (:307-334), APP0 JFIF/JFXX (:336-358,422-448),
DRI (:400-404), DNL (:379-384), COM (:405-410).

Deliberately NOT replicated (reference quirk ledger, SURVEY.md):
  - unsupported SOF markers raise here (the reference constructs the exception
    but forgets to throw, jpezy_decoder.hpp:420)
  - Td/Ta are validated <= 1 per T.81 baseline (reference laxly allows <= 2,
    jpezy_decoder.hpp:319-322)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import tables as T
from ..core.props import Analyzed, ExtensionCode, Format, ImageProps, Units


class JpegFormatError(ValueError):
    pass


@dataclasses.dataclass
class FrameComponent:
    C: int = 0   # component id
    H: int = 1
    V: int = 1
    Tq: int = 0


@dataclasses.dataclass
class ScanComponent:
    Cs: int = 0
    Td: int = 0
    Ta: int = 0


@dataclasses.dataclass
class HuffTable:
    sizes: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    codes: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))
    values: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0, np.int32))

    @property
    def n(self) -> int:
        return len(self.sizes)


@dataclasses.dataclass
class ParsedJpeg:
    props: ImageProps
    quant: np.ndarray                 # [4, 64] natural order
    huff: list[list[HuffTable]]       # [tc][th], tc 0=DC 1=AC
    frame_components: list[FrameComponent]
    scan_components: list[ScanComponent]
    restart_interval: int
    entropy_start: int                # byte offset of entropy-coded data
    data: bytes                       # full file bytes

    @property
    def hmax(self) -> int:
        return max(fc.H for fc in self.frame_components)

    @property
    def vmax(self) -> int:
        return max(fc.V for fc in self.frame_components)


def _u16(data: bytes, off: int) -> int:
    return (data[off] << 8) | data[off + 1]


def parse_dht_payload(payload: bytes) -> list[tuple[int, int, HuffTable]]:
    """Parse one DHT segment payload (may hold several tables).

    Canonical reconstruction per reference jpezy_decoder.hpp:223-239.
    """
    out = []
    off = 0
    while off < len(payload):
        tc_th = payload[off]
        tc, th = tc_th >> 4, tc_th & 0x0F
        if tc > 1:
            raise JpegFormatError("DHT: table class > 1")
        if th > 3:
            raise JpegFormatError("DHT: table id > 3")
        bits = payload[off + 1 : off + 17]
        n = sum(bits)
        sizes, codes = T.build_canonical_codes(bits)
        values = np.frombuffer(payload[off + 17 : off + 17 + n], dtype=np.uint8)
        if len(values) != n:
            raise JpegFormatError("DHT: truncated HUFFVAL")
        out.append((tc, th, HuffTable(sizes, codes, values.astype(np.int32))))
        off += 17 + n
    return out


def parse(data: bytes) -> ParsedJpeg:
    """Parse markers up to (and including) SOS; return tables + entropy offset."""
    props = ImageProps()
    quant = np.zeros((4, 64), dtype=np.int32)
    huff: list[list[HuffTable]] = [[HuffTable() for _ in range(4)] for _ in range(2)]
    fcomp: list[FrameComponent] = []
    scomp: list[ScanComponent] = []
    restart_interval = 0

    n = len(data)
    # scan for SOI (reference jpezy_decoder.hpp:177-180)
    off = 0
    while True:
        if off + 1 >= n:
            raise JpegFormatError("no SOI marker")
        if data[off] == 0xFF and data[off + 1] == T.Marker.SOI:
            off += 2
            break
        off += 1

    while True:
        # find next marker (skip fill bytes; reference get_marker :486-502)
        while off < n and data[off] != 0xFF:
            off += 1
        while off < n and data[off] == 0xFF:
            off += 1
        if off >= n:
            raise JpegFormatError("EOF before SOS")
        mark = data[off]
        off += 1
        if mark == 0:
            continue  # stuffed byte, not a marker

        if mark == T.Marker.SOS:
            length = _u16(data, off)
            seg = data[off + 2 : off + length]
            ns = seg[0]
            p = 1
            for _ in range(ns):
                cs = seg[p]
                c = seg[p + 1]
                td, ta = c >> 4, c & 0x0F
                if td > 1 or ta > 1:
                    raise JpegFormatError("SOS: non-baseline huffman table id")
                scomp.append(ScanComponent(cs, td, ta))
                p += 2
            # spectral selection + Ah/Al parsed but unused for sequential DCT
            # (reference jpezy_decoder.hpp:326-333)
            props.decodable |= Analyzed.START_DATA
            off += length
            return ParsedJpeg(
                props, quant, huff, fcomp, scomp, restart_interval, off, data
            )

        if mark == T.Marker.EOI:
            raise JpegFormatError("EOI before SOS")

        if mark in (0x01, *range(0xD0, 0xD8)):  # TEM / RSTn: parameterless
            continue

        if off + 1 >= n:
            raise JpegFormatError("truncated segment")
        length = _u16(data, off)
        seg = data[off + 2 : off + length]

        if mark == T.Marker.SOF0:
            props.sample_precision = seg[0]
            props.height = (seg[1] << 8) | seg[2]
            props.width = (seg[3] << 8) | seg[4]
            props.dimension = seg[5]
            if props.dimension not in (1, 3):
                raise JpegFormatError("unsupported component count")
            p = 6
            for _ in range(props.dimension):
                fc = FrameComponent(C=seg[p], H=seg[p + 1] >> 4, V=seg[p + 1] & 0xF,
                                    Tq=seg[p + 2])
                if fc.H < 1 or fc.V < 1 or fc.H > 4 or fc.V > 4:
                    raise JpegFormatError("bad sampling factor")
                fcomp.append(fc)
                p += 3
        elif mark == T.Marker.DHT:
            for tc, th, tbl in parse_dht_payload(seg):
                huff[tc][th] = tbl
            props.decodable |= Analyzed.HTABLE
        elif mark == T.Marker.DQT:
            # de-zigzag on read (reference jpezy_decoder.hpp:267-275)
            p = 0
            while p < len(seg):
                pq_tq = seg[p]
                tq = pq_tq & 0x3
                if pq_tq >> 4:
                    vals = np.frombuffer(seg[p + 1 : p + 129], ">u2").astype(np.int32)
                    p += 129
                else:
                    vals = np.frombuffer(seg[p + 1 : p + 65], np.uint8).astype(np.int32)
                    p += 65
                quant[tq, T.ZIGZAG] = vals
            props.decodable |= Analyzed.QTABLE
        elif mark == T.Marker.DRI:
            restart_interval = (seg[0] << 8) | seg[1]
        elif mark == T.Marker.DNL:
            props.height = (seg[0] << 8) | seg[1]
        elif mark == T.Marker.COM:
            com = seg
            if com.endswith(b"\x00"):
                com = com[:-1]
            props.comment = com.decode("latin-1", errors="replace")
            props.decodable |= Analyzed.COMMENT
        elif mark == T.Marker.APP0:
            if seg[:5] == b"JFIF\x00":
                props.format = Format.JFIF
                props.major_rev = seg[5]
                props.minor_rev = seg[6]
                try:
                    props.units = Units(seg[7])
                except ValueError:
                    props.units = Units.UNDEFINED
                props.h_density = (seg[8] << 8) | seg[9]
                props.v_density = (seg[10] << 8) | seg[11]
                props.h_thumbnail = seg[12]
                props.v_thumbnail = seg[13]
                props.decodable |= Analyzed.JFIF
            elif seg[:5] == b"JFXX\x00":
                props.format = Format.JFXX
                try:
                    props.extension_code = ExtensionCode(seg[5])
                except ValueError:
                    props.extension_code = ExtensionCode.UNDEFINED
        elif mark in T.UNSUPPORTED_SOF:
            raise JpegFormatError(f"unsupported SOF marker 0x{mark:02x}")
        # APPn / JPGn / others: skip (reference :451-462)
        off += length


def split_entropy_segments(data: bytes, start: int) -> tuple[list[bytes], int]:
    """Split entropy-coded data into RST-delimited segments, de-stuffed.

    Returns (segments, end_offset). Each segment has 0xFF00 -> 0xFF applied.
    Scanning stops at any non-RST marker (normally EOI).
    """
    arr = np.frombuffer(data, dtype=np.uint8)
    segments: list[bytes] = []
    seg_start = start
    i = start
    n = len(arr)
    ff = np.nonzero(arr[start:] == 0xFF)[0] + start

    cur_parts: list[np.ndarray] = []
    prev = seg_start

    def flush_segment(end: int) -> None:
        cur_parts.append(arr[prev:end])
        segments.append(np.concatenate(cur_parts).tobytes() if cur_parts else b"")

    for i in ff:
        if i + 1 >= n:
            break
        nxt = arr[i + 1]
        if nxt == 0x00:
            # stuffed: keep the 0xFF, drop the 0x00
            cur_parts.append(arr[prev : i + 1])
            prev = i + 2
        elif 0xD0 <= nxt <= 0xD7:
            # restart marker: close segment, start a new one
            flush_segment(i)
            cur_parts = []
            prev = i + 2
        else:
            # real marker terminates entropy data
            flush_segment(i)
            return segments, int(i)
    flush_segment(n)
    return segments, n


def check_decodable(pj: ParsedJpeg) -> None:
    """The reference's pre-scan gate (jpezy_decoder.hpp:89): Huffman tables,
    quant tables and a scan header must all have been seen."""
    need = Analyzed.HTABLE | Analyzed.QTABLE | Analyzed.START_DATA
    if (pj.props.decodable & need) != need:
        missing = [f.name for f in (Analyzed.HTABLE, Analyzed.QTABLE,
                                    Analyzed.START_DATA)
                   if not (pj.props.decodable & f)]
        raise ValueError(f"stream not decodable: missing {missing}")
