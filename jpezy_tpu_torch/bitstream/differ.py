"""Marker-level JPEG bitstream differ (debugging / parity tooling).

Splits two JPEG files into marker segments and reports the first divergence
at segment granularity, then byte granularity within the segment.  The
SURVEY test-strategy analog of a structural diff for golden-stream tests.
"""
from __future__ import annotations

import dataclasses

from ..core.tables import Marker

_NAMES = {m.value: m.name for m in Marker}


@dataclasses.dataclass
class Segment:
    marker: int
    name: str
    offset: int
    payload: bytes  # excluding the 2 marker bytes and length field


def segment_list(data: bytes) -> list[Segment]:
    """Split a JPEG byte stream into marker segments.

    Entropy-coded data between SOS and the next marker becomes a synthetic
    'SCAN' segment.
    """
    segs: list[Segment] = []
    i = 0
    n = len(data)
    while i + 1 < n:
        if data[i] != 0xFF:
            i += 1
            continue
        code = data[i + 1]
        if code in (0x00, 0xFF):
            i += 1
            continue
        name = _NAMES.get(code, f"0x{code:02x}")
        if code in (Marker.SOI, Marker.EOI, 0x01) or 0xD0 <= code <= 0xD7:
            segs.append(Segment(code, name, i, b""))
            i += 2
            if code == Marker.EOI:
                break
            continue
        if i + 3 >= n:
            break
        length = (data[i + 2] << 8) | data[i + 3]
        segs.append(Segment(code, name, i, data[i + 4 : i + 2 + length]))
        i += 2 + length
        if code == Marker.SOS:
            # collect entropy data up to the next real marker
            start = i
            while i + 1 < n:
                if data[i] == 0xFF and data[i + 1] not in (0x00,) and \
                   not (0xD0 <= data[i + 1] <= 0xD7):
                    break
                i += 1
            segs.append(Segment(-1, "SCAN", start, data[start:i]))
    return segs


def diff(a: bytes, b: bytes) -> list[str]:
    """Human-readable structural diff; empty list means identical."""
    sa, sb = segment_list(a), segment_list(b)
    out: list[str] = []
    for k in range(max(len(sa), len(sb))):
        if k >= len(sa):
            out.append(f"[{k}] only in B: {sb[k].name}")
            continue
        if k >= len(sb):
            out.append(f"[{k}] only in A: {sa[k].name}")
            continue
        x, y = sa[k], sb[k]
        if x.name != y.name:
            out.append(f"[{k}] marker differs: A={x.name} B={y.name}")
            continue
        if x.payload != y.payload:
            # first differing byte
            m = min(len(x.payload), len(y.payload))
            at = next(
                (j for j in range(m) if x.payload[j] != y.payload[j]), m
            )
            out.append(
                f"[{k}] {x.name} payload differs at byte {at} "
                f"(lenA={len(x.payload)} lenB={len(y.payload)})"
            )
    return out
