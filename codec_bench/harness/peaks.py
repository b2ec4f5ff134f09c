"""Peaks of the card and the least-bytes arithmetic of the roofline shares.

A frozen copy, so that no change to the program moves the yardstick.  The
peak is NVIDIA's data-sheet rate of the H100 SXM part's HBM3 (the figure
the repository's kernel table uses, `PEAK_BYTES_PER_S`), valid at the full
700 W power limit; the run states the card's limit beside its shares.

A device program's least time counts its own inputs and outputs once,
whatever implements it, as the kernel table's byte-counting rule does:

- encode: the 4:2:0 int8 samples in (1.5 bytes a pixel) and the
  entropy-coded bytes of the streams out;
- decode: the entropy-coded bytes of the streams in and the 4:2:0 uint8
  planes out (1.5 bytes a pixel).

Intermediate blocks are not counted, so fusing stages raises a share.
Operations are not counted: the fDCT runs on the int8 tensor cores (1,979
TOP/s), where the least operation time lies under the byte time, and the
other stages are integer and table work with no peak of their own.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
SAMPLE_BYTES_PER_PIXEL = 1.5


def least_bytes(pixels: int, entropy_bytes: int) -> float:
    """Bytes a 4:2:0 encode or decode of `pixels` pixels whose streams
    hold `entropy_bytes` entropy-coded bytes must move at least."""
    return SAMPLE_BYTES_PER_PIXEL * pixels + entropy_bytes


def least_seconds(pixels: int, entropy_bytes: int) -> float:
    return least_bytes(pixels, entropy_bytes) / PEAK_BYTES_PER_S
