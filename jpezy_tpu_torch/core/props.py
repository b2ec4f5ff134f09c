"""Image metadata record mirroring the reference's `property` struct.

reference: src/jpezy.hpp:154-342 (property), :346-386 (named-param factory).
The Boost.Parameter named-argument factory maps to plain keyword arguments.
"""
from __future__ import annotations

import dataclasses
import enum


class Format(enum.IntEnum):
    UNDEFINED = 0
    JFIF = 1
    JFXX = 2


class Units(enum.IntEnum):
    UNDEFINED = 0
    DOTS_INCH = 1
    DOTS_CM = 2


class ExtensionCode(enum.IntEnum):
    UNDEFINED = 0
    JPEG = 0x10
    ONE_BYTE_PIXEL = 0x11
    THREE_BYTE_PIXEL = 0x13


class Analyzed(enum.IntFlag):
    """Decode-progress flags. reference: src/jpezy.hpp:174-181."""

    YET = 0
    HTABLE = 0x01
    QTABLE = 0x02
    JFIF = 0x04
    COMMENT = 0x08
    START_DATA = 0x10


@dataclasses.dataclass
class ImageProps:
    width: int = 0
    height: int = 0
    dimension: int = 0          # component count (1 or 3)
    sample_precision: int = 0   # bits per sample (8 for baseline)
    comment: str = ""
    format: Format = Format.UNDEFINED
    major_rev: int = 0
    minor_rev: int = 0
    units: Units = Units.UNDEFINED
    h_density: int = 1
    v_density: int = 1
    h_thumbnail: int = 0
    v_thumbnail: int = 0
    extension_code: ExtensionCode = ExtensionCode.UNDEFINED
    decodable: Analyzed = Analyzed.YET


def make_encode_props(width: int, height: int, *, gray: bool = False) -> ImageProps:
    """Default encode-side metadata.

    Mirrors the hard-coded constants at reference src/encoder/encode_io.hpp:144-161
    (color) and :177-188 (gray): JFIF 1.02, 96x96 dpi, 3 components, 8-bit.
    The reference's gray path uses the comment "Encoded by JPEZY"
    (encode_io.hpp:181) vs "Encoded by jpezy" for color; we keep that quirk for
    byte-compatibility of the COM segment.
    """
    return ImageProps(
        width=width,
        height=height,
        dimension=3,
        sample_precision=8,
        comment="Encoded by JPEZY" if gray else "Encoded by jpezy",
        format=Format.JFIF,
        major_rev=1,
        minor_rev=2,
        units=Units.DOTS_INCH,
        h_density=96,
        v_density=96,
    )
