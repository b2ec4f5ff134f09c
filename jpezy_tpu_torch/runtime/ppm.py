"""PPM (P3 ASCII / P6 binary) pixel I/O.

The reference reads only P3 and writes P3 (src/encoder/encode_io.hpp:45-101,
src/decoder/decode_io.hpp:37-54).  P6 support is an extension (it is what PIL
and most tools emit).  Parsing is numpy-vectorized; a C++ fast path in
jpezy_tpu.runtime.native is used when available (the reference's P3 parse was
its single biggest cost: 0.522 s of a 0.567 s encode, README.md:48-56).
"""
from __future__ import annotations

import numpy as np


class PpmFormatError(ValueError):
    pass


def _strip_comments(text: bytes) -> bytes:
    """Drop comment text from '#' to end-of-line."""
    if b"#" not in text:
        return text
    lines = text.split(b"\n")
    return b"\n".join(line.split(b"#", 1)[0] for line in lines)


def _after_p3_magic(data: bytes) -> int:
    """Index just past the 'P3' magic, skipping leading whitespace and
    comment lines (the reference's jump_comment accepts comments even
    before the magic, encode_io.hpp:50-56).  -1 when not P3.

    Scans bytewise over the (short) header region only -- the body can be
    megabytes with one '#' comment and must not be line-split in Python.
    """
    i, n = 0, len(data)
    while i < n:
        c = data[i]
        if c == 0x23:  # '#'
            j = data.find(b"\n", i)
            i = n if j < 0 else j + 1
        elif c in b" \t\r\n\v\f":
            i += 1
        else:
            break
    if data[i : i + 2] == b"P3":
        return i + 2
    return -1


def parse_p3(data: bytes) -> tuple[int, int, int, np.ndarray]:
    """Parse P3 bytes -> (width, height, maxval, rgb[H, W, 3] uint8)."""
    mag = _after_p3_magic(data)
    if mag < 0:
        raise PpmFormatError("not a P3 PPM")
    body = data[mag:]
    vals = None
    try:
        from . import native

        # the C++ tokenizer skips '#' comments itself; int32 is enough for
        # any PNM field and skips a pointless 8-byte-widening copy
        vals = native.scan_ints(body, len(body) // 2 + 4)
    except ImportError:
        body = _strip_comments(body)
    if vals is None:
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            vals = np.fromstring(body, dtype=np.int64, sep=" ")  # noqa: NPY201
    if len(vals) < 3:
        raise PpmFormatError("truncated PPM header")
    w, h, maxval = int(vals[0]), int(vals[1]), int(vals[2])
    px = vals[3 : 3 + w * h * 3]
    if len(px) != w * h * 3:
        raise PpmFormatError("pixel count mismatch")
    return w, h, maxval, px.reshape(h, w, 3).astype(np.uint8)


def parse_p6(data: bytes) -> tuple[int, int, int, np.ndarray]:
    """Parse P6 bytes -> (width, height, maxval, rgb[H, W, 3] uint8)."""
    if not data.startswith(b"P6"):
        raise PpmFormatError("not a P6 PPM")
    # header: P6 <w> <h> <max> then single whitespace then raster
    pos = 2
    fields = []
    while len(fields) < 3:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        fields.append(int(data[start:pos]))
    pos += 1  # single whitespace after maxval
    w, h, maxval = fields
    px = np.frombuffer(data, dtype=np.uint8, count=w * h * 3, offset=pos)
    return w, h, maxval, px.reshape(h, w, 3).copy()


def parse(data: bytes) -> tuple[int, int, int, np.ndarray]:
    head = data.lstrip()[:2]
    if head == b"P6":
        return parse_p6(data)
    # P3 may be preceded by comment lines (the reference's jump_comment skips
    # them even before the magic, encode_io.hpp:50-56)
    if head == b"P3" or _after_p3_magic(data) >= 0:
        return parse_p3(data)
    raise PpmFormatError("unsupported PNM magic")


def read(path: str) -> tuple[int, int, int, np.ndarray]:
    with open(path, "rb") as f:
        return parse(f.read())


def serialize_p3(rgb: np.ndarray, *, comment: str | None = "Decoded by jpezy",
                 maxval: int = 255) -> bytes:
    """Serialize rgb[H, W, 3] -> P3 text, one 'r g b' line per pixel.

    Byte-compatible with reference decode_io (src/decoder/decode_io.hpp:41-53):
    'P3\\n# Decoded by jpezy\\n<w> <h>\\n255\\n' then one pixel per line.
    maxval: carried through on passthrough re-emission (the reference
    re-emits the parsed header verbatim, src/encoder/encode_io.hpp:104-119;
    pixel STORAGE is bytes in both, matching its vector<srook::byte>).
    """
    h, w = rgb.shape[:2]
    header = "P3\n"
    if comment:
        header += f"# {comment}\n"
    header += f"{w} {h}\n{maxval}\n"
    try:
        from . import native

        return header.encode() + native.serialize_p3_pixels(rgb)
    except ImportError:
        pass
    flat = rgb.reshape(-1, 3)
    body = "\n".join(" ".join(map(str, px)) for px in flat.tolist())
    return header.encode() + body.encode() + b"\n"


def serialize_p6(rgb: np.ndarray) -> bytes:
    h, w = rgb.shape[:2]
    return f"P6\n{w} {h}\n255\n".encode() + rgb.astype(np.uint8).tobytes()


def write(path: str, rgb: np.ndarray, fmt: str = "P3", *,
          comment: str | None = "Decoded by jpezy",
          maxval: int = 255) -> None:
    with open(path, "wb") as f:
        f.write(serialize_p3(rgb, comment=comment, maxval=maxval)
                if fmt == "P3" else serialize_p6(rgb))
