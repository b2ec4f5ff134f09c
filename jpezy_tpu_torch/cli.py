"""Command-line front end of the port, mirroring jpezy_tpu.cli (the
reference binaries' UX).

Usage:
  jpezy-torch encode <input.ppm> ( <output.(jpeg|jpg)> [--gray] | <output.ppm> | --debug )
  jpezy-torch decode <input.(jpg|jpeg)> <output.ppm> [--gray] [-v]
  ... [--host | --gpu | --cpu]

Also python -m jpezy_tpu_torch.cli, and the reference's two binaries as
jpezy-torch-encode / jpezy-torch-decode (main_encode, main_decode).  Kept from the reference: the logo,
the section timers ("Done! Processing time: X(sec)"), encode to .ppm
re-emitting the parsed PPM (--debug dumps it to stdout), decode -v with
the marker trace and per-phase timers.

Backends: the card runs every image unless the caller asks for another.
--host takes the host C++ codec (codec/host_codec.py: the same streams)
and raises without the C++ runtime; --cpu runs the torch codec on the
CPU; --gpu names the default.
"""
from __future__ import annotations

import sys

import numpy as np

from .utils.timing import SectionTimer, disp_logo

def _pick_backend(force: str | None) -> str:
    """Choose 'gpu' (torch on the card, the default), 'host' (C++ codec,
    on --host) or 'cpu' (torch on the CPU, on --cpu) for this run; prints
    the choice so runs are explainable."""
    if force == "host":
        from .runtime import native

        native.get_lib()  # ImportError without the C++ runtime
        print("backend: host (C++ codec; forced by --host)")
        return "host"
    if force == "cpu":
        print("backend: cpu (torch; forced by --cpu)")
        return "cpu"
    why = "forced by --gpu" if force == "gpu" else (
        "default; --host or --cpu picks another")
    print(f"backend: gpu (torch on the CUDA card; {why})")
    return "gpu"


def _codec_call(backend: str, fn: str, *args, **kwargs):
    """Run encode/decode on the chosen backend."""
    if backend == "host":
        from .codec import host_codec

        return getattr(host_codec, fn)(*args, **kwargs)
    from .codec import torch_codec

    return getattr(torch_codec, fn)(
        *args, device="cpu" if backend == "cpu" else "cuda", **kwargs)


def _encode_usage() -> int:
    print(
        "Usage: jpezy-torch encode <input.ppm> "
        "( <output.(jpeg | jpg) [OPT: --gray] [--optimize] [--quality N] "
        "[--restart-interval N]> | <output.ppm> | --debug )",
        file=sys.stderr,
    )
    return 1


def _int_flag(rest: list[str], name: str) -> int | None:
    """Parse `--name N` from the flag list; None when absent."""
    if name not in rest:
        return None
    i = rest.index(name)
    if i + 1 >= len(rest):
        raise ValueError(f"{name} needs a value")
    return int(rest[i + 1])


def _decode_usage() -> int:
    print(
        "Usage: jpezy-torch decode <input.(jpg | jpeg)> "
        "( <output.ppm> | [OPT: --gray]) [-v]",
        file=sys.stderr,
    )
    return 1


def cmd_encode(argv: list[str]) -> int:
    if len(argv) < 2:
        return _encode_usage()
    inp, outp = argv[0], argv[1]
    rest = argv[2:]
    gray = "--gray" in rest
    optimize = "--optimize" in rest
    try:
        quality = _int_flag(rest, "--quality")
        restart = _int_flag(rest, "--restart-interval") or 0
        if quality is not None and not 1 <= quality <= 100:
            raise ValueError("--quality must be in 1..100")
        if restart < 0:
            raise ValueError("--restart-interval must be >= 0")
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return _encode_usage()

    from .runtime import ppm

    disp_logo()
    timer = SectionTimer("Reading the input file...")
    try:
        w, h, maxv, rgb = ppm.read(inp)
    except (OSError, ppm.PpmFormatError):
        print("The file is not found or the formatting error", file=sys.stderr)
        return _encode_usage()
    print(f"width: {w} height: {h}")
    t1 = timer.stop()

    if outp == "--debug":
        sys.stdout.write(
            ppm.serialize_p3(rgb, comment=None, maxval=maxv).decode())
        return 0
    if outp.endswith(".ppm"):
        ppm.write(outp, rgb, fmt="P3", comment=None, maxval=maxv)
        return 0
    if not (".jpg" in outp or ".jpeg" in outp):
        return _encode_usage()

    backend = _pick_backend(_FORCE_BACKEND)
    timer.restart("Start encoding and writing ...")
    data = _codec_call(
        backend, "encode", rgb[..., 0], rgb[..., 1], rgb[..., 2], gray=gray,
        optimize=optimize, quality=quality, restart_interval=restart)
    with open(outp, "wb") as f:
        f.write(data)
    unit = "srook::byte" if gray else "byte"  # reference quirk kept
    print(f"Output size: {len(data)} {unit}")
    t2 = timer.stop()
    print(f"Total processing time: {t1 + t2}")
    return 0


def cmd_decode(argv: list[str]) -> int:
    if len(argv) < 2:
        return _decode_usage()
    inp, outp = argv[0], argv[1]
    rest = argv[2:]
    gray = "--gray" in rest
    verbose = "-v" in rest
    if not ((".jpg" in inp or ".jpeg" in inp) and ".ppm" in outp):
        return _decode_usage()

    from .bitstream.reader import JpegFormatError
    from .runtime import ppm

    disp_logo()
    timer = SectionTimer("process started...")
    print()
    try:
        with open(inp, "rb") as f:
            data = f.read()
        backend = _pick_backend(_FORCE_BACKEND)
        if verbose:
            _verbose_trace(data)
        r, g, b, pr = _codec_call(backend, "decode", data, gray=gray,
                                  verbose=verbose)
    except (OSError, JpegFormatError, ValueError, RuntimeError) as e:
        if verbose:
            print(f"error: {e}", file=sys.stderr)
        print("decode failed", file=sys.stderr)
        return 1

    fmt = {1: "JFIF", 2: "JFXX"}.get(int(pr.format), "undefined")
    units = {1: "dots inch", 2: "dots cm"}.get(int(pr.units), "undefined")
    print(
        f"\tLoaded JPEG: {pr.width}x{pr.height}, presicion {pr.sample_precision}, "
        f'"{pr.comment}", {fmt} standart {pr.major_rev}.0{pr.minor_rev}, {units}, '
        f"frames {pr.dimension}, density {pr.h_density}x{pr.v_density}\n"
    )
    ppm.write(outp, np.stack([r, g, b], axis=-1), fmt="P3")
    timer.stop()
    print(
        f"Decoded image: Netpbm image data, size = {pr.width} x {pr.height}, "
        "pixmap, ASCII text"
    )
    return 0


def _verbose_trace(data: bytes) -> None:
    """-v marker trace (the reference decoder<Debug>'s)."""
    from .core.tables import Marker

    names = {m.value: m.name for m in Marker}
    i = 0
    n = len(data)
    while i + 1 < n:
        if data[i] == 0xFF and data[i + 1] not in (0x00, 0xFF):
            code = data[i + 1]
            name = names.get(code, f"0x{code:02x}")
            print(f"\t\tfound marker: [{name}]")
            if code == Marker.SOS:
                break
            if 0xD0 <= code <= 0xD9 or code == 0x01:
                i += 2
                continue
            if i + 3 < n:
                i += 2 + ((data[i + 2] << 8) | data[i + 3])
                continue
        i += 1


_FORCE_BACKEND: str | None = None  # None = auto; "host" | "gpu" | "cpu"


def main(argv: list[str] | None = None) -> int:
    global _FORCE_BACKEND
    argv = list(sys.argv[1:] if argv is None else argv)
    _FORCE_BACKEND = None
    for flag in ("--host", "--gpu", "--cpu"):
        if flag in argv:
            argv.remove(flag)
            _FORCE_BACKEND = flag[2:]
    if not argv:
        print("Usage: jpezy-torch (encode | decode) ... "
              "[--host | --gpu | --cpu]", file=sys.stderr)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "encode":
        return cmd_encode(rest)
    if cmd == "decode":
        return cmd_decode(rest)
    print("Usage: jpezy-torch (encode | decode) ...", file=sys.stderr)
    return 1


def main_encode(argv: list[str] | None = None) -> int:
    """`jpezy-torch-encode in.ppm out.jpg ...`: the reference's first
    binary (CMakeLists.txt:7)."""
    return main(["encode"] + list(sys.argv[1:] if argv is None else argv))


def main_decode(argv: list[str] | None = None) -> int:
    """`jpezy-torch-decode in.jpg out.ppm ...`: the reference's second
    binary (CMakeLists.txt:8)."""
    return main(["decode"] + list(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    raise SystemExit(main())
