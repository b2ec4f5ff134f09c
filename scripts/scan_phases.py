#!/usr/bin/env python3
"""Where the grid design of the Huffman scan (scripts/scan_grid.cu, a design
tried in place of jpezy_tpu_torch/csrc/huffman_scan.cu and not taken)
spends its time, on one CUDA card.

    python3 scripts/scan_phases.py

Builds variants of scripts/scan_grid.cu into build/scan_phases/ (the
source's text with one step cut off or one constant changed) and times the
kernel's own time (decode_segments_grid_kernel) with torch.profiler (20
launches after a warm-up, warm and with the L2 cache overwritten before
each launch, in two rounds) on the restart
segments (restart_interval=8, the device transport's rows) of a 16x512x512
batch (tests/imagegen, fast, 4:2:0) at the default quality and at quality
95, and of 16 noise images at quality 100, beside the package's kernel
(scan_cuda.decode_segments_cuda):

  empty              the kernel returns at once: the card's cost of a
                     launch of this grid
  prologue           the block's tables and the zeros of the slots past
                     nblk, then return: no decode
  build alone, six rows / one row
                     the prologue, then the grid of every chunk up to the
                     segment's last byte built for all six rows, or for the
                     luma AC row, and no walk
  six rows a chunk   every chunk built for all six rows (no choice of rows)
  Cr's own rows      Cr blocks on Cr's rows where they could share Cb's
  chunks of 64, 256  kChunkWords 2 or 8 in place of 4
  first-level table of 10 bits
                     kFirstBits 10 in place of 9 (24 KB of first level,
                     subtables of 64)
  no subtables       kPoolSlots 1: the windows the first level does not
                     answer read the full LUT
  8 warps a block    kWarps 8 in place of 16 (twice the thread blocks,
                     each with its tables)
  full               the kernel as it is

The cut-off variants compute wrong blocks and serve timing only; the full
kernel is held to entropy_decode.decode_segments_plain on the main set,
the other variants to the full kernel's blocks and flags on every set.
Prints what ptxas reports for each variant, the symbols a segment, the
card's name and power limit, then one JSON line.
Needs a CUDA card; imports no JAX.

    python3 scripts/scan_phases.py --clock

instead builds the kernel with per-segment cycle counts (clock64): from
the thread block's barrier to the segment's end and inside its grid
builds, the builds and the symbols looked up on the chain, runs it on the
three sets (and on them with one decoding warp a thread block: the
latencies without the other warps' issue) and prints their percentiles
beside the symbols a segment.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from encode_phases import _const, _cut, _once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, H, W, REPS, RI = 16, 512, 512, 20, 8
SYMBOL = "decode_segments_grid_kernel"
# the variants that cut a step off: their blocks are wrong, the others'
# equal the full kernel's
CUT = ("empty", "prologue", "build alone, six rows", "build alone, one row")


def variants(src: str) -> dict:
    """{name: source text} of the variants."""
    start = "  const int warp = threadIdx.x >> 5;\n"
    live = "  if (!live) return;  // after the last barrier\n"
    walk = ("  // The walk: block slot b holds component Y, Y, Y, Y, Cb, Cr by "
            "b % 6.\n")
    alias = "  return block_set && !cr_differs;\n"
    walk_end = "  if (rawlen) {\n"
    choice = "        if (starts > 1) rows |= used;\n"
    for mark in (start, live, walk, walk_end, choice, alias):
        _once(src, mark)

    def build_alone(rows: str) -> str:
        return _cut(src, walk, walk_end, (
            "  {  // every chunk up to the segment's last byte, no walk\n"
            "    const int bits = rawlen ? 8 * rawlen[s] : 32 * lw;\n"
            "    for (int c = 0; nb > 0 && c < bits; c += kChunk) {\n"
            "      sg.c0 = c;\n"
            f"      sg.build({rows});\n"
            "    }\n"
            "  }\n"))

    return {
        "empty": src.replace(start, start + "  if (nlanes > 0) return;\n"),
        "prologue": src.replace(live, live + "  if (nlanes > 0) return;\n"),
        "build alone, six rows": build_alone("0x3Fu"),
        "build alone, one row": build_alone("0x02u"),
        "six rows a chunk": src.replace(choice, "        rows = 0x3Fu;\n"),
        "Cr's own rows": src.replace(alias, alias.replace(
            "block_set && !cr_differs", "false && block_set")),
        "chunks of 64": _const(src, "kChunkWords", 2),
        "chunks of 256": _const(src, "kChunkWords", 8),
        "first-level table of 10 bits": _const(src, "kFirstBits", 10),
        "no subtables": _const(src, "kPoolSlots", 1),
        "8 warps a block": _const(src, "kWarps", 8),
        "full": src,
    }


def clock_source(src: str) -> str:
    """The kernel with per-segment counts in g_clock[s]: cycles from the
    barrier to the end, cycles inside grid builds, builds, rows built; and
    jz_clock(host) to read them."""
    marks = {
        "  if (!live) return;  // after the last barrier\n":
            "  const long long t_start = clock64();\n",
        "  int starts;          // blocks that started in this chunk\n":
            "  long long tbuild;\n  int nbuild, nrows;\n",
        "  sg.starts = 0;\n": "  sg.tbuild = 0;\n  sg.nbuild = 0;\n"
                             "  sg.nrows = 0;\n",
    }
    for mark, put in marks.items():
        _once(src, mark)
        src = src.replace(mark, mark + put)
    timed = {
        "      build(rows);\n": "      { const long long t0 = clock64(); "
                                "build(rows); tbuild += clock64() - t0; "
                                "++nbuild; nrows += __popc(rows); }\n",
        "    sg.build(rows0);\n": "    { const long long t0 = clock64(); "
                                 "sg.build(rows0); sg.tbuild += clock64() - "
                                 "t0; ++sg.nbuild; sg.nrows += "
                                 "__popc(rows0); }\n",
        "  if (lane == 0) bad_out[s] = (sg.flags & kFlag) ? 1 : 0;\n":
            "  if (lane == 0 && s < 8192) { g_clock[s][0] = clock64() - "
            "t_start; g_clock[s][1] = sg.tbuild; g_clock[s][2] = sg.nbuild; "
            "g_clock[s][3] = sg.nrows; }\n"
            "  if (lane == 0) bad_out[s] = (sg.flags & kFlag) ? 1 : 0;\n",
    }
    for mark, put in timed.items():
        _once(src, mark)
        src = src.replace(mark, put)
    src = src.replace("namespace {\n", "namespace {\n\n__device__ long long "
                      "g_clock[8192][4];\n", 1)
    return src + ('\nextern "C" int jz_clock(void* host) {\n'
                  "  return static_cast<int>(cudaMemcpyFromSymbol(host, "
                  "g_clock, sizeof(g_clock)));\n}\n")


def clock(out_dir: str, sets: dict) -> list:
    """Lines of percentiles (0, 10, 50, 90, 100) of the counts of
    clock_source's kernel on each set."""
    import ctypes

    import previous_designs
    from jpezy_tpu_torch.ops import cuda_build

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "scan_clock.cu"), "w") as f:
        f.write(clock_source(open(previous_designs.GRID.src).read()))
    lib = cuda_build.KernelLibrary("scan_clock.cu",
                                   previous_designs._bind_grid,
                                   directory=out_dir)
    lib.build(force=True)
    lib.get().jz_clock.argtypes = [ctypes.c_void_p]
    lines = []
    lone = {}
    for label, args in sets.items():
        # one walking warp a thread block: the others decode no block
        nblk = args["nblk"].clone()
        nblk[torch.arange(nblk.numel(), device=nblk.device) % 16 != 0] = 0
        lone[f"{label}, one segment a thread block"] = dict(args, nblk=nblk)
    for label, args in list(sets.items()) + list(lone.items()):
        S = args["words"].shape[0]
        for _ in range(3):
            blocks, _ = scan_with(lib, args)
        torch.cuda.synchronize()
        g = np.zeros((8192, 4), np.int64)
        lib.raise_on("jz_clock", lib.handle.jz_clock(g.ctypes.data))
        g = g[:S]
        keep = args["nblk"].cpu().numpy() > 0
        g, blocks = g[keep], blocks[torch.from_numpy(keep).to(blocks.device)]
        nz = (blocks.to(torch.int64)[..., 1:] != 0).sum(-1)
        sym = (2 + nz).sum(-1).cpu().numpy()

        def pct(x):
            return " ".join(f"{np.percentile(x, q):.0f}"
                            for q in (0, 10, 50, 90, 100))

        lines.append(
            f"{label}: cycles to the end {pct(g[:, 0])}; in builds "
            f"{pct(g[:, 1])}; builds {pct(g[:, 2])}; rows built "
            f"{pct(g[:, 3])}; symbols (DC, nonzero ACs, EOB) {pct(sym)}; "
            f"cycles a symbol outside the builds "
            f"{pct((g[:, 0] - g[:, 1]) / np.maximum(sym, 1))}; cycles a "
            f"row built {pct(g[:, 1] / np.maximum(g[:, 3], 1))}")
    return lines


def build(out_dir: str, names=None) -> dict:
    """{name: KernelLibrary} of the variants (`names`, or all), built side
    by side (one nvcc a source) and loaded."""
    import previous_designs
    from jpezy_tpu_torch.ops import cuda_build

    src = open(previous_designs.GRID.src).read()
    os.makedirs(out_dir, exist_ok=True)
    libs = {}
    for name, text in variants(src).items():
        if names is not None and name not in names:
            continue
        file = "scan_" + re.sub(r"\W+", "_", name) + ".cu"
        with open(os.path.join(out_dir, file), "w") as f:
            f.write(text)
        libs[name] = cuda_build.KernelLibrary(
            file, previous_designs._bind_grid, directory=out_dir)
    with cf.ThreadPoolExecutor(len(libs)) as ex:
        list(ex.map(lambda lib: lib.build(force=True), libs.values()))
    for lib in libs.values():
        lib.get()
    return libs


def scan_with(lib, args):
    """The grid design's decode_segments on the library `lib`."""
    import previous_designs

    return previous_designs.decode_segments_grid(**args, lib=lib)


def restart_args(streams, ri: int, dev) -> dict:
    """decode_segments arguments on `dev` for a batch of restart streams,
    as the device transport makes them."""
    from jpezy_tpu_torch.bitstream.reader import parse
    from jpezy_tpu_torch.codec import host_glue as HG
    from jpezy_tpu_torch.ops.entropy_decode import words_tensor

    pjs = [parse(s) for s in streams]
    nmcu = (pjs[0].props.height // 16) * (pjs[0].props.width // 16)
    nseg = -(-nmcu // ri)
    words, nblk, rawlen = HG._device_host_frontend(pjs, nmcu, ri, nseg)
    lut, tsel = HG._device_luts(pjs, nseg)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    return dict(words=words_tensor(words).to(dev), nblk=t(nblk), lut=t(lut),
                tsel=t(tsel), rawlen=t(rawlen), max_blocks=ri * 6)


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_phases: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from imagegen import make_test_image
    from jpezy_tpu_torch.codec import torch_codec as TC
    from jpezy_tpu_torch.ops import entropy_decode as ED
    from jpezy_tpu_torch.ops import scan_cuda

    out_dir = os.path.join(REPO, "build", "scan_phases")
    dev = torch.device("cuda")
    rgbs = np.stack([make_test_image(H, W, seed=i) for i in range(BATCH)])
    noise = np.random.default_rng(17).integers(0, 256, (BATCH, H, W, 3),
                                               dtype=np.uint8)
    sets = {label: restart_args(TC.encode_batch(
        imgs, quality=quality, restart_interval=RI, device="cuda"), RI, dev)
        for label, imgs, quality in (("main", rgbs, None),
                                     ("quality 95", rgbs, 95),
                                     ("noise at quality 100", noise, 100))}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    if "--clock" in sys.argv[1:]:
        for line in clock(out_dir, sets):
            print(line)
        print(card)
        return 0
    scan_cuda.LIB.get()
    libs = build(out_dir)
    regs = {}
    for name, lib in libs.items():
        log = lib.build_log.splitlines()
        regs[name] = [
            log[j].replace("ptxas info    : ", "").strip()
            for i, ln in enumerate(log)
            if "Compiling entry function" in ln and SYMBOL in ln
            for j in (i + 2, i + 3) if j < len(log)]

    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def kernel_ms(fn, name, cold):
        def run():
            if cold:
                l2_flush.zero_()
            fn()
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                run()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and name in e.key) / 1e3 / REPS

    rows, symbols = {}, {}
    for set_name, args in sets.items():
        want = scan_with(libs["full"], args)
        if set_name == "main":
            plain = ED.decode_segments_plain(**args)
            if not all(torch.equal(a, b) for a, b in zip(want, plain)):
                raise AssertionError("the full kernel != the plain version")
        for name in (n for n in libs if n not in CUT):
            got = scan_with(libs[name], args)
            now = scan_cuda.decode_segments_cuda(**args)
            torch.cuda.synchronize()
            for label, out in ((name, got), ("package kernel", now)):
                if not all(torch.equal(a, b) for a, b in zip(want, out)):
                    raise AssertionError(f"{label} != the full kernel on "
                                         f"{set_name}")
        if bool(want[1].any()):
            raise AssertionError(f"{set_name}: segments flagged as corrupt")
        blocks = want[0].to(torch.int64)
        nz = (blocks[..., 1:] != 0).sum(-1)
        # a symbol a block's DC, its nonzero ACs and an EOB (a bound: the
        # ZRLs are left out, an EOB after position 63 counted)
        per_seg = (1 + nz + 1).sum(-1)
        symbols[set_name] = (float(per_seg.float().mean()),
                             int(per_seg.max()))
        cases = [(name, SYMBOL, lambda lib=lib: scan_with(lib, args))
                 for name, lib in libs.items()]
        cases.append(("package kernel", "decode_segments_kernel",
                      lambda: scan_cuda.decode_segments_cuda(**args)))
        for _ in range(2):
            for label, sym, fn in cases:
                rows.setdefault(set_name, {}).setdefault(label, []).append(
                    [kernel_ms(fn, sym, cold) for cold in (False, True)])
    for k, v in regs.items():
        print(f"ptxas {k}: " + " | ".join(v))
    print("identical to the full kernel: "
          + ", ".join(n for n in libs if n not in CUT) + " and the package's "
          "kernel")
    for set_name, by in rows.items():
        mean, most = symbols[set_name]
        print(f"{set_name}: about {mean:.1f} symbols a segment, at most "
              f"{most} (DC, nonzero ACs, EOB)")
        for k, v in by.items():
            print(f"{set_name}, {k}: " + " / ".join(
                f"{w:.4f} (L2 overwritten first {c:.4f})" for w, c in v)
                + " ms")
    print(card)
    print(json.dumps({"card": card, "ms": rows, "ptxas": regs,
                      "symbols": symbols}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
