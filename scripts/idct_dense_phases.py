#!/usr/bin/env python3
"""Where the ycc420 IDCT's dense launch spends its time, on one CUDA card.

    python3 scripts/idct_dense_phases.py [--sets a,b] [--variants a,b]

Builds variants of jpezy_tpu_torch/csrc/block_transforms.cu into
build/idct_dense_phases/ (the source's text with one step cut off or one
constant changed) and times the dense launch's own time
(idct_planes_dense_kernel) with torch.profiler (20 launches after a
warm-up, warm and with the L2 cache overwritten before each launch, in two
rounds) on the Huffman scan's blocks of a 16x512x512 batch (tests/imagegen,
fast, 4:2:0): its restart segments (restart_interval=8, the device
transport), the indexed transport's pseudo-segments of its restart-free
streams, of its images at quality 95 and of 16 noise images at quality
100; beside its first design (scripts/previous_designs.py
idct_planes_dense_first):

  empty              the kernel returns once its first two units' copies
                     are issued: a launch of this grid
  no flags           the flag bytes not made (the block-wide OR per image
                     before the units)
  loads alone        each unit's copies issued and waited for, nothing
                     else
  no prefetch        the next unit's copies waited for too before this
                     unit is walked (nothing in flight behind the sums)
  no walk            every sum 0 (the masks, the loads and the stores)
  no stores          everything but the stores (a store under a condition
                     no row meets keeps the work alive)
  aligned stores     each row one 8-byte store at its address rounded
                     down to 8 (wrong planes; no shuffle, no edge pieces)
  straight from 16, 24, 48; never straight
                     kDenseTerms 16, 24, 48 or 65 in place of 32
  2, 4 thread blocks an SM
                     kDenseBlocksPerSm 2 or 4 in place of 3
  units of 8 blocks  kDenseUnit 8 in place of 16: 4 lanes a block, 4
                     quads a lane, twice the units
  one unit a warp    a grid of one unit a warp (the hardware schedules the
                     thread blocks as others end) in place of resident
                     warps that walk the units
  full               the kernel as it is

The cut-off variants compute wrong planes and serve timing only; the
others are held to block_transform.idct_planes_dense_model.  Prints what
ptxas reports for each variant, the card's name and power limit, then one
JSON line.  --sets and --variants take a comma-separated subset (sets by
their first word: restart, indexed, quality, noise).  Needs a CUDA card;
imports no JAX.

    python3 scripts/idct_dense_phases.py --timeline

instead builds the kernel with per-warp timestamps (%globaltimer, ns) at
its start, after its prologue and, for each warp's first two units, at the
unit's top, once its stage has come, once its rows are stored and once the
unit after next is issued into its stage, runs it on the restart segments
and prints their percentiles over the warps.
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

from encode_phases import _const, _once, sass_opcodes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, H, W, REPS, RI = 16, 512, 512, 20, 8
SYMBOL = "idct_planes_dense_kernel"
# the variants that compute the planes, held to the model
EXACT = ("full", "no prefetch", "straight from 16", "straight from 24",
         "straight from 48",
         "never straight", "2 thread blocks an SM", "4 thread blocks an SM",
         "units of 8 blocks", "one unit a warp")


def _kernel(src: str) -> tuple:
    """(text before the dense kernel, the kernel up to the launcher's
    helpers, the rest)."""
    i = src.index("    idct_planes_dense_kernel(const __grid_constant__")
    j = src.index("template <typename K>\ncudaError_t grid_for(")
    return src[:i], src[i:j], src[j:]


def _in_kernel(src: str, mark: str, put: str) -> str:
    head, body, tail = _kernel(src)
    _once(body, mark)
    return head + body.replace(mark, put) + tail


def variants(src: str) -> dict:
    """{name: source text} of the variants."""
    first = ("    start_dense(a, comps, sp, u + stride, stages[warp][1], "
             "lane);\n")
    flags = "  for (int n = blockIdx.x; n < a.nimages; n += gridDim.x) {\n"
    waited = ("    __syncwarp();\n    uint32_t* stage = stages[warp][buf];\n"
              "    const Unit U = sparse_unit(a, comps, sp, u);\n")
    refill = ("    if (u + 2 * stride < total)\n"
              "      start_dense(a, comps, sp, u + 2 * stride, stage, lane);\n")
    walk = ("    if (__popc(ulo) + __popc(uhi) >= kDenseTerms)\n"
            "      quad_walk<false, 1, kDenseQuads>(ulo, uhi, terms, acc);\n"
            "    else\n"
            "      quad_walk<true, 1, kDenseQuads>(ulo, uhi, terms, acc);\n")
    store = "        if (live)\n          put_row("
    shuffle = ("        const uint64_t rv = s ? __shfl_sync(kFullMask, v, "
               "from) : 0u;\n")
    aligned = ("  if (s == 0) {\n    *reinterpret_cast<uint64_t*>(p) = v;\n"
               "    return;\n  }\n")
    grid = ("    e = grid_for(idct_planes_dense_kernel, kDenseThreads,\n"
            "                 (units + kDenseWarps - 1) / kDenseWarps, "
            "&grid);\n"
            "    if (e != cudaSuccess) return static_cast<int>(e);\n")
    _once(src, aligned)
    _once(src, grid)
    no_walk = ("#pragma unroll\n    for (int j = 0; j < kDenseQuads; ++j)\n"
               "#pragma unroll\n      for (int e = 0; e < 4; ++e)\n"
               "        acc[0][j][e] = static_cast<float>((ulo + uhi) & 1u);\n")
    return {
        "empty": _in_kernel(src, first, first + "  if (a.nimages > 0) "
                            "return;\n"),
        "no flags": _in_kernel(src, flags, flags.replace(
            "n < a.nimages", "n < 0")),
        "loads alone": _in_kernel(src, waited, waited + "    if (a.nimages "
                                  "> 0) {\n" + refill + "      continue;\n"
                                  "    }\n"),
        "no prefetch": _in_kernel(src, waited, "    asm volatile(\"cp.async."
                                  "wait_all;\" ::: \"memory\");\n" + waited),
        "no walk": _in_kernel(src, walk, no_walk),
        "no stores": _in_kernel(src, store, store.replace(
            "if (live)", "if (live && v == 0x0123456789abcdefull)")),
        "aligned stores": _in_kernel(src, shuffle, shuffle.replace(
            "s ? __shfl_sync(kFullMask, v, from) : 0u", "0u")).replace(
            aligned, "  {\n    *reinterpret_cast<uint64_t*>(p - s) = v;\n"
            "    return;\n  }\n"),
        **{f"straight from {m}": _const(src, "kDenseTerms", m)
           for m in (16, 24, 48)},
        "never straight": _const(src, "kDenseTerms", 65),
        **{f"{m} thread blocks an SM": _const(src, "kDenseBlocksPerSm", m)
           for m in (2, 4)},
        "units of 8 blocks": _const(src, "kDenseUnit", 8),
        "one unit a warp": src.replace(grid, grid + (
            "    grid = static_cast<int>((units + kDenseWarps - 1) / "
            "kDenseWarps);\n")),
        "full": src,
    }


def timeline_source(src: str) -> str:
    """The kernel with per-warp timestamps into g_stamps[warp][slot] and
    jz_stamps(host) to read them: slot 13 the start, 14 after the
    prologue, 4 u + 0..3 of unit u (< 2) its top, its stage come, its
    rows stored and the unit after next issued into its stage."""
    def stamp(slot: str, cond: str = "lane == 0") -> str:
        return (f"  if ({cond}) {{ unsigned long long g_; asm volatile("
                "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_)); "
                "g_stamps[blockIdx.x * kDenseWarps + warp]"
                f"[{slot}] = g_; }}\n")

    unit = "lane == 0 && ui < 2"
    head, body, tail = _kernel(src)
    marks = {
        "begin": "  int u = blockIdx.x * kDenseWarps + warp;\n",
        "first": "  const int i = lane / kDenseLanes;",
        "top": "    // this unit's copies have come (the next unit's may "
               "not have)\n",
        "come": "    __syncwarp();\n    uint32_t* stage = stages[warp][buf];\n",
        "stored": "    // every lane is done with the stage: the unit after "
                  "next into it\n",
    }
    for mark in marks.values():
        _once(body, mark)
    end = "\n  }\n}\n"
    body = body.rstrip("\n") + "\n"
    if not body.endswith(end):
        raise RuntimeError("the dense kernel no longer ends its unit loop "
                           "as expected")
    body = body.replace(marks["begin"], marks["begin"] + stamp("13"))
    body = body.replace(marks["first"], "  int ui = 0;\n" + stamp("14")
                        + marks["first"])
    body = body.replace(marks["top"], stamp("4 * ui", unit) + marks["top"])
    body = body.replace(marks["come"], marks["come"]
                        + stamp("4 * ui + 1", unit))
    body = body.replace(marks["stored"], stamp("4 * ui + 2", unit)
                        + marks["stored"])
    body = (body[:-len(end)] + "\n" + stamp("4 * ui + 3", unit)
            + "    ++ui;\n  }\n}\n\n")
    head = head.replace("namespace {\n", "namespace {\n\n__device__ unsigned "
                        "long long g_stamps[16384][16];\n", 1)
    return (head + body + tail + '\nextern "C" int jz_stamps(void* host) {\n'
            "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, "
            "sizeof(g_stamps)));\n}\n")


def dense_with(lib, src, kw):
    """idct_planes_dense_cuda on the library `lib` in place of the
    package's."""
    from jpezy_tpu_torch.ops import block_transform as BT
    from jpezy_tpu_torch.ops import transform_cuda

    keep = transform_cuda.LIB
    transform_cuda.LIB = lib
    try:
        return BT.idct_planes_dense(*src, **kw)
    finally:
        transform_cuda.LIB = keep


def timeline(out_dir: str, src, kw) -> str:
    """Build the timestamped kernel, run the dense launch on `src` three
    times and return the percentiles (0, 10, 50, 90, 100) of its warps'
    stamps in ns from the first warp's start, and of the steps between
    them."""
    import ctypes

    from jpezy_tpu_torch.ops import cuda_build, transform_cuda

    text = timeline_source(open(transform_cuda.LIB.src).read())
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "idct_dense_timeline.cu"), "w") as f:
        f.write(text)
    lib = cuda_build.KernelLibrary("idct_dense_timeline.cu",
                                   transform_cuda._bind, directory=out_dir)
    lib.build(force=True)
    lib.get().jz_stamps.argtypes = [ctypes.c_void_p]
    for _ in range(3):
        dense_with(lib, src, kw)
    torch.cuda.synchronize()
    g = np.zeros((16384, 16), np.uint64)
    lib.raise_on("jz_stamps", lib.handle.jz_stamps(g.ctypes.data))
    g = g[g[:, 13] > 0].astype(np.int64)
    t = g - g[:, 13].min()

    def pct(x):
        return " ".join(f"{np.percentile(x, p):.0f}"
                        for p in (0, 10, 50, 90, 100))

    lines = [f"{len(g)} warps; start {pct(t[:, 13])}; after the prologue "
             f"{pct(t[:, 14])}"]
    for ui in range(2):
        has = g[:, 4 * ui] > 0
        if not has.any():
            continue
        d = g[has]
        lines.append(
            f"unit {ui} ({int(has.sum())} warps): its top "
            f"{pct(t[has, 4 * ui])}"
            f"; its stage come +{pct(d[:, 4 * ui + 1] - d[:, 4 * ui])}; its "
            f"rows stored +{pct(d[:, 4 * ui + 2] - d[:, 4 * ui + 1])}; the "
            f"unit after next issued +"
            f"{pct(d[:, 4 * ui + 3] - d[:, 4 * ui + 2])}; "
            f"done {pct(t[has, 4 * ui + 3])}")
    return " || ".join(lines)


def build(out_dir: str, names=None) -> dict:
    """{name: KernelLibrary} of the variants (`names`, or all), their
    sources written into out_dir, built side by side (one nvcc a source)
    and loaded."""
    from jpezy_tpu_torch.ops import cuda_build, transform_cuda

    src = open(transform_cuda.LIB.src).read()
    os.makedirs(out_dir, exist_ok=True)
    libs = {}
    for name, text in variants(src).items():
        if names is not None and name not in names:
            continue
        file = "idct_dense_" + re.sub(r"\W+", "_", name) + ".cu"
        with open(os.path.join(out_dir, file), "w") as f:
            f.write(text)
        libs[name] = cuda_build.KernelLibrary(file, transform_cuda._bind,
                                              directory=out_dir)
    with cf.ThreadPoolExecutor(len(libs)) as ex:
        list(ex.map(lambda lib: lib.build(force=True), libs.values()))
    for lib in libs.values():
        lib.get()
    return libs


def dense_inputs(dev, names=None) -> dict:
    """{label: ((blocks, bad, qarr) on dev, kwargs of idct_planes_dense)}:
    the scan's blocks of the restart segments and of the indexed
    pseudo-segments of the main batch, of its images at quality 95 and of
    noise at quality 100."""
    from imagegen import make_test_image
    from jpezy_tpu_torch.bitstream.reader import parse
    from jpezy_tpu_torch.codec import host_glue as HG
    from jpezy_tpu_torch.codec import torch_codec as TC
    from jpezy_tpu_torch.ops import entropy_decode as ED

    rgbs = np.stack([make_test_image(H, W, seed=i) for i in range(BATCH)])
    noise = np.random.default_rng(17).integers(0, 256, (BATCH, H, W, 3),
                                               dtype=np.uint8)
    out = {}
    for label, imgs, quality, ri in (
            ("restart segments", rgbs, None, RI),
            ("indexed pseudo-segments of the main batch", rgbs, None, 0),
            ("quality 95, indexed", rgbs, 95, 0),
            ("noise at quality 100, indexed", noise, 100, 0)):
        if names is not None and label.split()[0].rstrip(",") not in names:
            continue
        streams = TC.encode_batch(imgs, quality=quality, restart_interval=ri,
                                  device="cuda")
        pjs = [parse(s) for s in streams]
        nmcu = (H // 16) * (W // 16)
        k = ri or 8
        nseg = -(-nmcu // k)
        if ri:
            words, nblk, rawlen = HG._device_host_frontend(pjs, nmcu, ri,
                                                           nseg)
            opt = dict(rawlen=rawlen)
        else:
            words, nblk, skip0, preds0 = HG._indexed_host_frontend(
                pjs, nmcu, k, nseg)
            opt = dict(skip0=skip0, preds0=preds0)
        lut, tsel = HG._device_luts(pjs, nseg)
        args = {name: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(
            dev) for name, v in dict(opt, nblk=nblk, tsel=tsel).items()}
        blocks, bad = ED.decode_segments(
            ED.words_tensor(words).to(dev), lut=ED.device_lut(lut, dev),
            max_blocks=k * 6, **args)
        _, geom, level = TC._parse_batch(streams)
        qarr = torch.from_numpy(HG._quant_arr(pjs)).to(dev)
        out[label] = ((blocks, bad, qarr),
                      dict(N=BATCH, nseg=nseg, ri=k, geom=geom, level=level))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("idct_dense_phases: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import previous_designs
    from jpezy_tpu_torch.ops import block_transform as BT
    from jpezy_tpu_torch.ops import cuda_build

    def pick(flag):
        for arg in sys.argv[1:]:
            if arg.startswith(flag + "="):
                return arg.split("=", 1)[1].split(",")
        return None

    dev = torch.device("cuda")
    out_dir = os.path.join(REPO, "build", "idct_dense_phases")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    if "--timeline" in sys.argv[1:]:
        sets = dense_inputs(dev, pick("--sets") or ["restart"])
        for label, (src, kw) in sets.items():
            print(f"timeline of the dense launch on the {label} (ns): "
                  + timeline(out_dir, src, kw))
        print(card)
        return 0
    previous_designs.LIB.get()
    libs = build(out_dir, pick("--variants"))
    regs = {}
    for name, lib in libs.items():
        log = lib.build_log.splitlines()
        regs[name] = [
            log[j].replace("ptxas info    : ", "").strip()
            for i, ln in enumerate(log)
            if "Compiling entry function" in ln and SYMBOL in ln
            for j in (i + 2, i + 3) if j < len(log)]
    sets = dense_inputs(dev, pick("--sets"))
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

    rows = {}
    for set_name, (src, kw) in sets.items():
        model = BT.idct_planes_dense_model(*(t.cpu().numpy() for t in src),
                                           **kw)
        for name in EXACT:
            if name not in libs:
                continue
            got = dense_with(libs[name], src, kw)
            torch.cuda.synchronize()
            if not np.array_equal(got.cpu().numpy(), model):
                raise AssertionError(f"variant {name} != the model on "
                                     f"{set_name}")
        cases = [(name, SYMBOL, lambda lib=lib: dense_with(lib, src, kw))
                 for name, lib in libs.items()]
        cases.append(("first design", "idct_dense_first_kernel",
                      lambda: previous_designs.idct_planes_dense_first(
                          *src, **kw)))
        for _ in range(2):
            for label, sym, fn in cases:
                rows.setdefault(set_name, {}).setdefault(label, []).append(
                    [kernel_ms(fn, sym, cold) for cold in (False, True)])
    ops = (sass_opcodes(cuda_build.nvcc(), libs["full"].so, SYMBOL)
           if "full" in libs else {})
    for k, v in regs.items():
        print(f"ptxas {k}: " + " | ".join(v))
    if ops:
        print("SASS of the full kernel: "
              f"{sum(ops.values())} instructions; "
              + ", ".join(f"{k} {v}" for k, v in list(ops.items())[:40]))
    print(f"identical to the model: "
          f"{', '.join(n for n in EXACT if n in libs)}")
    for set_name, by in rows.items():
        for k, v in by.items():
            print(f"{set_name}, {k}: " + " / ".join(
                f"{w:.4f} (L2 overwritten first {c:.4f})" for w, c in v)
                + " ms")
    print(card)
    print(json.dumps({"card": card, "ms": rows, "ptxas": regs,
                      "sass": ops}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
