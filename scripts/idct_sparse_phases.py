#!/usr/bin/env python3
"""Where the ycc420 IDCT's sparse launch spends its time, on one CUDA card.

    python3 scripts/idct_sparse_phases.py

Builds variants of jpezy_tpu_torch/csrc/block_transforms.cu into
build/idct_sparse_phases/ (the source's text with one step cut off or one
constant changed) and times the sparse launch's own time
(idct_planes_sparse_kernel) with torch.profiler (20 launches after a
warm-up, warm and with the L2 cache overwritten before each launch, in two
rounds) on the ycc420 uploads of a 16x512x512 batch (tests/imagegen, fast,
4:2:0) at the default quality and at quality 95, and of 16 noise images
at quality 100 (every block an overflow row, so every mask clear), beside
the first design (scripts/previous_designs.py idct_planes_sparse_first):

  empty              the kernel returns at once: the card's cost of a
                     launch of this grid
  one unit a warp    a grid of one unit a warp (the hardware schedules the
                     thread blocks as others end) in place of resident
                     warps that walk the units
  no walk            every group takes the path of a group without AC
                     coefficients (one term a quad, its 4 samples alike):
                     the loads, the tables, the conversions and the
                     stores, no sums
  no stores          everything but the stores (a store under a condition
                     no sample meets keeps the work alive)
  union of 4, 8      kSparseGroup 4 or 8 in place of 16: the blocks whose
                     masks one walk takes together (8 or 4 lanes a block,
                     in place of 2)
  2, 4 thread blocks an SM
                     kSparseBlocksPerSm 2 or 4 in place of 3 (at most 128
                     or 64 registers a thread, 16 or 32 warps an SM)
  units of 16 blocks kSparseUnit 16 in place of 32: a warp's unit one walk
                     (twice the units, each with its copies and its wait)
  full               the kernel as it is

The cut-off variants compute wrong planes and serve timing only; the
others are held to block_transform.idct_planes_sparse_model.  Prints what
ptxas reports for each variant, the card's name and power limit, then one
JSON line with the full kernel's most frequent SASS opcodes (cuobjdump next
to nvcc).  Needs a CUDA card; imports no JAX.

    python3 scripts/idct_sparse_phases.py --timeline

instead builds the kernel with per-warp timestamps (%globaltimer, ns) at
its start, after its prologue and, for each warp's first two units, at the
unit's top, once its stage has come, once the next unit's copies are
issued and once its groups are stored, runs it on the main batch and
prints their percentiles over the warps.
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

from encode_phases import _const, _cut, _once, sass_opcodes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, H, W, REPS = 16, 512, 512, 20
SYMBOL = "idct_planes_sparse_kernel"
# the blocks a walk may take as a union
UNIONS = (4, 8, 16)
# the variants that compute the planes, held to the model
EXACT = ("full", "2 thread blocks an SM", "4 thread blocks an SM",
         "units of 16 blocks") + tuple(f"union of {g}" for g in UNIONS)


def _group(src: str) -> int:
    """The source's kSparseGroup."""
    return int(re.search(r"constexpr int kSparseGroup = (\d+);", src)[1])


def variants(src: str) -> dict:
    """{name: source text} of the variants."""
    start = ("  const int stride = gridDim.x * kSparseWarps;\n"
             "  int u = blockIdx.x * kSparseWarps + warp;\n")
    flat = "      if ((ulo >> 1) == 0u && uhi == 0u) {\n"
    store = "      store_quads(sb,\n"
    grid = ("  e = grid_for(idct_planes_sparse_kernel, kSparseThreads,\n"
            "               (units + kSparseWarps - 1) / kSparseWarps, "
            "&grid);\n"
            "  if (e != cudaSuccess) return static_cast<int>(e);\n")
    for mark in (start, flat, store, grid):
        _once(src, mark)
    no_walk = src.replace(flat, "      if (true) {\n")
    one = (grid + "  grid = static_cast<int>((units + kSparseWarps - 1) / "
           "kSparseWarps);\n")
    return {
        "one unit a warp": src.replace(grid, one),
        "empty": src.replace(start, start + "  if (a.nimages > 0) return;\n"),
        "no walk": no_walk,
        "no stores": src.replace(store, (
            "      if (sb[0][0] == static_cast<uint32_t>(a.level) + 1000u)\n"
            + store)),
        **{name: _const(src, "kSparseGroup", int(name.split()[-1]))
           for name in union_variants(src)},
        **{f"{m} thread blocks an SM": _const(src, "kSparseBlocksPerSm", m)
           for m in (2, 4)},
        "units of 16 blocks": _const(src, "kSparseUnit", 16),
        "full": src,
    }


def timeline_source(src: str) -> str:
    """The kernel with per-warp timestamps into g_stamps[warp][slot] and
    jz_stamps(host) to read them: slot 13 the start, 14 after the
    prologue, 4 u + 0..3 of unit u (< 2) its top, its stage come, the next
    unit's copies issued and its groups stored."""
    def stamp(slot: str, cond: str = "lane == 0") -> str:
        return (f"  if ({cond}) {{ unsigned long long g_; asm volatile("
                "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_)); "
                "g_stamps[blockIdx.x * kSparseWarps + warp]"
                f"[{slot}] = g_; }}\n")

    unit = "lane == 0 && ui < 2"
    top = "    const SparseNext cur = next;\n"
    come = "    __syncwarp();\n    if (u + stride < total)\n"
    issued = ("      start_unit(a, comps, sp, u + stride, "
              "stages[warp][buf ^ 1], lane,\n                 &next);\n")
    end = "    __syncwarp();\n  }\n}\n"
    first = "  const int blk = lane / kSparseLanes;"
    begin = "  int u = blockIdx.x * kSparseWarps + warp;\n"
    kernel = src.index("    idct_planes_sparse_kernel(")
    head, body = src[:kernel], src[kernel:]
    for mark in (top, come, issued, end, first, begin):
        if body.count(mark) < 1:
            raise RuntimeError(f"the sparse kernel no longer holds {mark!r}")
    body = body.replace(begin, begin + stamp("13", "lane == 0"), 1)
    body = body.replace(first, "  int ui = 0;\n" + stamp("14") + first, 1)
    body = body.replace(top, stamp("4 * ui", unit) + top, 1)
    body = body.replace(come, "    __syncwarp();\n" + stamp("4 * ui + 1", unit)
                        + "    if (u + stride < total)\n", 1)
    body = body.replace(issued, issued + stamp("4 * ui + 2", unit), 1)
    body = body.replace(end, "    __syncwarp();\n" + stamp("4 * ui + 3", unit)
                        + "    ++ui;\n  }\n}\n", 1)
    head = head.replace("namespace {\n", "namespace {\n\n__device__ unsigned "
                        "long long g_stamps[16384][16];\n", 1)
    return (head + body + '\nextern "C" int jz_stamps(void* host) {\n'
            "  return static_cast<int>(cudaMemcpyFromSymbol(host, g_stamps, "
            "sizeof(g_stamps)));\n}\n")


def timeline(out_dir: str, flat, kw) -> str:
    """Build the timestamped kernel, run the sparse launch on the upload
    `flat` (on the card) three times and return the percentiles (0, 10,
    50, 90, 100) of its warps' stamps in ns from the first warp's start,
    and of the steps between them."""
    import ctypes

    from jpezy_tpu_torch.ops import cuda_build, transform_cuda

    src = timeline_source(open(transform_cuda.LIB.src).read())
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "idct_timeline.cu"), "w") as f:
        f.write(src)
    lib = cuda_build.KernelLibrary("idct_timeline.cu", transform_cuda._bind,
                                   directory=out_dir)
    lib.build(force=True)
    lib.get().jz_stamps.argtypes = [ctypes.c_void_p]
    for _ in range(3):
        sparse_with(lib, flat, kw)
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
            f"; its stage come +{pct(d[:, 4 * ui + 1] - d[:, 4 * ui])}; the "
            f"next unit issued +{pct(d[:, 4 * ui + 2] - d[:, 4 * ui + 1])}; "
            f"its groups stored +{pct(d[:, 4 * ui + 3] - d[:, 4 * ui + 2])}; "
            f"done {pct(t[has, 4 * ui + 3])}")
    return " || ".join(lines)


def libraries(out_dir: str, names=None) -> dict:
    """{name: KernelLibrary} of the variants (`names`, or all), their
    sources written into out_dir, not built yet."""
    from jpezy_tpu_torch.ops import cuda_build, transform_cuda

    src = open(transform_cuda.LIB.src).read()
    os.makedirs(out_dir, exist_ok=True)
    libs = {}
    for name, text in variants(src).items():
        if names is not None and name not in names:
            continue
        file = "idct_" + re.sub(r"\W+", "_", name) + ".cu"
        with open(os.path.join(out_dir, file), "w") as f:
            f.write(text)
        libs[name] = cuda_build.KernelLibrary(file, transform_cuda._bind,
                                              directory=out_dir)
    return libs


def union_variants(src: str) -> list:
    """The names of the variants that walk other union sizes than the
    source's."""
    return [f"union of {g}" for g in UNIONS if g != _group(src)]


def build(out_dir: str, names=None) -> dict:
    """libraries(), built side by side (one nvcc a source) and loaded."""
    libs = libraries(out_dir, names)
    with cf.ThreadPoolExecutor(len(libs)) as ex:
        list(ex.map(lambda lib: lib.build(force=True), libs.values()))
    for lib in libs.values():
        lib.get()
    return libs


def sparse_with(lib, flat, kw):
    """idct_planes_sparse_cuda on the library `lib` in place of the
    package's."""
    from jpezy_tpu_torch.ops import block_transform as BT
    from jpezy_tpu_torch.ops import transform_cuda

    keep = transform_cuda.LIB
    transform_cuda.LIB = lib
    try:
        return BT.idct_planes_sparse(flat, **kw)
    finally:
        transform_cuda.LIB = keep


def main() -> int:
    if not torch.cuda.is_available():
        print("idct_sparse_phases: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import previous_designs
    from imagegen import make_test_image
    from jpezy_tpu_torch.codec import torch_codec as TC
    from jpezy_tpu_torch.ops import block_transform as BT
    from jpezy_tpu_torch.ops import cuda_build

    out_dir = os.path.join(REPO, "build", "idct_sparse_phases")
    if "--timeline" in sys.argv[1:]:
        dev = torch.device("cuda")
        rgbs = np.stack([make_test_image(H, W, seed=i) for i in range(BATCH)])
        flat, kw, *_ = TC._decode_host_prep(
            TC.encode_batch(rgbs, device="cuda"), gray=False,
            precision="fast", transport=None)
        print("timeline of the sparse launch on the main batch (ns): "
              + timeline(out_dir, torch.from_numpy(flat).to(dev), kw))
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip())
        return 0
    previous_designs.LIB.get()
    libs = build(out_dir)
    regs = {}
    for name, lib in libs.items():
        log = lib.build_log.splitlines()
        regs[name] = [
            log[j].replace("ptxas info    : ", "").strip()
            for i, ln in enumerate(log)
            if "Compiling entry function" in ln and SYMBOL in ln
            for j in (i + 2, i + 3) if j < len(log)]

    dev = torch.device("cuda")
    rgbs = np.stack([make_test_image(H, W, seed=i) for i in range(BATCH)])
    noise = np.random.default_rng(17).integers(0, 256, (BATCH, H, W, 3),
                                               dtype=np.uint8)
    sets = {}
    for label, imgs, quality in (("main", rgbs, None),
                                 ("quality 95", rgbs, 95),
                                 ("noise at quality 100", noise, 100)):
        flat, kw, *_ = TC._decode_host_prep(
            TC.encode_batch(imgs, quality=quality, device="cuda"),
            gray=False, precision="fast", transport=None)
        sets[label] = (torch.from_numpy(flat).to(dev), kw,
                       BT.idct_planes_sparse_model(
                           flat, **dict(kw, caps=(0,) * len(kw["caps"]))))
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

    args = ("geom", "level", "shapes", "K", "N", "caps")
    rows = {}
    for set_name, (flat, kw, model) in sets.items():
        alone = dict(kw, caps=(0,) * len(kw["caps"]))   # the sparse launch
        for name in EXACT:
            if name not in libs:
                continue
            got = sparse_with(libs[name], flat, alone)
            torch.cuda.synchronize()
            if not np.array_equal(got.cpu().numpy(), model):
                raise AssertionError(f"variant {name} != the model on "
                                     f"{set_name}")
        q = BT.quant_tables(kw["qtuple"], dev)
        cases = [(name, SYMBOL, lambda lib=lib: sparse_with(lib, flat, alone))
                 for name, lib in libs.items()]
        cases.append(("first design", "idct_sparse_first_kernel",
                      lambda: previous_designs.idct_planes_sparse_first(
                          flat, q, **{k: kw[k] for k in args})))
        for _ in range(2):
            for label, sym, fn in cases:
                rows.setdefault(set_name, {}).setdefault(label, []).append(
                    [kernel_ms(fn, sym, cold) for cold in (False, True)])
    ops = sass_opcodes(cuda_build.nvcc(), libs["full"].so, SYMBOL)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    for k, v in regs.items():
        print(f"ptxas {k}: " + " | ".join(v))
    print("SASS of the full kernel: "
          f"{sum(ops.values())} instructions; "
          + ", ".join(f"{k} {v}" for k, v in list(ops.items())[:40]))
    print(f"identical to the model: {', '.join(EXACT)}")
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
