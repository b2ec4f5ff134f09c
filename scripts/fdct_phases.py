#!/usr/bin/env python3
"""Where the fDCT kernel's time goes, on one CUDA card.

    python3 scripts/fdct_phases.py

Builds variants of jpezy_tpu_torch/csrc/block_transforms.cu into
build/fdct_phases/ (the source's text with one step cut off or one choice
changed) and times the fDCT kernel's own time with torch.profiler (20
launches after a warm-up, warm and with the L2 cache overwritten before
each launch, in two rounds) on the main path's int8 planes of a
16x512x512 batch (tests/imagegen, the ycc420 upload's views), beside PR
9's design (scripts/previous_designs.py fdct_quantize_first):

  empty            the kernel returns at once: the card's cost of a
                   launch of this grid
  bytes only       the samples loaded and one word of them stored where
                   each coefficient goes: no product, no recombination, no
                   quantizer (the loads and the stores)
  no stores        everything but the stores (a store under a condition
                   no coefficient meets keeps the work alive)
  staged stores    the coefficients through a per-warp 4 KB stage in
                   shared memory (rows of 68 words) and out as 16-byte
                   stores, 512 contiguous bytes a warp's store, in place
                   of the 8-byte stores that fill one sector of each of 8
                   blocks
  no quantizer     the coefficients stored as recombined, unquantized
  no recombination, no quantizer
                   the three digit sums XORed and stored
  2, 4 thread blocks an SM
                   kFdctBlocksPerSm 2 or 4 in place of 3 (at most 128 or
                   64 registers a thread, 16 or 32 warps an SM; 3: 85, 24)
  one tile a warp  a grid of one tile a warp (the hardware schedules the
                   thread blocks as others end) in place of resident warps
                   that walk the tiles with the next one's samples in
                   flight
  full             the kernel as it is

The cut-off variants compute wrong coefficients and serve timing only; the
others are held to block_transform's integer model.  Prints what ptxas
reports for each variant, the card's name and power limit, then one JSON
line, with the full kernel's most frequent SASS opcodes (cuobjdump next to
nvcc).  Needs a CUDA card; imports no JAX.
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
SYMBOL = "fdct_quantize_kernel"


def variants(src: str) -> dict:
    """{name: source text} of the variants."""
    start = "  __shared__ FdctComp comps[3];\n  const int t = threadIdx.x;\n"
    compute = "    int acc[3][4];\n"
    stores = ("    if (live0)\n"
              "      *reinterpret_cast<int2*>(out + g * 64 + k) = "
              "make_int2(qv[0], qv[1]);\n"
              "    if (live1)\n"
              "      *reinterpret_cast<int2*>(out + (g + 8) * 64 + k) =\n"
              "          make_int2(qv[2], qv[3]);\n")
    quantize = ("      qv[i] = quantize(recombine(acc[0][i], acc[1][i], "
                "acc[2][i]),\n"
                "                       (i & 1) ? dd.y : dd.x, (i & 1) ? "
                "rr.y : rr.x, up);\n")
    shared = "  __shared__ int4 digits[kDigitWords];"
    calls = ("    fdct_tile(cur, digits, dn, rc, up, out, lane, live0, "
             "live1);\n")
    grid = ("    e = grid_for(fdct_quantize_kernel<int8_t>, kFdctThreads, "
            "blocks_needed,\n                 &grid);\n"
            "    if (e != cudaSuccess) return static_cast<int>(e);\n")
    for mark in (start, compute, stores, quantize, shared, calls, grid):
        _once(src, mark)
    # the stage: the tile's rows of 68 words (8-byte stores without bank
    # conflicts, 16-byte rows), then 512 contiguous bytes a warp's store
    staged = src.replace(shared, "  __shared__ __align__(16) int "
                         "stages[kFdctWarps][16 * 68];\n" + shared)
    staged = staged.replace(stores, stores.replace(" * 64 + k", " * 68 + k"))
    staged = staged.replace(calls, (
        "    int* stage = stages[t >> 5];\n"
        + calls.replace("out, lane, live0, live1", "stage, lane, true, true")
        + "    __syncwarp();\n"
        "#pragma unroll\n"
        "    for (int j = 0; j < 8; ++j) {\n"
        "      const int e = 4 * (lane + 32 * j);\n"
        "      if (first + (e >> 6) < nb)\n"
        "        reinterpret_cast<int4*>(out)[lane + 32 * j] =\n"
        "            *reinterpret_cast<const int4*>(stage + (e >> 6) * 68 "
        "+ (e & 63));\n"
        "    }\n"
        "    __syncwarp();\n"))
    return {
        "empty": src.replace(start, start + "  if (a.nimages > 0) return;\n"),
        "bytes only": _cut(src, compute, stores,
                           "    const int k = 8 * u + 2 * tq;\n"
                           "    const int qv[4] = {\n"
                           "        static_cast<int>(cur.w[0][0] ^ u),\n"
                           "        static_cast<int>(cur.w[0][2]),\n"
                           "        static_cast<int>(cur.w[1][1]),\n"
                           "        static_cast<int>(cur.w[1][3])};\n"),
        "no stores": src.replace(stores, (
            "    if (qv[0] == 0x7FFFFFFF)\n"
            "      *reinterpret_cast<int2*>(out + g * 64 + k) =\n"
            "          make_int2(qv[1], qv[2] ^ qv[3]);\n")),
        "staged stores": staged,
        "no quantizer": src.replace(quantize, (
            "      qv[i] = recombine(acc[0][i], acc[1][i], acc[2][i]);\n")),
        "no recombination, no quantizer": src.replace(quantize, (
            "      qv[i] = acc[0][i] ^ acc[1][i] ^ acc[2][i];\n")),
        **{f"{m} thread blocks an SM": _const(src, "kFdctBlocksPerSm", m)
           for m in (2, 4)},
        "one tile a warp": src.replace(
            grid, grid + "    grid = static_cast<int>(blocks_needed);\n"),
        "full": src,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("fdct_phases: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import previous_designs
    from imagegen import make_test_image
    from jpezy_tpu_torch.codec import host_glue as HG
    from jpezy_tpu_torch.codec import torch_codec as TC
    from jpezy_tpu_torch.constants import codec_constants
    from jpezy_tpu_torch.ops import block_transform as BT
    from jpezy_tpu_torch.ops import cuda_build, transform_cuda

    src = open(transform_cuda.LIB.src).read()
    out_dir = os.path.join(REPO, "build", "fdct_phases")
    os.makedirs(out_dir, exist_ok=True)
    libs, regs = {}, {}
    for name, text in variants(src).items():
        file = re.sub(r"\W+", "_", name) + ".cu"
        with open(os.path.join(out_dir, file), "w") as f:
            f.write(text)
        libs[name] = cuda_build.KernelLibrary(file, transform_cuda._bind,
                                              directory=out_dir)
    # one nvcc a source, all at once
    with cf.ThreadPoolExecutor(len(libs) + 1) as ex:
        list(ex.map(lambda lib: lib.build(force=True),
                    list(libs.values()) + [previous_designs.LIB]))
    for name, lib in libs.items():
        lib.get()
        log = lib.build_log.splitlines()
        regs[name] = [
            log[j].replace("ptxas info    : ", "").strip()
            for i, ln in enumerate(log)
            if "Compiling entry function" in ln and SYMBOL in ln
            for j in (i + 2, i + 3) if j < len(log)]

    dev = torch.device("cuda")
    y, cb, cr = HG.host_rgb_to_ycc420(np.stack(
        [make_test_image(H, W, seed=i) for i in range(BATCH)]))
    packed = torch.from_numpy(np.concatenate(
        [y.reshape(BATCH, -1), cb.reshape(BATCH, -1),
         cr.reshape(BATCH, -1)], axis=1)).to(dev)
    planes = TC._unpack_ycc(packed, H, W)
    ak = (codec_constants(dev)["y_quant"], codec_constants(dev)["c_quant"])
    model = BT.fdct_quantize_model(y, cb, cr, gray=False, rounded=False)
    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def launch(lib):
        keep = transform_cuda.LIB
        transform_cuda.LIB = lib
        try:
            return transform_cuda.fdct_quantize_cuda(*planes, *ak)
        finally:
            transform_cuda.LIB = keep

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

    checked = []
    for name in ("full", "staged stores", "2 thread blocks an SM",
                 "4 thread blocks an SM", "one tile a warp"):
        got = launch(libs[name])
        torch.cuda.synchronize()
        if not all(np.array_equal(g.cpu().numpy(), m)
                   for g, m in zip(got, model)):
            raise AssertionError(f"variant {name} != the integer model")
        checked.append(name)

    cases = [(name, SYMBOL, lambda lib=lib: launch(lib))
             for name, lib in libs.items()]
    cases.append(("PR 9's design", "fdct_first_kernel",
                  lambda: previous_designs.fdct_quantize_first(*planes,
                                                               *ak)))
    rows = {}
    for _ in range(2):
        for label, sym, fn in cases:
            rows.setdefault(label, []).append(
                [kernel_ms(fn, sym, cold) for cold in (False, True)])
    ops = sass_opcodes(cuda_build.nvcc(), libs["full"].so,
                       "fdct_quantize_kernelIaE")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    for k, v in regs.items():
        print(f"ptxas {k}: " + " | ".join(v))
    print("SASS of the full kernel, int8 samples: "
          f"{sum(ops.values())} instructions; "
          + ", ".join(f"{k} {v}" for k, v in list(ops.items())[:40]))
    print(f"identical to the integer model: {', '.join(checked)}")
    for k, v in rows.items():
        print(f"{k}: " + " / ".join(
            f"{w:.4f} (L2 overwritten first {c:.4f})" for w, c in v) + " ms")
    print(card)
    print(json.dumps({"card": card, "ms": rows, "ptxas": regs,
                      "sass": ops}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
