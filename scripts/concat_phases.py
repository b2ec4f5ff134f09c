#!/usr/bin/env python3
"""Where the stream concat kernel's time goes, on one CUDA card.

    python3 scripts/concat_phases.py

Builds variants of jpezy_tpu_torch/csrc/stream_concat.cu into
build/concat_phases/ (the source's text with one step cut off or one
constant changed) and times each, with torch.profiler (20 launches after
a warm-up, twice), on the main path's blocks of a 16x512x512 batch
(tests/imagegen, fast, 4:2:0, no restart markers), beside its form with
64-bit word loads (scripts/previous_designs.py), which read the words as
the first fused entropy kernel wrote them:

  empty          the kernel returns at once: the card's cost of a launch
  phase 1        returns after the bit-count fold and the scan
  phase 2        returns after the offsets and the segment counts
  no zero tail   everything but the last tile's zeros after the data
  no walk        everything but the bits the next tiles put in a tile's
                 last word
  full           the kernel as it is, also at 256 threads a block and at
                 tiles of 64 and 256 MCUs

The cut-off variants compute wrong streams and serve timing only.  Prints
the card's name and power limit, then one JSON line.  Needs a CUDA card;
imports no JAX.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, H, W, REPS = 16, 512, 512, 20


def main() -> int:
    if not torch.cuda.is_available():
        print("concat_phases: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [REPO, os.path.join(REPO, "tests"),
                    os.path.join(REPO, "scripts")]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import previous_designs
    from imagegen import make_test_image
    from jpezy_tpu_torch.codec import torch_codec as TC
    from jpezy_tpu_torch.ops import concat_cuda, cuda_build
    from jpezy_tpu_torch.ops import entropy as E

    src = open(concat_cuda.LIB.src).read()
    scan = "  const int64_t s_next = apply(whole, 0);"
    words = "  // 3. the tile's words [w0, w_data)"
    zeros = "  if (last) {  // the words after the image's data: 16-byte stores"
    walk = "    if (walker && hi == w_data && (s_next & 31) != 0)"
    start = "  extern __shared__ int64_t dyn[];\n"
    for mark in (scan, words, zeros, walk, start):
        if mark not in src:
            raise RuntimeError(f"stream_concat.cu no longer holds {mark!r}")
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))

    def at_threads(text, t):
        return re.sub(r"constexpr int kThreads = \d+;",
                      f"constexpr int kThreads = {t};", text)

    stop = "  if (nimages > 0) return;\n"
    variants = {
        "empty": src.replace(start, start + stop),
        "phase 1": src.replace(scan, scan + "\n  if (threadIdx.x == 0) "
                               "combined[n * (1 + nseg + maxw)] = s_next;\n"
                               + stop),
        "phase 2": src.replace(words, stop + words),
        "no zero tail": src.replace(zeros, "  if (false) {"),
        "no walk": src.replace(walk, "    if (false && walker)"),
        "full": src,
        "full, 256 threads": at_threads(src, 256),
    }
    out_dir = os.path.join(REPO, "build", "concat_phases")
    os.makedirs(out_dir, exist_ok=True)
    libs, regs = {}, {}
    for name, text in variants.items():
        file = re.sub(r"\W+", "_", name) + ".cu"
        with open(os.path.join(out_dir, file), "w") as f:
            f.write(text)
        lib = cuda_build.KernelLibrary(file, concat_cuda._bind,
                                       directory=out_dir)
        lib.build(force=True)
        libs[name] = lib.get()
        regs[name] = [ln.replace("ptxas info    : ", "").strip()
                      for ln in lib.build_log.splitlines()
                      if "registers" in ln or "spill" in ln]
    previous_designs.LIB.build(force=True)

    dev = torch.device("cuda")
    rgbs = np.stack([make_test_image(H, W, seed=1000 + i)
                     for i in range(BATCH)])
    wc, bc = TC._emit_local(*TC._quantize_batch_rgb(
        torch.from_numpy(rgbs).to(dev)))
    wc64 = tuple(E.words64(w) for w in wc)
    N, nm = bc[1].shape
    maxw = TC.stream_budget_words_batch(6 * nm)
    combined = torch.empty((N, 1 + maxw), dtype=torch.int64, device=dev)

    def launch(lib, tile):
        rc = lib.jz_concat_streams(
            *(t.data_ptr() for t in wc + bc), combined.data_ptr(), N, nm, 0,
            0, maxw, tile, -(-nm // tile),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed ({rc})")

    def kernel_ms(fn, *names):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and any(k in e.key for k in names)) / 1e3 / REPS

    _, tile = concat_cuda.tile_layout(nm)
    rows = {}
    for rnd in range(2):
        rows.setdefault("64-bit loads", []).append(kernel_ms(
            lambda: previous_designs.concat_streams_first(wc64, bc,
                                                          maxw=maxw),
            "concat_streams_first_kernel"))
        for name, lib in libs.items():
            for t in ((64, tile, 256) if name == "full" else (tile,)):
                rows.setdefault(f"{name}, tiles of {t}", []).append(
                    kernel_ms(lambda lib=lib, t=t: launch(lib, t),
                              "concat_streams_kernel"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    for k, v in rows.items():
        print(f"{k}: " + " / ".join(f"{x:.4f}" for x in v) + " ms")
    print(card)
    print(json.dumps({"card": card, "threads": threads, "ms": rows,
                      "ptxas": regs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
