#!/usr/bin/env python3
"""Where the fused entropy kernel's time goes, on one CUDA card.

    python3 scripts/encode_phases.py

Builds variants of jpezy_tpu_torch/csrc/entropy_pack.cu into
build/encode_phases/ (the source's text with one step cut off or one
constant changed) and times each kernel's own time with torch.profiler
(20 launches after a warm-up, in two rounds) on the main path's blocks of
a 16x512x512 batch (tests/imagegen, fast, 4:2:0, no restart markers),
beside the first fused design (scripts/previous_designs.py):

  empty              the kernel returns at once: the card's cost of a
                     launch of this grid
  no encode          the copies, the blocks read into registers, the
                     rows zeroed, one word a row and the stores:
                     everything but the zigzag walk (the bytes)
  flush by a branch  a full word leaves the bit accumulator in a branch
                     rather than by a predicated store
  rows of 64 words   the rows unpadded (8-way bank conflicts on the
                     16-byte reads, the zeroing and the stores)
  bounds for N warps an SM
                     kResident 20 and 28 in place of 24: the launch
                     bounds' registers a lane, 65536 / (32 N)
  full               the kernel as it is; also with restart_interval=8,
                     with the 16 per-image table sets of optimize and on
                     noise at quality 100

The cut-off variants compute wrong words and serve timing only.  Prints
what ptxas reports for each variant and the full kernel's most frequent
SASS opcodes (cuobjdump next to nvcc), the card's name and power limit,
then one JSON line.  Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, H, W, REPS = 16, 512, 512, 20


def _once(text: str, mark: str) -> None:
    if text.count(mark) != 1:
        raise RuntimeError(f"the kernel's source no longer holds {mark!r} "
                           "once")


def _const(text: str, name: str, value: int) -> str:
    pat = rf"constexpr int {name} = [^;]+;"
    if not re.search(pat, text):
        raise RuntimeError(f"the kernel's source no longer holds {name}")
    return re.sub(pat, f"constexpr int {name} = {value};", text, count=1)


def _cut(text: str, begin: str, end: str, put: str) -> str:
    """text with [begin, end) replaced by put (both marks once in it)."""
    _once(text, begin)
    _once(text, end)
    i = text.index(begin)
    return text[:i] + put + text[text.index(end, i):]


def variants(src: str) -> dict:
    """{name: source text} of the variants."""
    start = "  const int lane = threadIdx.x;\n"
    encode = "    Bits out = {0ull, 0, 0, row};\n"
    counted = "    k.bits[b] = 32 * out.words + out.held;\n"
    flush = ("    const bool full = held >= 32;\n"
             "    held &= 31;  // held < 64\n"
             "    if (full) row[min(words, kWords)] = "
             "static_cast<int32_t>(acc >> held);\n"
             "    words += full;\n")
    for mark in (start, flush):
        if src.count(mark) != 1:
            raise RuntimeError(f"entropy_pack.cu no longer holds {mark!r} "
                               "once")
    # launch bounds asking for m resident warps an SM: at most 65536 / (32
    # m) registers a lane
    capped = {f"bounds for {m} warps an SM": _const(src, "kResident", m)
              for m in (20, 28)}
    return {
        "empty": src.replace(start, start + "  if (nimages > 0) return;\n"),
        "no encode": _cut(src, encode, counted, encode
                          + "    row[0] = c[0] ^ c[63] ^ pred ^ t[0];\n"),
        "full": src,
        "flush by a branch": src.replace(
            flush, "    if (held >= 32) {\n      held -= 32;\n"
            "      row[min(words, kWords)] = static_cast<int32_t>(acc >> "
            "held);\n      ++words;\n    }\n"),
        "rows of 64 words": _const(src, "kRow", 64),
        **capped,
    }


def sass_opcodes(nvcc: str, lib: str, symbol: str) -> dict:
    """{opcode: count} of the kernels whose name holds `symbol`."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                         timeout=120).stdout
    counts, cur = collections.Counter(), False
    for ln in out.splitlines():
        if "Function :" in ln:
            cur = symbol in ln
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@\S+\s+)?([A-Z]\w*)", ln)
        if cur and m and m.group(1) != "NOP":
            counts[m.group(1)] += 1
    return dict(counts.most_common())


def main() -> int:
    if not torch.cuda.is_available():
        print("encode_phases: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [REPO, os.path.join(REPO, "tests"),
                    os.path.join(REPO, "scripts")]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import previous_designs
    from imagegen import make_test_image
    from jpezy_tpu_torch.codec import torch_codec as TC
    from jpezy_tpu_torch.ops import cuda_build, pack_cuda
    from jpezy_tpu_torch.ops import entropy as E

    src = open(pack_cuda.LIB.src).read()
    out_dir = os.path.join(REPO, "build", "encode_phases")
    os.makedirs(out_dir, exist_ok=True)
    libs, regs = {}, {}
    for name, text in variants(src).items():
        file = re.sub(r"\W+", "_", name) + ".cu"
        with open(os.path.join(out_dir, file), "w") as f:
            f.write(text)
        lib = cuda_build.KernelLibrary(file, pack_cuda._bind,
                                       directory=out_dir)
        lib.build(force=True)
        libs[name] = (lib, lib.get())
        regs[name] = [ln.replace("ptxas info    : ", "").strip()
                      for ln in lib.build_log.splitlines()
                      if "encode_blocks" in ln or "registers" in ln
                      or "spill" in ln]
    previous_designs.LIB.build(force=True)

    dev = torch.device("cuda")
    rgbs = np.stack([make_test_image(H, W, seed=1000 + i)
                     for i in range(BATCH)])
    q = tuple(c.contiguous() for c in TC._quantize_batch_rgb(
        torch.from_numpy(rgbs).to(dev)))
    noise = np.random.default_rng(14).integers(0, 256, (BATCH, H, W, 3),
                                               dtype=np.uint8)
    qn = tuple(c.contiguous() for c in TC._quantize_batch_rgb(
        torch.from_numpy(noise).to(dev), quality=100))
    hists = TC._symbol_histograms_batch(*q).cpu().numpy()
    _, yt, ct = TC._optimal_tables(hists)
    sets16 = (E.kernel_tables(yt, dev), E.kernel_tables(ct, dev))
    fixed = (pack_cuda.annex_k_row(dev, False), pack_cuda.annex_k_row(dev,
                                                                      True))
    N = BATCH
    outs = [(torch.empty((N, c.shape[1], 64), dtype=torch.int32, device=dev),
             torch.empty((N, c.shape[1]), dtype=torch.int32, device=dev))
            for c in q]

    def launch(lib, comps, ri=0, rows=None):
        custom = rows is not None
        rs = rows if custom else fixed
        rc = lib.jz_encode_blocks_batch(
            *(t.data_ptr() for t in comps + rs), rs[0].shape[0], int(custom),
            None, *(w.data_ptr() for w, _ in outs),
            *(b.data_ptr() for _, b in outs), N, comps[0].shape[1],
            comps[1].shape[1], ri, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed ({rc})")

    def kernel_ms(fn, name):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and name in e.key) / 1e3 / REPS

    # the full kernel's words equal the plain form's (the variants that
    # keep the output are checked too)
    want = E.encode_blocks_batch_plain(*(c.cpu() for c in q))
    checked = []
    for name in ("full", "flush by a branch", "rows of 64 words",
                 *(n for n in libs if n.startswith("bounds"))):
        launch(libs[name][1], q)
        torch.cuda.synchronize()
        for (w, b), ww, bw in zip(outs, want[0], want[1]):
            if not (torch.equal(E.words64(w).cpu(), ww)
                    and torch.equal(b.cpu(), bw)):
                raise AssertionError(f"variant {name} != plain version")
        checked.append(name)

    cases = [(name, name, lambda lib=lib: launch(lib, q))
             for name, (_, lib) in libs.items()]
    full = libs["full"][1]
    cases += [("full, restart_interval=8", "full",
               lambda: launch(full, q, 8)),
              ("full, 16 table sets", "full",
               lambda: launch(full, q, 0, sets16)),
              ("full, noise at quality 100", "full",
               lambda: launch(full, qn))]
    rows = {}
    for _ in range(2):
        for label, _, fn in cases:
            rows.setdefault(label, []).append(
                kernel_ms(fn, "encode_blocks_batch_kernel"))
        for label, fn in (
                ("first design", lambda: previous_designs.
                 encode_blocks_fused_first(*q)),
                ("first design, 16 table sets", lambda: previous_designs.
                 encode_blocks_fused_first(*q, tables=sets16)),
                ("first design, noise at quality 100", lambda:
                 previous_designs.encode_blocks_fused_first(*qn))):
            rows.setdefault(label, []).append(
                kernel_ms(fn, "encode_blocks_fused_first_kernel"))
    ops = sass_opcodes(cuda_build.nvcc(), libs["full"][0].so,
                       "encode_blocks_batch_kernelILb0E")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    for k, v in regs.items():
        print(f"ptxas {k}: " + " | ".join(v))
    print("SASS of the full kernel, fixed tables: "
          f"{sum(ops.values())} instructions; "
          + ", ".join(f"{k} {v}" for k, v in list(ops.items())[:30]))
    print(f"identical to the plain version: {', '.join(checked)}")
    for k, v in rows.items():
        print(f"{k}: " + " / ".join(f"{x:.4f}" for x in v) + " ms")
    print(card)
    print(json.dumps({"card": card, "ms": rows, "ptxas": regs,
                      "sass": ops}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
