#!/usr/bin/env python3
"""Where exact mode's two kernels and the fast rgb IDCT spend their time,
on one CUDA card.

    python3 scripts/exact_phases.py [TREE]

Builds variants of jpezy_tpu_torch/csrc/exact_transforms.cu into
build/exact_phases/ (the source's text with one step cut off or one
choice changed) and times each kernel of each, with torch.profiler (20
launches after a warm-up, in two rounds), beside the first designs of
both kernels (scripts/previous_designs.py), on the main path's 16x512x512
batch (tests/imagegen; the forward on its int8 planes at Annex K, the
inverse on the exact forward's coefficients as the rgb transport uploads
them, int16), on the same images at quality 95 and on 16 noise images at
quality 100 (dense blocks):

  full            the source as it is
  all straight    every warp takes the branch-free run of all 64 terms
  all skipping    every warp takes the walk with a uniform branch a term
  no prefetch     the forward's tile rows loaded at the top of their own
                  iteration, not one iteration ahead
  C division      the forward's quantizer divides with C's / (not by
                  reciprocals)
  no quantize     the forward stores |c| unquantized (wrong output)
  no terms        the forward's 64-term sums cut out (wrong output)
  no bounds       the inverse without its launch bounds' thread blocks
                  an SM
  rgb dense N     the rgb IDCT's warps take the branch-free run from N
                  mask bits (the source: kRgbDenseTerms; 0 every warp, 65
                  none)
  rgb 256 threads the rgb IDCT in thread blocks of 256 (registers held
                  for 4 an SM)
  rgb no loads    the rgb IDCT's terms read d and M once, not a shared load
                  a step (wrong output)
  rgb one add     one add a term, not the 4 of a mirror quad (wrong output)
  rgb no terms    the rgb IDCT without its sums (wrong output)

The rgb variants time the rgb IDCT alone, beside its first design.

With TREE (another checkout, e.g. the parent commit unpacked with
`git archive` under build/), its exact_transforms.cu is built too and its
three kernels timed in the same turns.

The variants marked wrong serve timing only; every other variant (and
TREE's source) is held bit for bit to the plain float64 forms on the
batch and the noise, and the rgb IDCT of each to its numpy model.  Prints
each row, the card's name and power limit, then one JSON line.  Needs a
CUDA card; imports no JAX.
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


def _variants(src: str) -> dict:
    """{name: (source text, output checked)}."""
    def cut(text, old, new):
        if text.count(old) != 1:
            raise RuntimeError(f"exact_transforms.cu no longer holds "
                               f"{old[:60]!r} once")
        return text.replace(old, new)

    dense = "constexpr int kDenseTerms = 56;"
    fwd_pf = ("    const int c = c_next;\n"
              "    const int first = first_next;\n"
              "    const SampleRow<T> cur = next;\n"
              "    if (tile_i + warps < total)\n"
              "      fdct_load<T>(a, rcp_nb, rcp_mx, tile_i + warps, b, r, "
              "&c_next,\n"
              "                   &first_next, &next);\n")
    fwd_now = ("    int c, first;\n"
               "    SampleRow<T> cur;\n"
               "    fdct_load<T>(a, rcp_nb, rcp_mx, tile_i, b, r, &c, "
               "&first, &cur);\n")
    quant = "div_exact((mag << a.rounded) + bs[k], dn[k], rc[k])"
    terms = ("    if (__popc(lo) + __popc(hi) >= kDenseTerms)\n"
             "      forward_terms<false>(a, tile + b * kStride, cj, lo, hi, "
             "acc);\n"
             "    else\n"
             "      forward_terms<true>(a, tile + b * kStride, cj, lo, hi, "
             "acc);\n")
    bounds = "constexpr int kInvBlocksPerSm = 4;"
    rgb_dense = "constexpr int kRgbDenseTerms = 32;"
    rgb_threads = ("constexpr int kRgbThreads = 128;", "constexpr int "
                   "kRgbBlocksPerSm = 8;")
    rgb = {f"rgb dense {n}": (cut(src, rgb_dense, f"constexpr int "
                                  f"kRgbDenseTerms = {n};"), True)
           for n in (0, 16, 24, 40, 48, 56, 65)}
    rgb_loads = ("      const float4 dk = e[5 * v + u / 2];\n"
                 "      const float4 mk = m[8 * (k / 2)];\n")
    rgb_adds = ("  acc[0] = __fadd_rn(acc[0], t);\n"
                "  acc[1] = (u & 1) ? __fsub_rn(acc[1], t) : "
                "__fadd_rn(acc[1], t);\n"
                "  acc[2] = (v & 1) ? __fsub_rn(acc[2], t) : "
                "__fadd_rn(acc[2], t);\n"
                "  acc[3] = ((u ^ v) & 1) ? __fsub_rn(acc[3], t) : "
                "__fadd_rn(acc[3], t);\n")
    rgb_sums = ("  if (__popc(lo) + __popc(hi) >= kRgbDenseTerms)\n"
                "    rgb_terms<false>(e, mq + j, lo, hi, acc);\n"
                "  else\n"
                "    rgb_terms<true>(e, mq + j, lo, hi, acc);\n")
    return {**rgb,
        "rgb no loads": (cut(src, rgb_loads,
                             "      const float4 dk = e[0];\n"
                             "      const float4 mk = m[0];\n"), False),
        "rgb one add": (cut(src, rgb_adds,
                            "  acc[0] = __fadd_rn(acc[0], t);\n"), False),
        "rgb no terms": (cut(src, rgb_sums,
                             "  for (int i = 0; i < 16; ++i)\n"
                             "    acc[i / 8][i / 4 % 2][i % 4] = e[i].x;\n"),
                         False),
        "rgb 256 threads": (cut(cut(src, rgb_threads[0], "constexpr int "
                                    "kRgbThreads = 256;"), rgb_threads[1],
                                "constexpr int kRgbBlocksPerSm = 4;"), True),
        "full": (src, True),
        "all straight": (cut(src, dense, "constexpr int kDenseTerms = 0;"),
                         True),
        "all skipping": (cut(src, dense, "constexpr int kDenseTerms = 65;"),
                         True),
        "no prefetch": (cut(src, fwd_pf, fwd_now), True),
        "C division": (cut(src, quant,
                           "((mag << a.rounded) + bs[k]) / dn[k]"), True),
        "no quantize": (cut(src, quant, "mag"), False),
        "no terms": (cut(src, terms,
                         "#pragma unroll\n    for (int i = 0; i < 8; ++i)\n"
                         "      acc[i] = tile[b * kStride + i * 8 + r];\n"),
                     False),
        "no bounds": (cut(src, bounds, "constexpr int kInvBlocksPerSm = 1;"),
                      True),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("exact_phases: no CUDA device available", file=sys.stderr)
        return 2
    sys.path[:0] = [REPO, os.path.join(REPO, "tests"),
                    os.path.join(REPO, "scripts")]
    import concurrent.futures as cf

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import previous_designs
    from imagegen import make_test_image
    from jpezy_tpu_torch.codec import host_glue as HG
    from jpezy_tpu_torch.codec import torch_codec as TC
    from jpezy_tpu_torch.constants import codec_constants
    from jpezy_tpu_torch.core import tables as T
    from jpezy_tpu_torch.ops import block_transform as BT
    from jpezy_tpu_torch.ops import cuda_build, exact_cuda

    out_dir = os.path.join(REPO, "build", "exact_phases")
    os.makedirs(out_dir, exist_ok=True)
    variants = _variants(open(exact_cuda.LIB.src).read())
    if len(sys.argv) > 1:
        tree_src = os.path.join(sys.argv[1], "jpezy_tpu_torch", "csrc",
                                "exact_transforms.cu")
        variants["tree"] = (open(tree_src).read(), True)
    libs = {}
    for name, (text, _) in variants.items():
        file = re.sub(r"\W+", "_", name) + ".cu"
        with open(os.path.join(out_dir, file), "w") as f:
            f.write(text)
        libs[name] = cuda_build.KernelLibrary(file, exact_cuda._bind,
                                              directory=out_dir)
    every = list(libs.values()) + [previous_designs.LIB]
    with cf.ThreadPoolExecutor(len(every)) as ex:
        list(ex.map(lambda lib: lib.build(force=True), every))
    regs = {}
    for name, lib in libs.items():
        lib.get()
        regs[name] = [ln.replace("ptxas info    : ", "").strip()
                      for ln in lib.build_log.splitlines()
                      if "registers" in ln or "spill" in ln]
    previous_designs.LIB.get()

    dev = torch.device("cuda")

    def planes(rgbs):
        y, cb, cr = HG.host_rgb_to_ycc420(rgbs)
        n, h, w = y.shape
        return TC._unpack_ycc(torch.from_numpy(np.concatenate(
            [y.reshape(n, -1), cb.reshape(n, -1), cr.reshape(n, -1)],
            axis=1)).to(dev), h, w)

    c = codec_constants(dev)
    annex_k = (c["y_quant"], c["c_quant"])
    q100 = tuple(torch.from_numpy(t).to(dev)
                 for t in T.scale_quant_tables(100))
    main = planes(np.stack([make_test_image(H, W, seed=1000 + i)
                            for i in range(BATCH)]))
    q95 = tuple(torch.from_numpy(t).to(dev)
                for t in T.scale_quant_tables(95))
    sets = {"main": (main, annex_k), "quality 95": (main, q95),
            "noise q100": (planes(np.random.default_rng(17).integers(
                0, 256, (BATCH, H, W, 3), dtype=np.uint8)), q100)}
    my, mx = H // 16, W // 16
    geom = ((my, mx, 2, 2, 1, 1), (my, mx, 1, 1, 1, 1), (my, mx, 1, 1, 1, 1))
    sizes = (4 * my * mx, my * mx, my * mx)
    inv = {}
    for name, (p, qt) in sets.items():
        up = torch.cat(BT.fdct_quantize_exact(*p, gray=False, rounded=False,
                                              qtables=qt), dim=1)
        qtuple = tuple(tuple(int(v) for v in t.cpu())
                       for t in (qt[0], qt[1], qt[1]))
        inv[name] = (up.to(torch.int16), dict(
            geom=geom, sizes=sizes, gray=False, level=128, qtuple=qtuple))

    def with_lib(lib, fn):
        def run():
            keep, exact_cuda.LIB = exact_cuda.LIB, lib
            try:
                return fn()
            finally:
                exact_cuda.LIB = keep
        return run

    # every variant that keeps the output is held to the plain forms (and
    # the fast rgb IDCT to its model), each computed once a set
    wants = {}
    for s, (p, qt) in sets.items():
        coeff, kw = inv[s]
        wants[s] = (BT.fdct_quantize_plain(*p, gray=False, rounded=False,
                                           qtables=qt, dtype=torch.float64),
                    BT.idct_planes_exact_plain(coeff, **kw),
                    BT.idct_planes_rgb_model(coeff.cpu().numpy(), **kw))
    for name, (_, checked) in variants.items():
        if not checked:
            continue
        for s, (p, qt) in sets.items():
            coeff, kw = inv[s]
            want, want_i, want_r = wants[s]
            got = with_lib(libs[name], lambda: BT.fdct_quantize_exact(
                *p, gray=False, rounded=False, qtables=qt))()
            got_i = with_lib(libs[name], lambda: BT.idct_planes_exact(
                coeff, **kw))()
            got_r = with_lib(libs[name], lambda: BT.idct_planes_rgb(
                coeff, precision="fast", **kw))()
            if not (all(torch.equal(g, w) for g, w in zip(got, want)) and
                    all(torch.equal(g, w) for g, w in zip(got_i, want_i)) and
                    all(np.array_equal(g.cpu().numpy(), w)
                        for g, w in zip(got_r, want_r))):
                raise AssertionError(f"variant {name!r} differs from the "
                                     f"plain forms on {s}")

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

    rows = {}
    for _ in range(2):
        for s, (p, qt) in sets.items():
            coeff, kw = inv[s]
            qtab = BT.quant_tables(kw["qtuple"], dev)
            rows.setdefault(f"forward, {s}, first design", []).append(
                kernel_ms(lambda: previous_designs.fdct_quantize_exact_first(
                    *p, *qt), "fdct_exact_first_kernel"))
            rows.setdefault(f"inverse, {s}, first design", []).append(
                kernel_ms(lambda: previous_designs.idct_planes_exact_first(
                    coeff, qtab, geom=kw["geom"], level=kw["level"],
                    gray=kw["gray"], sizes=kw["sizes"]),
                    "idct_exact_first_kernel"))
            rows.setdefault(f"rgb inverse, {s}, first design", []).append(
                kernel_ms(lambda: previous_designs.idct_planes_rgb_first(
                    coeff, qtab, geom=kw["geom"], level=kw["level"],
                    gray=kw["gray"], sizes=kw["sizes"]),
                    "idct_rgb_first_kernel"))
            for name, lib in libs.items():
                if name.startswith("rgb"):
                    rows.setdefault(f"rgb inverse, {s}, {name}", []).append(
                        kernel_ms(with_lib(lib, lambda: BT.idct_planes_rgb(
                            coeff, precision="fast", **kw)),
                            "idct_planes_rgb_kernel"))
                    continue
                rows.setdefault(f"forward, {s}, {name}", []).append(
                    kernel_ms(with_lib(lib, lambda: BT.fdct_quantize_exact(
                        *p, gray=False, rounded=False, qtables=qt)),
                        "fdct_quantize_exact_kernel"))
                rows.setdefault(f"inverse, {s}, {name}", []).append(
                    kernel_ms(with_lib(lib, lambda: BT.idct_planes_exact(
                        coeff, **kw)), "idct_planes_exact_kernel"))
                if name in ("full", "tree"):
                    rows.setdefault(f"rgb inverse, {s}, {name}", []).append(
                        kernel_ms(with_lib(lib, lambda: BT.idct_planes_rgb(
                            coeff, precision="fast", **kw)),
                            "idct_planes_rgb_kernel"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    for k, v in sorted(rows.items()):
        print(f"{k}: " + " / ".join(f"{x:.4f}" for x in v) + " ms")
    print(card)
    print(json.dumps({"card": card, "ms": rows, "ptxas": regs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
