#!/usr/bin/env python3
"""Bring-up check of jpezy_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path -- the pipelined encode+decode round trip of
uniform batches of 16 RGB images at 512x512, fast precision, 4:2:0, no
restart markers -- on the card, in phases.  Each phase prints one line and
any failure exits nonzero:

  1. environment: torch/CUDA versions, the card's name and power limit,
     fp32 matmuls at IEEE precision (no TF32);
  2. build: compiles the CUDA entropy kernels (the pack alone and the fused
     emissions + pack) from the checkout's sources and prints what ptxas
     reports for each; a stack frame or a spill fails the run.  Counts
     each kernel's SASS instructions (cuobjdump), to set the time of
     running them all beside the kernel's time in phase 6;
  3. both kernels against their plain torch versions on the real
     16x512x512 blocks, on seeded worst-case blocks and on the edge-case
     blocks: words and bits must be identical.  The pack kernel alone is
     off the main path, so its launch count is taken here, over the real
     blocks (3, one per component);
  4. exact parity: a 4x512x512 precision="exact" encode on the card must be
     byte-identical to the host C++ codec (the port's verbatim copy of
     jpezy_tpu's host_codec), and both decoders must decode;
  5. main path: roundtrip_batches over 4 batches of 16x512x512 on the card,
     every stream must decode; the port's own decode and the host decoder's
     decode of the port's streams must both reach a PSNR within 0.05 dB of
     the host codec's exact round trip.  Per batch it prints the encode and
     decode programs' CUDA-event spans (host-launch bound: they include the
     gaps between the many small launches), their device-busy time (kernel
     and copy time summed from a torch.profiler trace), their number of
     device events and the pipelined MP/s, then the same three numbers
     for each stage of the encode program alone, and the card's busy share
     of the pipelined round trip (device time of a profiled round trip
     over the wall time of the unprofiled one).  The fused kernel must
     have been launched (3 times per batch) and the pack alone not at all;
  6. times: each kernel alone on the real blocks (CUDA-event span of the
     wrapper calls and the kernel's own device time from a torch.profiler
     trace, per launch and per batch, also with the L2 cache overwritten
     before each launch) beside its bound, the larger of the bytes the
     function must move (inputs read once, 32-bit words and bit counts
     written once) over 3.35 TB/s and the operations it needs at the
     least on this run's data over the card's 32-bit rate.  The profiler is first used behind the pipelined
     wall-clock measurement of phase 5, so that its tracing hooks cannot
     weigh on that number.

The last three lines are the kernel table as JSON, the card's name and
power limit, and {"ok": true, "device": {...}}.  Without a CUDA device, or
outside a checkout of the repository, it exits nonzero and prints no
result.  Imports nothing of JAX and nothing of the jpezy_tpu package.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
H = W = 512
BATCH = 16
MAIN_BATCHES = 4
PSNR_SLACK_DB = 0.05

# The card's published peaks (NVIDIA H100 SXM data sheet): device memory
# rate, and the float32 rate outside the tensor cores, 67 TFLOP/s at two
# operations per fused multiply-add, taken as the rate of 32-bit integer
# instructions (the data sheet states none; the card has fewer integer
# than float32 lanes, so this favours the operations side of the bound).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT_OPS_PER_S = 67e12 / 2
# Bytes per 8x8 block that each kernel's function must move: its inputs
# read once, 64 32-bit words and one bit count written once.  (The kernels
# store the words zero-extended to 64 bits, 256 bytes more per block: a
# cost of that layout, not part of the bound.)
BLOCK_BYTES = {"pack_words": 3 * 256 + 256 + 4,
               "encode_blocks": 256 + 4 + 256 + 4}
# The least 32-bit operations each function needs, whatever computes it:
# (per emission slot, per emission of nonzero length).  Packing: a slot
# costs one add of the prefix sum over the lengths and one test for an
# empty slot; an emission costs splitting its bit offset (2), justifying
# its 64 bits (2), cutting three window words (3) and merging them into
# the block (3).  Encoding from coefficients adds the nonzero test per
# slot, and per emission the magnitude category (2), the zero run (2),
# the table index (3), two table reads, the extra bits (3), the merge of
# code and extra bits (2) and the length (1).  Emissions are counted from
# the run's data.
MIN_OPS = {"pack_words": (2, 10), "encode_blocks": (3, 25)}
# blocks one warp of each kernel takes (kBlocksPerWarp of the source)
BLOCKS_PER_WARP = {"pack_words": 1, "encode_blocks": 2}


def _say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0 ** 2 / mse))


def _card() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int) -> float:
    """Mean CUDA-event span in ms per call of fn (events around `reps`
    calls, after one warm-up call).  For a sequence of many small launches
    the span includes the host's launch gaps; see _profile."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _profile(fn, reps: int) -> dict:
    """torch.profiler trace of `reps` calls of fn (after one warm-up call).

    Returns per call: busy_ms, the durations of the kernels, copies and
    memsets traced on the card, summed (None if the trace holds no device
    events); events, their number; by_name, busy ms per device event
    name; wall_ms, the host's time under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = sum(e.self_device_time_total for e in dev)
    return {"busy_ms": us / 1e3 / reps if us > 0 else None,
            "events": sum(e.count for e in dev) / reps,
            "wall_ms": 1e3 * wall / reps,
            "by_name": {e.key: e.self_device_time_total / 1e3 / reps
                        for e in dev}}


def _kernel_ms(prof: dict, name: str) -> float:
    """Device ms per call of the kernels whose name holds `name`; raises
    if the trace holds none."""
    hit = [ms for key, ms in prof["by_name"].items() if name in key]
    if not hit or sum(hit) <= 0:
        raise RuntimeError(f"the profiler traced no device time for {name}")
    return sum(hit)


def _fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def _images(n: int, seed0: int) -> np.ndarray:
    from imagegen import make_test_image

    return np.stack([make_test_image(H, W, seed=seed0 + i) for i in range(n)])


def _real_blocks(TC, HG, rgbs, dev):
    """Per-component ([B, 64] int32 quantized blocks, chroma) of a batch,
    as the main path makes them."""
    y, cb, cr = HG.host_rgb_to_ycc420(rgbs)
    q = TC._quantize_local_ycc(
        torch.from_numpy(y).to(dev), torch.from_numpy(cb).to(dev),
        torch.from_numpy(cr).to(dev), gray=False, dtype=torch.float32,
        rounded=False)
    return [(qc.reshape(-1, 64), chroma)
            for qc, chroma in zip(q, (False, True, True))]


def _worst_case_blocks(dev, nblocks: int = 4096, seed: int = 5):
    """Seeded blocks with all 63 AC coefficients nonzero, |v| <= 1023."""
    rng = np.random.default_rng(seed)
    q = rng.integers(1, 1024, size=(nblocks, 64)) * rng.choice(
        [-1, 1], (nblocks, 64))
    q[:, 0] = rng.integers(-1024, 1017, size=nblocks)
    qt = torch.from_numpy(q.astype(np.int32)).to(dev)
    return [(qt, False), (qt, True)]


def _kernel_of(symbol: str) -> str:
    return "encode_blocks" if "encode_blocks" in symbol else "pack_words"


def _ptxas_by_kernel(log: str) -> dict:
    """nvcc -Xptxas -v output -> {kernel: resource lines}."""
    out, cur = {}, None
    for ln in log.splitlines():
        ln = ln.strip()
        if "Compiling entry function" in ln:
            cur = _kernel_of(ln.split("'")[1])
            out[cur] = []
        elif cur and ("registers" in ln or "stack frame" in ln):
            out[cur].append(ln.replace("ptxas info    : ", ""))
    return out


def _sass_instructions(nvcc: str, lib: str) -> dict:
    """{kernel: number of SASS instructions in its sm_90a code}, from
    `cuobjdump -sass` of the built library, NOPs left out."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    res = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                         timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed: {res.stderr.strip()}")
    out, cur = {}, None
    for ln in res.stdout.splitlines():
        if "Function :" in ln:
            cur = _kernel_of(ln.split(":", 1)[1])
            out[cur] = 0
        elif cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?!NOP\b)\S", ln):
            out[cur] += 1
    return out


def _bound(nbytes: int, ops: int):
    """(bound ms, what bounds it): the larger of bytes over the memory
    rate and operations over the 32-bit rate."""
    t_b, t_o = nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from jpezy_tpu_torch.codec import host_codec
    from jpezy_tpu_torch.codec import host_glue as HG
    from jpezy_tpu_torch.codec import torch_codec as TC
    from jpezy_tpu_torch.device import check_fp32_precision, resolve
    from jpezy_tpu_torch.ops import entropy as E
    from jpezy_tpu_torch.ops import pack_cuda
    from jpezy_tpu_torch.runtime.pipeline import roundtrip_batches

    # ---- 1. environment
    card = _card()
    check_fp32_precision()
    dev = resolve("cuda")
    kind = torch.cuda.get_device_name(0)
    _say("1 env", f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]} device {kind} x"
         f"{torch.cuda.device_count()}; nvidia-smi: {card}; "
         f"allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
         f"fp32_matmul_precision={torch.get_float32_matmul_precision()}")

    # ---- 2. build the kernels from the checkout's sources
    secs = pack_cuda.build(force=True)
    pack_cuda.get_lib()
    ptxas = _ptxas_by_kernel(pack_cuda.build_log)
    sass = _sass_instructions(pack_cuda._nvcc(), pack_cuda._SO)
    if sorted(ptxas) != sorted(BLOCK_BYTES) or sorted(sass) != sorted(ptxas) \
            or min(sass.values()) <= 0:
        raise AssertionError(f"ptxas reported {sorted(ptxas)}, cuobjdump "
                             f"{sass}:\n{pack_cuda.build_log}")
    _say("2 build", f"entropy_pack.cu built for sm_90a in {secs:.2f} s; "
         + " || ".join(f"{k}: {' | '.join(v)} | {sass[k]} SASS instructions"
                       for k, v in ptxas.items()))
    for k, lines in ptxas.items():
        frames = [ln for ln in lines if "stack frame" in ln]
        if not frames or any(not ln.startswith(
                "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                "loads") for ln in frames):
            raise AssertionError(f"{k} uses local memory: {lines}")

    # ---- 3. both kernels against their plain torch versions
    real = _real_blocks(TC, HG, _images(BATCH, 0), dev)
    edge = torch.from_numpy(E.edge_case_blocks(3)).to(dev)
    sets = (("real", real), ("worst", _worst_case_blocks(dev)),
            ("edge", [(edge, False), (edge[:-1], True)]))  # even and odd B
    err = {"pack_words": 0, "encode_blocks": 0}
    worst_bits = 0
    real_inputs = []       # (q, pred, chroma, (hi, lo, nbits)) of the batch
    pack_cuda.launches = pack_cuda.encode_launches = 0
    for label, blocks in sets:
        for q, chroma in blocks:
            # per-image DC chains for the batch, as _emit_local; else one
            chains = BATCH if label == "real" else 1
            pred = E.dc_predictors(q[:, 0].reshape(chains, -1)).reshape(-1)
            ems = E.block_emissions(q, pred, chroma)
            wp, bp = E.pack_block_words_plain(*ems)
            got = {"pack_words": pack_cuda.pack_words_cuda(*ems),
                   "encode_blocks": pack_cuda.encode_blocks_cuda(
                       q, pred, chroma)}
            torch.cuda.synchronize()
            for name, (wk, bk) in got.items():
                e = max(int((wk - wp).abs().max()), int(
                    (bk.to(torch.int64) - bp.to(torch.int64)).abs().max()))
                err[name] = max(err[name], e)
                if e or wk.dtype != torch.int64:
                    raise AssertionError(
                        f"{name} kernel != plain version on {label} blocks "
                        f"[{q.shape[0]}, 64] chroma={chroma}")
            if label == "worst":
                worst_bits = max(worst_bits, int(bp.max()))
            if label == "real":
                real_inputs.append((q, pred, chroma, ems))
        if label == "real":
            # the pack alone is off the main path: its count is this one
            pack_alone_launches = pack_cuda.launches
    if pack_alone_launches != len(real_inputs):
        raise AssertionError(f"pack_words launched {pack_alone_launches} "
                             f"times on {len(real_inputs)} components")
    if worst_bits <= 32 * 32:
        raise AssertionError(f"worst-case blocks reach only {worst_bits} bits")

    n_edge = edge.shape[0]
    _say("3 kernels", f"pack_words and encode_blocks: words and bits "
         f"identical to the plain versions on real "
         f"{[tuple(q.shape) for q, *_ in real_inputs]}, worst-case (max "
         f"{worst_bits} bits/block) and {n_edge} edge-case blocks; "
         f"pack_words launches on the real blocks {pack_alone_launches}")
    del real, sets, edge, ems, wp, bp, got, wk, bk, q, pred
    torch.cuda.empty_cache()

    # ---- 4. exact parity with the host C++ codec
    imgs4 = _images(4, 100)
    got = TC.encode_batch(imgs4, precision="exact", device="cuda")
    ref = [host_codec.encode(im[..., 0], im[..., 1], im[..., 2]) for im in imgs4]
    if got != ref:
        bad = [i for i in range(4) if got[i] != ref[i]]
        raise AssertionError(f"exact encode differs from host_codec on {bad}")
    px, _ = TC.decode_batch(got, device="cuda")
    host_px = np.stack([np.stack(host_codec.decode(s)[:3], -1) for s in got])
    p_port, p_host = _psnr(px, imgs4), _psnr(host_px, imgs4)
    diff = np.abs(px.astype(np.int32) - host_px.astype(np.int32))
    if p_port < p_host - PSNR_SLACK_DB:
        raise AssertionError(f"port decode PSNR {p_port} < host {p_host}")
    _say("4 exact", f"4x{H}x{W} exact encode byte-identical to host_codec "
         f"({sum(map(len, got))} bytes); decode PSNR port {p_port:.4f} dB, "
         f"host {p_host:.4f} dB, max |diff| {int(diff.max())}, "
         f"{float((diff > 0).mean()):.5f} of samples differ")

    # ---- 5. the main path: pipelined round trip on the card
    batches = [_images(BATCH, 1000 + BATCH * i) for i in range(MAIN_BATCHES)]
    for _ in roundtrip_batches(batches[:1], device="cuda"):
        pass  # warm-up: CUDA context, cuBLAS handle, first allocations
    torch.cuda.synchronize()
    pack_cuda.launches = pack_cuda.encode_launches = 0
    t0 = time.perf_counter()
    results = list(roundtrip_batches(batches, lookahead=1, device="cuda"))
    wall = time.perf_counter() - t0
    main_launches = {"pack_words": pack_cuda.launches,
                     "encode_blocks": pack_cuda.encode_launches}
    if main_launches != {"pack_words": 0, "encode_blocks": 3 * MAIN_BATCHES}:
        raise AssertionError(
            f"main path launches {main_launches}: want the fused kernel 3 "
            "times per batch and the pack alone not at all")
    streams = [s for ss, _ in results for s in ss]
    src = np.concatenate(batches)
    px = np.concatenate([p for _, p in results])
    for s in streams:
        if s[:2] != b"\xff\xd8" or s[-2:] != b"\xff\xd9":
            raise AssertionError("stream without SOI/EOI")
    host_dec = np.stack([np.stack(host_codec.decode(s)[:3], -1)
                         for s in streams])
    ref_rt = np.stack([np.stack(host_codec.decode(host_codec.encode(
        im[..., 0], im[..., 1], im[..., 2]))[:3], -1) for im in src])
    p_rt, p_hostdec, p_ref = (_psnr(px, src), _psnr(host_dec, src),
                              _psnr(ref_rt, src))
    if p_rt < p_ref - PSNR_SLACK_DB:
        raise AssertionError(f"round-trip PSNR {p_rt} < host exact {p_ref}")
    if p_hostdec < p_ref - PSNR_SLACK_DB:
        raise AssertionError(f"host decode of the port's streams: PSNR "
                             f"{p_hostdec} < host exact {p_ref}")
    mps = len(streams) * H * W / 1e6 / wall

    y, cb, cr = HG.host_rgb_to_ycc420(batches[0])
    packed_dev = torch.from_numpy(np.concatenate(
        [y.reshape(BATCH, -1), cb.reshape(BATCH, -1), cr.reshape(BATCH, -1)],
        axis=1)).to(dev)
    def enc():
        return TC._encode_batch_blocks_packed(packed_dev, h=H, w=W)

    flat_host, kw, _, _, _ = TC._decode_host_prep(
        results[0][0], gray=False, precision="fast", transport=None)
    flat_dev = torch.from_numpy(flat_host).to(dev)
    def dec():
        return TC._decode_fused_batch_ycc420(flat_dev, **kw)

    # both event spans first: once the profiler has traced in a process,
    # every later launch costs the host more
    enc_ms, dec_ms = _time_ms(enc, 5), _time_ms(dec, 5)
    enc_prof, dec_prof = _profile(enc, 5), _profile(dec, 5)
    # the card's busy share of the pipelined round trip: device time of the
    # same round trip under the profiler (which slows the host, not the
    # kernels) over the wall time measured above without it
    rt_prof = _profile(lambda: list(roundtrip_batches(
        batches, lookahead=1, device="cuda")), 1)
    if rt_prof["busy_ms"] is None:
        raise RuntimeError("the profiler traced no device time for the "
                           "round trip")
    busy_share = rt_prof["busy_ms"] / (1e3 * wall)
    _say("5 main", f"{MAIN_BATCHES} batches x {BATCH}x{H}x{W} fast "
         f"round trip: {len(streams)} streams decode; PSNR port "
         f"{p_rt:.4f} dB, host decode of port streams {p_hostdec:.4f} dB, "
         f"host exact round trip {p_ref:.4f} dB; launches {main_launches}; "
         f"per batch: encode event span {enc_ms:.3f} ms, device busy "
         f"{_fmt_ms(enc_prof['busy_ms'])} ms in {enc_prof['events']:.1f} "
         f"device events (fused kernel "
         f"{_fmt_ms(_kernel_ms(enc_prof, 'encode_blocks_kernel'))} ms); "
         f"decode event span {dec_ms:.3f} ms, device busy "
         f"{_fmt_ms(dec_prof['busy_ms'])} ms in {dec_prof['events']:.1f} "
         f"device events; pipelined {mps:.3f} MP/s (wall {wall:.3f} s); "
         f"device busy over the {MAIN_BATCHES} pipelined batches "
         f"{rt_prof['busy_ms']:.3f} ms in {rt_prof['events']:.0f} device "
         f"events = {busy_share:.4f} of that wall, idle "
         f"{1 - busy_share:.4f} ({rt_prof['busy_ms'] / rt_prof['wall_ms']:.4f}"
         f" of the {rt_prof['wall_ms'] / 1e3:.3f} s the round trip takes "
         f"under the profiler) on {card}")

    # the encode program's three stages, each alone on the same batch
    ny, nc = H * W, (H // 2) * (W // 2)
    planes = (packed_dev[:, :ny].reshape(BATCH, H, W),
              packed_dev[:, ny:ny + nc].reshape(BATCH, H // 2, W // 2),
              packed_dev[:, ny + nc:].reshape(BATCH, H // 2, W // 2))
    def st_quant():
        return TC._quantize_local_ycc(*planes, gray=False,
                                      dtype=torch.float32, rounded=False)

    quantized = st_quant()
    def st_emit():
        return TC._emit_local(*quantized)

    emitted = st_emit()
    def st_concat():
        return TC._concat_batch_combined_comp(*emitted)

    parts = []
    for label, fn in (("blockify+fDCT+quantize", st_quant),
                      ("entropy, fused kernel wrapper x3", st_emit),
                      ("concat", st_concat)):
        span, prof = _time_ms(fn, 5), _profile(fn, 5)  # spans: after tracing
        parts.append(f"{label}: device busy {_fmt_ms(prof['busy_ms'])} ms, "
                     f"event span {span:.3f} ms, {prof['events']:.1f} events")
    _say("5 stages", "encode program per batch, each stage alone: "
         + "; ".join(parts))
    del planes, quantized, emitted

    # ---- 6. each kernel alone, timed (after the round trips: the profiler
    # is first used in phase 5, behind the pipelined wall-clock measurement)
    def bound(name, nblocks, emissions):
        """Bound of `name` on this many blocks holding this many emissions
        of nonzero length: the bytes and the operations its function needs
        at the least."""
        per_slot, per_emission = MIN_OPS[name]
        return _bound(BLOCK_BYTES[name] * nblocks,
                      per_slot * 64 * nblocks + per_emission * emissions)

    def sass_ms(name, block_counts):
        """What running every SASS instruction of the kernel once in every
        launched thread would take: more than the kernel executes, since
        it counts each branch as taken (an empty slot skips most of its
        emission code)."""
        per = BLOCKS_PER_WARP[name]
        threads = sum(32 * ((n + per - 1) // per) for n in block_counts)
        return 1e3 * sass[name] * threads / PEAK_INT_OPS_PER_S

    counts = [q.shape[0] for q, *_ in real_inputs]
    n_emitted = [int((ems[2] > 0).sum()) for *_, ems in real_inputs]

    def run_pack():
        for *_, ems in real_inputs:
            pack_cuda.pack_words_cuda(*ems)

    def run_encode():
        for q, pred, chroma, _ in real_inputs:
            pack_cuda.encode_blocks_cuda(q, pred, chroma)

    def run_pack_plain():
        for *_, ems in real_inputs:
            E.pack_block_words_plain(*ems)

    def run_encode_plain():
        for q, pred, chroma, _ in real_inputs:
            E.encode_block_words_plain(q, pred, chroma)

    # five times the card's 50 MB L2 cache
    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    timing = {}
    for name, run, plain, sym in (
            ("pack_words", run_pack, run_pack_plain, "pack_words_kernel"),
            ("encode_blocks", run_encode, run_encode_plain,
             "encode_blocks_kernel")):
        t = {"event_ms": _time_ms(run, 20), "plain_ms": _time_ms(plain, 3)}
        prof = _profile(run, 20)
        t["ms"] = _kernel_ms(prof, sym)  # the kernel's own device time
        t["wrapper_busy_ms"] = prof["busy_ms"]
        # each of the batch's three launches alone (Y, Cb, Cr): repeated on
        # the same buffers, then with the L2 cache overwritten before each
        def alone(i, cold):
            def fn():
                if cold:
                    l2_flush.zero_()
                if name == "pack_words":
                    pack_cuda.pack_words_cuda(*real_inputs[i][3])
                else:
                    pack_cuda.encode_blocks_cuda(*real_inputs[i][:3])
            return fn

        for key, cold in (("launch_ms", False), ("cold_launch_ms", True)):
            t[key] = [_kernel_ms(_profile(alone(i, cold), 20), sym)
                      for i in range(len(real_inputs))]
        t["cold_ms"] = sum(t["cold_launch_ms"])
        t["bound_ms"], t["bound_by"] = bound(name, sum(counts), sum(n_emitted))
        t["sass_ms"] = sass_ms(name, counts)
        timing[name] = t
        _say("6 times", f"{name} per {BATCH}x{H}x{W} batch (3 launches on "
             f"{[tuple(q.shape) for q, *_ in real_inputs]}): kernel alone "
             f"{t['ms']:.4f} ms (profiler; Y, Cb, Cr launch alone "
             f"{' '.join(f'{x:.4f}' for x in t['launch_ms'])} ms), wrapper "
             f"device busy {_fmt_ms(t['wrapper_busy_ms'])} ms, wrapper "
             f"event span {t['event_ms']:.4f} ms; bound "
             f"{t['bound_ms']:.4f} ms by {t['bound_by']} "
             f"({BLOCK_BYTES[name]} bytes/block) = "
             f"{t['bound_ms'] / t['ms']:.3f} of the kernel's time; with the "
             f"L2 cache overwritten before each launch: kernel "
             f"{t['cold_ms']:.4f} ms (Y, Cb, Cr "
             f"{' '.join(f'{x:.4f}' for x in t['cold_launch_ms'])} ms), "
             f"bound = {t['bound_ms'] / t['cold_ms']:.3f} of it; all "
             f"{sass[name]} SASS instructions run once per thread would "
             f"take {t['sass_ms']:.4f} ms; {sum(n_emitted)} emissions in "
             f"{sum(counts)} blocks; plain version event span "
             f"{t['plain_ms']:.4f} ms; on {card}")
    # the fused kernel on four batches' worth of luma blocks in one launch
    q4 = torch.cat([real_inputs[0][0]] * 4)
    p4 = torch.cat([real_inputs[0][1]] * 4)
    big_ms = _kernel_ms(_profile(
        lambda: pack_cuda.encode_blocks_cuda(q4, p4, False), 20),
        "encode_blocks_kernel")
    big_bound, big_by = bound("encode_blocks", q4.shape[0], 4 * n_emitted[0])
    _say("6 times", f"encode_blocks on [{q4.shape[0]}, 64] luma blocks in "
         f"one launch: kernel {big_ms:.4f} ms, bound {big_bound:.4f} ms by "
         f"{big_by} = {big_bound / big_ms:.3f} of it")
    del real_inputs, q4, p4, l2_flush

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "jpezy_tpu"))
    if leaked:
        raise AssertionError(f"imported {leaked[:5]}")
    # pack_words is off the main path: its count is phase 3's, over the
    # real blocks; encode_blocks' is the main path's
    launches = {"pack_words": pack_alone_launches,
                "encode_blocks": main_launches["encode_blocks"]}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": "jpezy_tpu_torch/csrc/entropy_pack.cu",
        "replaces": "jpezy_tpu/ops/pack_pallas.py:27",
        "launches": launches[name], "max_abs_err": err[name],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "launch_ms": t["launch_ms"], "cold_ms": t["cold_ms"],
        "cold_launch_ms": t["cold_launch_ms"],
        "event_ms": t["event_ms"], "wrapper_busy_ms": t["wrapper_busy_ms"],
        "sass_instructions": sass[name], "sass_ms": t["sass_ms"],
    } for name, t in timing.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
