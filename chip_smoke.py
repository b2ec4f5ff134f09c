#!/usr/bin/env python3
"""Bring-up check of jpezy_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path -- the pipelined encode+decode round trip of
uniform batches of 16 RGB images at 512x512, fast precision, 4:2:0, no
restart markers -- on the card, in phases.  Each phase prints one line and
any failure exits nonzero:

  1. environment: torch/CUDA versions, the card's name and power limit,
     fp32 matmuls at IEEE precision (no TF32);
  2. build: compiles the CUDA pack kernel from the checkout's sources;
  3. kernel against its plain torch version on real 16x512x512 emissions
     and on seeded worst-case blocks: words and bits must be identical;
  4. exact parity: a 4x512x512 precision="exact" encode on the card must be
     byte-identical to the host C++ codec (the port's verbatim copy of
     jpezy_tpu's host_codec), and both decoders must decode;
  5. main path: roundtrip_batches over 4 batches of 16x512x512 on the card,
     every stream must decode; the port's own decode and the host decoder's
     decode of the port's streams must both reach a PSNR within 0.05 dB of
     the host codec's exact round trip.  Per batch it prints the encode and
     decode programs' CUDA-event spans (host-launch bound: they include the
     gaps between the many small launches), their device-busy time (kernel
     and copy time summed from a torch.profiler trace) and the pipelined
     MP/s.

The last three lines are the kernel table as JSON, the card's name and
power limit, and {"ok": true, "device": {...}}.  Without a CUDA device, or
outside a checkout of the repository, it exits nonzero and prints no
result.  Imports nothing of JAX and nothing of the jpezy_tpu package.
"""
from __future__ import annotations

import json
import os
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
    the span includes the host's launch gaps; see _device_busy_ms."""
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


def _device_busy_ms(fn, reps: int):
    """Mean device-busy ms per call of fn: the durations of the kernels,
    copies and memsets torch.profiler traced on the card over `reps` calls
    (after one warm-up call), summed.  None if the trace holds no device
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / reps if us > 0 else None


def _fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.3f}"


def _images(n: int, seed0: int) -> np.ndarray:
    from imagegen import make_test_image

    return np.stack([make_test_image(H, W, seed=seed0 + i) for i in range(n)])


def _emissions(TC, HG, E, rgbs, dev):
    """Per-component (hi, lo, nbits) of a batch, as the main path makes them."""
    y, cb, cr = HG.host_rgb_to_ycc420(rgbs)
    q = TC._quantize_local_ycc(
        torch.from_numpy(y).to(dev), torch.from_numpy(cb).to(dev),
        torch.from_numpy(cr).to(dev), gray=False, dtype=torch.float32,
        rounded=False)
    out = []
    for qc, chroma in zip(q, (False, True, True)):
        pred = E.dc_predictors(qc[:, :, 0])
        out.append(E.block_emissions(qc.reshape(-1, 64), pred.reshape(-1),
                                     chroma))
    return out


def _worst_case_blocks(E, dev, nblocks: int = 4096, seed: int = 5):
    """Seeded blocks with all 63 AC coefficients nonzero, |v| <= 1023."""
    rng = np.random.default_rng(seed)
    q = rng.integers(1, 1024, size=(nblocks, 64)) * rng.choice([-1, 1], (nblocks, 64))
    q[:, 0] = rng.integers(-1024, 1017, size=nblocks)
    qt = torch.from_numpy(q.astype(np.int32)).to(dev)
    pred = E.dc_predictors(qt[:, 0])
    return [E.block_emissions(qt, pred, chroma) for chroma in (False, True)]


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

    # ---- 2. build the kernel from the checkout's sources
    secs = pack_cuda.build(force=True)
    pack_cuda.get_lib()
    ptxas = [ln.strip() for ln in pack_cuda.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    _say("2 build", f"pack_words.cu built for sm_90a in {secs:.2f} s; "
         + " | ".join(ptxas))

    # ---- 3. kernel against the plain torch pack
    real = _emissions(TC, HG, E, _images(BATCH, 0), dev)
    worst = _worst_case_blocks(E, dev)
    max_err = 0
    for label, ems in (("real", real), ("worst", worst)):
        for hi, lo, nb in ems:
            wk, bk = pack_cuda.pack_words_cuda(hi, lo, nb)
            wp, bp = E.pack_block_words_plain(hi, lo, nb)
            torch.cuda.synchronize()
            err = max(int((wk - wp).abs().max()),
                      int((bk.to(torch.int64) - bp.to(torch.int64)).abs().max()))
            max_err = max(max_err, err)
            if err:
                raise AssertionError(f"pack kernel != plain pack on {label} "
                                     f"emissions [{hi.shape[0]}, 64]")
    worst_bits = max(int(E.pack_block_words_plain(*w)[1].max()) for w in worst)
    if worst_bits <= 32 * 32:
        raise AssertionError(f"worst-case blocks reach only {worst_bits} bits")
    k_ms = sum(_time_ms(lambda e=e: pack_cuda.pack_words_cuda(*e), 20)
               for e in real)
    p_ms = sum(_time_ms(lambda e=e: E.pack_block_words_plain(*e), 5)
               for e in real)
    shapes = [tuple(e[0].shape) for e in real]
    _say("3 kernel", f"words and bits identical on real {shapes} and "
         f"worst-case blocks (max {worst_bits} bits/block); pack per "
         f"{BATCH}x{H}x{W} batch: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
         f"on {card}")
    del real, worst
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
    pack_cuda.launches = 0
    t0 = time.perf_counter()
    results = list(roundtrip_batches(batches, lookahead=1, device="cuda"))
    wall = time.perf_counter() - t0
    launches = pack_cuda.launches
    if launches == 0:
        raise AssertionError("the main path never launched the pack kernel")
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

    enc_ms, enc_busy = _time_ms(enc, 5), _device_busy_ms(enc, 5)
    flat_host, kw, _, _, _ = TC._decode_host_prep(
        results[0][0], gray=False, precision="fast", transport=None)
    flat_dev = torch.from_numpy(flat_host).to(dev)
    def dec():
        return TC._decode_fused_batch_ycc420(flat_dev, **kw)

    dec_ms, dec_busy = _time_ms(dec, 5), _device_busy_ms(dec, 5)
    _say("5 main", f"{MAIN_BATCHES} batches x {BATCH}x{H}x{W} fast "
         f"round trip: {len(streams)} streams decode; PSNR port "
         f"{p_rt:.4f} dB, host decode of port streams {p_hostdec:.4f} dB, "
         f"host exact round trip {p_ref:.4f} dB; pack launches {launches}; "
         f"per batch: encode event span {enc_ms:.3f} ms, device busy "
         f"{_fmt_ms(enc_busy)} ms; decode event span {dec_ms:.3f} ms, "
         f"device busy {_fmt_ms(dec_busy)} ms; "
         f"pipelined {mps:.3f} MP/s (wall {wall:.3f} s) on {card}")

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "jpezy_tpu"))
    if leaked:
        raise AssertionError(f"imported {leaked[:5]}")
    print(json.dumps({"kernels": [{
        "name": "pack_words", "route": "cuda",
        "source": "jpezy_tpu_torch/csrc/pack_words.cu",
        "replaces": "jpezy_tpu/ops/pack_pallas.py:27",
        "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
