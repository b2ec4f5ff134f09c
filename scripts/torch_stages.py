#!/usr/bin/env python3
"""Device stages of jpezy_tpu_torch's encode program on one CUDA card, per
batch of 16 RGB images at 512x512 (fast, 4:2:0), for comparing two trees
of the repository in one run.

    python3 scripts/torch_stages.py [TREE]

Imports jpezy_tpu_torch and the test images of TREE (default: the
checkout holding this script), builds its kernels there, and traces with
torch.profiler (5 calls after one warm-up) the device busy time, summed
over kernels, copies and memsets, and the number of device events of:
the encode program without and with restart_interval=8
(_encode_batch_blocks_packed), its entropy stage alone (_emit_local) and
its stream concat alone (_concat_batch_combined_comp), each without and
with restart_interval=8, the optimize path's symbol histograms with
restart_interval=8
(_symbol_histograms_batch) and its entropy coding with the 16 per-image
table sets (_encode_batch_custom).  Each stage's CUDA-event span, taken
before the first trace, is printed beside it.  The functions exist with
these signatures from PR 5 on, so an older tree (unpacked with
`git archive` into a directory that .gitignore lists) and this one can run
in turns in one call: old, new, new, old.  Prints the card's name and
power limit, then one JSON line.  Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

BATCH, H, W, RI, REPS = 16, 512, 512, 8, 5


def _profile(fn) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {"busy_ms": sum(e.self_device_time_total for e in dev) / 1e3 / REPS,
            "events": sum(e.count for e in dev) / REPS,
            "by_name": {e.key[:60]: round(e.self_device_time_total / 1e3
                                          / REPS, 5) for e in dev}}


def _span_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("torch_stages: no CUDA device available", file=sys.stderr)
        return 2
    tree = os.path.abspath(argv[0] if argv else
                           os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__))))
    sys.path[:0] = [tree, os.path.join(tree, "tests")]
    from imagegen import make_test_image
    from jpezy_tpu_torch.codec import host_glue as HG
    from jpezy_tpu_torch.codec import torch_codec as TC

    if not TC.__file__.startswith(tree):
        raise RuntimeError(f"imported {TC.__file__}, not from {tree}")
    dev = torch.device("cuda")
    rgbs = np.stack([make_test_image(H, W, seed=1000 + i)
                     for i in range(BATCH)])
    y, cb, cr = HG.host_rgb_to_ycc420(rgbs)
    packed = torch.from_numpy(np.concatenate(
        [y.reshape(BATCH, -1), cb.reshape(BATCH, -1), cr.reshape(BATCH, -1)],
        axis=1)).to(dev)
    q = TC._quantize_batch_ycc(packed, h=H, w=W)
    emitted = TC._emit_local(*q)
    emitted_r = TC._emit_local(*q, RI)
    hists = TC._symbol_histograms_batch(*q, restart_interval=RI).cpu().numpy()
    _, ytabs, ctabs = TC._optimal_tables(hists)
    stages = {
        "encode program": lambda: TC._encode_batch_blocks_packed(
            packed, h=H, w=W),
        "encode program, restart_interval=8":
            lambda: TC._encode_batch_blocks_packed(packed, h=H, w=W,
                                                   restart_interval=RI),
        "entropy (_emit_local)": lambda: TC._emit_local(*q),
        "entropy, restart_interval=8": lambda: TC._emit_local(*q, RI),
        "concat": lambda: TC._concat_batch_combined_comp(*emitted),
        "concat, restart_interval=8":
            lambda: TC._concat_batch_combined_comp(*emitted_r, RI),
        "symbol histograms, restart_interval=8":
            lambda: TC._symbol_histograms_batch(*q, restart_interval=RI),
        "optimize entropy + concat (_encode_batch_custom)":
            lambda: TC._encode_batch_custom(*q, ytabs, ctabs,
                                            restart_interval=RI),
    }
    t0 = time.perf_counter()
    spans = {k: _span_ms(fn) for k, fn in stages.items()}
    out = {k: dict(_profile(fn), span_ms=spans[k])
           for k, fn in stages.items()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"tree": tree, "card": card,
                      "seconds": time.perf_counter() - t0, "stages": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
