"""Profiling helpers: reference-style section timing, a torch.profiler
trace of the card, and a static cost model of the codec's device stages.

Counterpart of jpezy_tpu/utils/profiling.py (SURVEY.md section 5: the
reference only has RAII wall-clock messengers).

Profile after timing, never in the timed process: once torch.profiler has
traced in a process, every later launch costs the host more (PERF.md
section 6), so a wall clock taken after a trace reads slow.
"""
from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler trace of the CPU and, where there is one, the CUDA
    card over the block; writes a chrome trace (trace.json, open it in
    chrome://tracing or Perfetto) into logdir.  Yields the profiler, whose
    key_averages() sum the time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def encode_flops(width: int, height: int) -> dict:
    """Static cost model for one image encode (fast path)."""
    mcus = -(-height // 16) * -(-width // 16)
    blocks = mcus * 6
    return {
        "dct_flops": blocks * 64 * 64 * 2,          # [B,64]@[64,64]
        "color_flops": width * height * 3 * 5,       # 3 planes x ~5 madds
        "entropy_vpu_ops": blocks * 64 * 40,         # emissions + pack
        "hbm_bytes": width * height * 3 + blocks * 64 * 4 * 3,
        "blocks": blocks,
    }


class Stopwatch:
    """Accumulating named stopwatch for pipeline stage attribution."""

    def __init__(self):
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        width = max((len(k) for k in self.totals), default=0)
        return "\n".join(
            f"{k.ljust(width)}  {v * 1000:8.2f} ms"
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        )
