"""Spans around the port's layers and one torch.profiler window.

The traced run wraps the four functions the pipeline's stage threads call
(`torch_codec.encode_batch_dispatch`/`_finish`,
`decode_batch_dispatch`/`_finish`): each call is a span on the host's clock
and a `record_function` range in the profiler, which puts the host's spans
and the card's operations on one timeline.  The trace is exported as a
chrome trace into a temporary directory and read back from it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import threading
import time

WRAPPED = ("encode_batch_dispatch", "encode_batch_finish",
           "decode_batch_dispatch", "decode_batch_finish")
WINDOW = "codec_bench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host spans (name, start, end) of the wrapped calls while `on`."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []
        self.on = False
        self._lock = threading.Lock()

    def wrap(self, module, names=WRAPPED):
        """Replace module.<name> by a recording wrapper; returns a function
        that puts the originals back."""
        import torch

        originals = {n: getattr(module, n) for n in names}

        def wrapper(name, fn):
            def call(*args, **kwargs):
                if not self.on:
                    return fn(*args, **kwargs)
                t0 = time.perf_counter()
                try:
                    with torch.profiler.record_function(name):
                        return fn(*args, **kwargs)
                finally:
                    t1 = time.perf_counter()
                    with self._lock:
                        self.items.append((name, t0, t1))
            return call

        for n, fn in originals.items():
            setattr(module, n, wrapper(n, fn))

        def restore():
            for n, fn in originals.items():
                setattr(module, n, fn)
        return restore

    def durations(self, name: str) -> list[float]:
        return [t1 - t0 for n, t0, t1 in self.items if n == name]


@dataclasses.dataclass
class DeviceTrace:
    """What one profiled window read: seconds on the profiler's clock."""
    window_s: float
    busy_s: float
    kernel_s: float
    events: int
    ops: list  # [name, seconds] by summed time, largest first
    gaps: list  # [host activity, seconds], longest first

    def breakdown(self, top: int = 10) -> dict:
        return {"device_ops": self.ops[:top], "idle_gaps": self.gaps[:top]}


@contextlib.contextmanager
def profiled(store: dict, cuda: bool = True):
    """Profile the block (CPU and, with `cuda`, CUDA activity) inside a
    WINDOW range; on exit store["trace"] holds the DeviceTrace read from
    it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                t_window = time.perf_counter()
                yield
                if cuda:
                    torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            store["trace"] = read_trace(json.load(f), store.get("spans", ()),
                                        t_window)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_trace(data: dict, spans=(), t_window: float = 0.0) -> DeviceTrace:
    """A chrome trace (torch.profiler's export) -> DeviceTrace over the
    WINDOW range: device operations (kernels, copies, memsets) clipped to
    it, their union, the kernels' summed time, the operations' time by
    name, and the idle gaps between them labelled by the host spans
    (name, start, end on the host's clock, whose t_window is the range's
    start) running at the gap's middle."""
    evs = [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]
    wins = [e for e in evs if e.get("name") == WINDOW
            and e.get("cat") == "user_annotation"]
    if not wins:
        raise ValueError("the trace holds no window range")
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    dev, by_name, kernel_us = [], {}, 0.0
    for e in evs:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a = max(w0, float(e["ts"]))
        b = min(w1, float(e["ts"]) + float(e["dur"]))
        if b <= a:
            continue
        dev.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
        if e["cat"] == "kernel":
            kernel_us += b - a
    host = [(w0 + (t0 - t_window) * 1e6, w0 + (t1 - t_window) * 1e6, n)
            for n, t0, t1 in spans]
    busy = _merge(dev)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = []
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            label = "+".join(sorted({n for s, t, n in host if s <= mid < t}))
            gaps.append([label or "no wrapped call", (b - a) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(([n, s * 1e-6] for n, s in by_name.items()),
                 key=lambda o: -o[1])
    return DeviceTrace(window_s=(w1 - w0) * 1e-6,
                       busy_s=sum(b - a for a, b in busy) * 1e-6,
                       kernel_s=kernel_us * 1e-6, events=len(dev), ops=ops,
                       gaps=gaps)
