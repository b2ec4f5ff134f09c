"""Faults planted under the timed path, and the control, for the checks of
the judge itself (tests/test_faults.py, calibrate.py).

Each fault wraps the port's finish stage of the cell's direction, where an
answer is produced, and breaks what it hands back:

- `altered`: one answer of each batch altered where it is produced (a
  stream: a byte of its entropy-coded data changed; pixels: an image's
  samples inverted);
- `half_batch`: the second half of each batch left out;
- `stale`: the stage hands back its previous batch's result, its state
  unchanged, from the second batch on.

A cell on one chip has no exchange between chips to leave out.
"""
from __future__ import annotations

import math

import numpy as np

from . import workload as W

FAULTS = ("altered", "half_batch", "stale")


def _alter_stream(s: bytes) -> bytes:
    """Change one byte in the middle of the entropy-coded data (neither it
    nor its neighbours 0xFF, so the marker structure stays)."""
    b = bytearray(s)
    sos = s.rfind(b"\xff\xda")
    i = (sos + len(s)) // 2
    while 0xFF in b[i - 1:i + 2]:
        i += 1
    b[i] ^= 0x2A
    return bytes(b)


def plant(module, direction: str, fault: str):
    """Wrap module.<direction>_batch_finish with `fault`; returns the
    function that undoes it."""
    name = f"{direction}_batch_finish"
    original = getattr(module, name)
    state = {}

    def finish(ticket):
        out = original(ticket)
        if fault == "stale":
            prev, state["prev"] = state.get("prev", out), out
            return prev
        if direction == "encode":
            out = list(out)
            if fault == "altered":
                out[0] = _alter_stream(out[0])
            elif fault == "half_batch":
                out = out[:len(out) // 2]
            return out
        pixels, props = out
        if fault == "altered":
            pixels = pixels.copy()
            pixels[0] = 255 - pixels[0]
        elif fault == "half_batch":
            pixels = pixels[:len(pixels) // 2]
        return pixels, props

    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    setattr(module, name, finish)
    return lambda: setattr(module, name, original)


def control_window(cell, inputs, ref, precision: str = "tf32") -> W.Window:
    """The reference in the program's place, at `precision`: a window of
    every distinct batch of the cell, each answer what the reference
    computes for its image at that precision."""
    cfg = cell.config
    n, b = int(cfg["images"]), int(cell.traffic["batch"])
    h, w = int(cfg["height"]), int(cfg["width"])
    kw = W.coding_kwargs(cfg)
    if cell.traffic["direction"] == "encode":
        outs = [ref.encode(ref.quantised_blocks(im, kw["quality"], precision),
                           w, h, **kw) for im in inputs.rgb]
    else:
        outs = [ref.pixels(c, h, w, kw["quality"], precision)
                for c in inputs.coefs]
    win = W.Window(batches=[], kept=[], t0=0.0, t1=1.0)
    for k in range(n // math.gcd(n, b)):
        batch = [outs[(k * b + i) % n] for i in range(b)]
        win.batches.append(W.Batch(t_submit=0.0, t_yield=1.0, answers=b,
                                   out_bytes=sum(len(o) for o in batch)))
        win.kept.append((k, batch if isinstance(batch[0], bytes)
                         else np.stack(batch)))
    return win
