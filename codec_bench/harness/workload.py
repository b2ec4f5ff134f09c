"""The general generator of a traffic mix: inputs from the seed, warm-up, and
the closed loop of the measured window.

A traffic file (traffic/<mix>.json) gives:

    direction       "encode" (RGB arrays in, JFIF streams out) or
                    "decode" (JFIF streams in, RGB pixels out)
    batch           images a batch
    lookahead       batches the pipeline keeps in flight beyond the
                    current one
    warmup_batches  batches run before the window, of the cell's shapes
    judged_batches  batches of the window kept for the judge, a sample
                    drawn from the seed
    transport       the decode transport, or null for the port's choice

The configuration gives the image size, the count of distinct images, the
coding settings (`quality`, `restart_interval`, `precision`) and the
detail ladder of the image generator.  One client feeds batch k with images
(k * batch + i) mod images, so a run cycles over the same set, and waits
for results in order: a closed loop.
"""
from __future__ import annotations

import dataclasses
import math
import random
import time

import numpy as np

from . import images as I


@dataclasses.dataclass
class Inputs:
    """What set-up made from the seed: the images, the cell's distinct
    batches and, for decode, the quantised blocks the reference coded into
    the input streams (the judge turns them into pixels) and the streams'
    entropy-coded bytes."""
    rgb: np.ndarray
    batches: list
    coefs: list | None = None
    entropy_bytes: list | None = None


@dataclasses.dataclass
class Batch:
    t_submit: float
    t_yield: float = math.nan
    answers: int = 0
    out_bytes: int = 0  # encode: bytes of the batch's streams


@dataclasses.dataclass
class Window:
    batches: list
    # (batch index, its per-image outputs) of the batches kept for the judge
    kept: list
    t0: float = math.nan
    t1: float = math.nan

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def coding_kwargs(config: dict) -> dict:
    return dict(quality=config.get("quality"),
                restart_interval=int(config.get("restart_interval", 0)))


def prepare(cell, seed: int, ref) -> Inputs:
    """Images from the seed; for decode cells, the reference's streams."""
    cfg, tr = cell.config, cell.traffic
    n, h, w = int(cfg["images"]), int(cfg["height"]), int(cfg["width"])
    lo, hi = cfg["image_detail"]
    rgb = I.image_set(n, h, w, seed, lo, hi)
    inputs = Inputs(rgb=rgb, batches=[])
    items = rgb
    if tr["direction"] == "decode":
        kw = coding_kwargs(cfg)
        inputs.coefs = [ref.quantised_blocks(im, kw["quality"]) for im in rgb]
        items = [ref.encode(c, w, h, **kw) for c in inputs.coefs]
        inputs.entropy_bytes = [entropy_bytes(ref, s) for s in items]
    b = int(tr["batch"])
    period = n // math.gcd(n, b)
    for k in range(period):
        idx = [(k * b + i) % n for i in range(b)]
        inputs.batches.append(np.ascontiguousarray(rgb[idx])
                              if tr["direction"] == "encode"
                              else [items[i] for i in idx])
    return inputs


def entropy_bytes(ref, stream: bytes) -> int:
    """Bytes between the end of the stream's SOS header and its EOI."""
    return len(stream) - ref.parse(stream)["data"] - 2


def pipeline(cell, feed, device):
    """The port's pipelined entry for the cell's direction over `feed`."""
    from jpezy_tpu_torch.runtime import pipeline as P

    cfg, tr = cell.config, cell.traffic
    if tr["direction"] == "encode":
        return P.encode_batches(feed, lookahead=int(tr["lookahead"]),
                                precision=cfg["precision"], device=device,
                                **coding_kwargs(cfg))
    return P.decode_batches(feed, lookahead=int(tr["lookahead"]),
                            precision=cfg["precision"],
                            transport=tr.get("transport"), device=device)


def warm_up(cell, inputs: Inputs, device) -> None:
    """Run warmup_batches through the pipeline and wait for them."""
    count = int(cell.traffic["warmup_batches"])
    feed = (inputs.batches[k % len(inputs.batches)] for k in range(count))
    for _ in pipeline(cell, feed, device):
        pass


def _outputs(cell, out):
    """Per-image outputs of one pipeline result: a list of streams, or an
    [N, H, W, 3] array of pixels."""
    return out if cell.traffic["direction"] == "encode" else out[0]


def run_window(cell, inputs: Inputs, seconds: float, device, seed: int,
               clock=time.perf_counter) -> Window:
    """The measured window: batches handed in until `seconds` after the
    first, every one of them drained and counted.  The loop only times and
    counts; it keeps `judged_batches` of the window's batches for the judge,
    a uniform sample drawn from the seed (reservoir sampling), by reference
    and without copying, so that the judge's work stays out of the window."""
    b = int(cell.traffic["batch"])
    keep = int(cell.traffic["judged_batches"])
    encode = cell.traffic["direction"] == "encode"
    rng = random.Random(seed)
    win = Window(batches=[], kept=[])
    deadline = math.inf

    def feed():
        nonlocal deadline
        k = 0
        while True:
            now = clock()
            if k == 0:
                win.t0, deadline = now, now + seconds
            elif now >= deadline:
                return
            win.batches.append(Batch(t_submit=now))
            yield inputs.batches[k % len(inputs.batches)]
            k += 1

    for k, out in enumerate(pipeline(cell, feed(), device)):
        t = clock()
        bt = win.batches[k]
        bt.t_yield = t
        outs = _outputs(cell, out)
        bt.answers = min(len(outs), b)
        if encode:
            bt.out_bytes = sum(len(s) for s in outs[:b])
        j = k if k < keep else rng.randrange(k + 1)
        if j < keep:
            if k < keep:
                win.kept.append((k, outs))
            else:
                win.kept[j] = (k, outs)
        win.t1 = t
    win.kept.sort(key=lambda x: x[0])
    return win
