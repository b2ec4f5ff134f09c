"""Pipelined batch codec over jpezy_tpu_torch.codec.torch_codec.

Counterpart of jpezy_tpu/runtime/pipeline.py, with the same stage threads:

    S1 encode-dispatch   host color (C++ MT) + upload + device work queued
    S2 encode-finish     blocking stream fetch + JFIF assembly
    S3 decode-dispatch   marker parse + entropy frontend (C++) + upload
    S4 decode-finish     blocking plane fetch + color tail (C++ MT)

One worker per stage keeps per-stage FIFO order, so results come out in
input order, and stage k of batch i runs beside stage k-1 of batch i+1.
All CUDA work goes to the device's current stream; the fetches in S2/S4
are where a stage waits for it.  `lookahead` bounds the batches in flight
beyond the current one.
"""
from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Iterable, Iterator

import numpy as np
import torch

from ..codec import torch_codec


class _StagePipeline:
    """Run each item through `stages` (one single-worker thread per stage),
    bounded in flight, yielding results in input order."""

    def __init__(self, stages, max_inflight: int):
        self._stages = stages
        self._pools = [
            cf.ThreadPoolExecutor(1, thread_name_prefix=f"jz-torch-stage{i}")
            for i in range(len(stages))
        ]
        self._max = max(1, max_inflight)

    def run(self, items: Iterable) -> Iterator:
        inflight: collections.deque = collections.deque()
        try:
            for item in items:
                inflight.append(self._chain(item))
                if len(inflight) >= self._max:
                    yield inflight.popleft().result()
            while inflight:
                yield inflight.popleft().result()
        finally:
            for p in self._pools:
                p.shutdown(wait=True, cancel_futures=True)

    def _chain(self, item):
        fut = self._pools[0].submit(self._stages[0], item)
        for pool, fn in zip(self._pools[1:], self._stages[1:]):
            fut = pool.submit(
                (lambda f, g: lambda: g(f.result()))(fut, fn))
        return fut


def encode_batches(batches: Iterable[np.ndarray], *, lookahead: int = 1,
                   gray: bool = False, precision: str = "fast",
                   rounded: bool = False, quality: int | None = None,
                   restart_interval: int = 0, optimize: bool = False,
                   device: str | torch.device = "cuda"
                   ) -> Iterator[list[bytes]]:
    """Encode an iterable of uniform [N, H, W, 3] u8 batches, pipelined.

    Yields one list[bytes] of JFIF streams per input batch, in order."""
    def s1(rgbs):
        return torch_codec.encode_batch_dispatch(
            rgbs, gray=gray, precision=precision, rounded=rounded,
            quality=quality, restart_interval=restart_interval,
            optimize=optimize, device=device)

    pipe = _StagePipeline([s1, torch_codec.encode_batch_finish],
                          lookahead + 1)
    return pipe.run(batches)


def decode_batches(stream_lists: Iterable[list[bytes]], *, lookahead: int = 1,
                   gray: bool = False, precision: str = "fast",
                   transport: str | None = None,
                   device: str | torch.device = "cuda"
                   ) -> Iterator[tuple[np.ndarray, object]]:
    """Decode an iterable of uniform-geometry JPEG batch lists, pipelined.

    Yields ([N, H, W, 3] uint8, ImageProps) per batch, in order."""
    def s1(streams):
        return torch_codec.decode_batch_dispatch(
            streams, gray=gray, precision=precision, transport=transport,
            device=device)

    pipe = _StagePipeline([s1, torch_codec.decode_batch_finish],
                          lookahead + 1)
    return pipe.run(stream_lists)


def roundtrip_batches(batches: Iterable[np.ndarray], *, lookahead: int = 1,
                      gray: bool = False, precision: str = "fast",
                      rounded: bool = False, restart_interval: int = 0,
                      transport: str | None = None,
                      device: str | torch.device = "cuda"
                      ) -> Iterator[tuple[list[bytes], np.ndarray]]:
    """Encode then decode each batch, pipelined end to end.

    Yields (streams, decoded_pixels) per batch.  Every image is encoded to
    complete JFIF bytes on the host and decoded again from those bytes."""
    def s1(rgbs):
        return torch_codec.encode_batch_dispatch(
            rgbs, gray=gray, precision=precision, rounded=rounded,
            restart_interval=restart_interval, device=device)

    def s3(streams):
        return streams, torch_codec.decode_batch_dispatch(
            streams, gray=gray, precision=precision, transport=transport,
            device=device)

    def s4(args):
        streams, ticket = args
        pixels, _props = torch_codec.decode_batch_finish(ticket)
        return streams, pixels

    pipe = _StagePipeline([s1, torch_codec.encode_batch_finish, s3, s4],
                          lookahead + 1)
    return pipe.run(batches)
