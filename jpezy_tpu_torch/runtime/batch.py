"""Mixed-size batches over jpezy_tpu_torch.codec.torch_codec.

Counterpart of jpezy_tpu/runtime/batch.py.  Images are grouped by their
padded (MCU-aligned) size; each group of two or more is edge-replicated to
that size and encoded as one uniform device batch, and each stream is
re-headered with its image's true size (the MCU grid is the same, so the
scan is unchanged and a decoder crops the padded edges).  Streams are
grouped by size and component layout and decoded as device batches.
Singletons take the single-image entry points.  Output order matches
input order.
"""
from __future__ import annotations

import collections

import numpy as np
import torch


def mcu_pad(x: int) -> int:
    return -(-x // 16) * 16


def decode_mixed(streams: list[bytes], *, gray: bool = False,
                 precision: str = "fast",
                 device: str | torch.device = "cuda") -> list[np.ndarray]:
    """Decode a list of JPEGs of mixed geometry -> [H, W, 3] uint8 each."""
    from ..bitstream.reader import parse
    from ..codec import torch_codec

    groups: dict[tuple, list[int]] = collections.defaultdict(list)
    for i, s in enumerate(streams):
        pj = parse(s)
        key = (
            pj.props.width, pj.props.height,
            tuple((fc.H, fc.V, fc.Tq) for fc in pj.frame_components),
        )
        groups[key].append(i)

    out: list[np.ndarray | None] = [None] * len(streams)
    for idxs in groups.values():
        if len(idxs) == 1:
            i = idxs[0]
            r, g, b, _ = torch_codec.decode(streams[i], gray=gray,
                                            precision=precision,
                                            device=device)
            out[i] = np.stack([r, g, b], axis=-1)
        else:
            batch, _ = torch_codec.decode_batch(
                [streams[i] for i in idxs], gray=gray, precision=precision,
                device=device)
            for j, i in enumerate(idxs):
                out[i] = batch[j]
    return out  # type: ignore[return-value]


def encode_mixed(images: list[np.ndarray], *, gray: bool = False,
                 precision: str = "fast", rounded: bool = False,
                 device: str | torch.device = "cuda") -> list[bytes]:
    """Encode a list of [H, W, 3] uint8 images of mixed sizes."""
    from ..bitstream import writer
    from ..codec import torch_codec
    from ..core.props import make_encode_props

    groups: dict[tuple[int, int], list[int]] = collections.defaultdict(list)
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        groups[(mcu_pad(h), mcu_pad(w))].append(i)

    out: list[bytes | None] = [None] * len(images)
    for (ph, pw), idxs in groups.items():
        if len(idxs) == 1:
            i = idxs[0]
            im = images[i]
            out[i] = torch_codec.encode(
                im[..., 0], im[..., 1], im[..., 2], gray=gray,
                precision=precision, rounded=rounded, device=device)
            continue
        batch = np.stack([
            np.pad(images[i],
                   ((0, ph - images[i].shape[0]), (0, pw - images[i].shape[1]),
                    (0, 0)), mode="edge")
            for i in idxs
        ])
        streams = torch_codec.encode_batch(
            batch, gray=gray, precision=precision, rounded=rounded,
            device=device)
        old_hdr = writer.write_header(make_encode_props(pw, ph, gray=gray))
        for j, i in enumerate(idxs):
            h, w = images[i].shape[:2]
            if (h, w) == (ph, pw):
                out[i] = streams[j]
            else:
                hdr = writer.write_header(make_encode_props(w, h, gray=gray))
                out[i] = hdr + streams[j][len(old_hdr):]
    return out  # type: ignore[return-value]
