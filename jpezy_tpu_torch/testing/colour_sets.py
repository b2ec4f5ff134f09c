"""Input sets of the rgb transport's colour stages, for their tests and
chip_smoke.py: an image whose 2x2 quads hold every RGB triple, planes that
hold every (Y, Cb, Cr) triple, and planes at the sampling factors a frame
may carry with samples past both clamps (ops/colorspace.rgb_to_ycc420,
planes_to_rgb).  No codec path calls this module."""
from __future__ import annotations

import numpy as np
import torch

# per sampling: each component's upsampling factors (dup_y, dup_x), and
# whether the decode is gray (component 0 alone)
SAMPLINGS = {"4:2:0": (((1, 1), (2, 2), (2, 2)), False),
             "4:2:2": (((1, 1), (1, 2), (1, 2)), False),
             "4:4:4": (((1, 1), (1, 1), (1, 1)), False),
             "4:1:1": (((1, 1), (1, 4), (1, 4)), False),
             "3x horizontal": (((1, 1), (1, 3), (1, 3)), False),
             "luma upsampled": (((2, 1), (1, 1), (1, 2)), False),
             "1 component": (((1, 1),), True),
             "gray": (((1, 1), (2, 2), (2, 2)), True)}


def geom_of(dups) -> tuple:
    """A decode geom whose entries carry the given (dup_y, dup_x) (the
    colour stage reads nothing else of it)."""
    return tuple((1, 1, 1, 1, dy, dx) for dy, dx in dups)


def sampling_planes(dups, n: int, rows: int, cols: int, seed: int,
                    device="cpu") -> list:
    """One unclamped int32 plane [n, rows / dy, cols / dx] a component
    (rows divisible by every dup_y, cols by every dup_x), samples from -400
    to 699, past both clamps of the colour conversion."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(
        -400, 700, (n, rows // dy, cols // dx), dtype=np.int32)).to(device)
        for dy, dx in dups]


def triple_quads(device="cpu", stride: int = 1) -> torch.Tensor:
    """[1, 2 S, 2 S, 3] uint8, S = 4096 / sqrt(stride) rounded to a power of
    two: every stride-th RGB triple t (r = t >> 16, g = t >> 8 & 255, b =
    t & 255) fills one 2x2 quad, so each reaches the luma at four pixels
    and the chroma at the quad's top-left.  stride 1: all 2^24 triples, an
    8192 x 8192 image (201 MB)."""
    side = 4096
    while side * side > (1 << 24) // stride:
        side //= 2
    t = torch.arange(side * side, dtype=torch.int64, device=device) * stride
    rgb = torch.stack([(t >> 16) & 255, (t >> 8) & 255, t & 255],
                      -1).to(torch.uint8).reshape(side, side, 3)
    return rgb.repeat_interleave(2, 0).repeat_interleave(2, 1)[None]


def ycc_triple_planes(device="cpu") -> list:
    """Three int32 planes [1, 4096, 4096] at 4:4:4 holding every (Y, Cb,
    Cr) triple of 0..255 once: the decoded samples' usual range, whose
    colour conversion reaches both clamps."""
    t = torch.arange(1 << 24, dtype=torch.int32, device=device)
    return [((t >> s) & 255).reshape(1, 4096, 4096) for s in (16, 8, 0)]
