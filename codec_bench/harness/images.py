"""Seeded photo-like RGB images, made in bulk with NumPy.

The pattern of the repository's test images (smooth gradients, texture and
flat regions with hard edges), with the mid-frequency detail of photographs
added as octaves of bilinearly interpolated noise whose amplitude falls with
frequency.  Luminance detail is shared by the three channels and chroma
detail is weaker, as in photographs, so the 4:2:0 chroma blocks stay sparser
than the luma blocks.

Every seed gets the same ladder of detail levels, one an image, in an order
drawn from the seed: the work an image set asks of a codec barely moves
from seed to seed, while the pixels, their layout and the order differ.
"""
from __future__ import annotations

import numpy as np

OCTAVES = (2, 4, 8, 16, 32, 64)


def detail_ladder(count: int, lo: float, hi: float) -> np.ndarray:
    """count detail levels spread evenly over [lo, hi]."""
    return np.linspace(lo, hi, count) if count > 1 else np.array([lo])


def _interp(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] bilinear interpolation weights, the ends aligned."""
    pos = np.linspace(0, n_in - 1, n_out)
    lo = np.minimum(pos.astype(np.int64), n_in - 2)
    m = np.zeros((n_out, n_in), np.float32)
    m[np.arange(n_out), lo] = 1 - (pos - lo)
    m[np.arange(n_out), lo + 1] = pos - lo
    return m


def _octaves(h: int, w: int, rng: np.random.Generator, channels: int,
             detail: float) -> np.ndarray:
    """[channels, h, w] float32: the sum over OCTAVES of noise on a grid
    of that cell size, bilinearly interpolated, amplitude detail *
    sqrt(cell / largest cell)."""
    out = np.zeros((channels, h, w), np.float32)
    for s in OCTAVES:
        g = rng.standard_normal((channels, h // s + 2, w // s + 2),
                                np.float32)
        g *= detail * (s / OCTAVES[-1]) ** 0.5
        out += _interp(h, g.shape[1]) @ g @ _interp(w, g.shape[2]).T
    return out


def photo_like(h: int, w: int, rng: np.random.Generator,
               detail: float) -> np.ndarray:
    """One [h, w, 3] uint8 image; `detail` scales the noise octaves."""
    yy = np.linspace(0, 1, h)[:, None]
    xx = np.linspace(0, 1, w)[None, :]
    f = rng.uniform(0.5, 3.0, size=(3, 2))
    ph = rng.uniform(0, 2 * np.pi, size=(3, 2))
    base = np.stack(np.broadcast_arrays(
        128 + 90 * np.sin(2 * np.pi * f[0, 0] * xx + ph[0, 0])
        * np.cos(2 * np.pi * f[0, 1] * yy + ph[0, 1]),
        128 + 70 * np.cos(2 * np.pi * f[1, 0] * (xx + yy) + ph[1, 0]),
        128 + 80 * np.sin(2 * np.pi * f[2, 1] * yy + ph[2, 1])), axis=-1)
    img = base + _octaves(h, w, rng, 1, detail).transpose(1, 2, 0) \
        + _octaves(h, w, rng, 3, 0.3 * detail).transpose(1, 2, 0) \
        + rng.normal(0, 3, size=(h, w, 1))
    # flat regions with hard edges: a block of one colour, saturated bands
    y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
    img[y0:y0 + h // 4, x0:x0 + w // 4] = rng.integers(0, 256, size=3)
    band = max(1, int(rng.integers(h // 16, h // 8)))
    img[:band] = 255
    img[-band:] = 0
    return np.clip(img, 0, 255).astype(np.uint8)


def image_set(count: int, h: int, w: int, seed: int, detail_lo: float,
              detail_hi: float) -> np.ndarray:
    """[count, h, w, 3] uint8: the detail ladder in an order drawn from
    the seed, each image's pixels from its own stream of the seed."""
    root = np.random.SeedSequence(int(seed))
    order = np.random.default_rng(root.spawn(1)[0]).permutation(count)
    levels = detail_ladder(count, detail_lo, detail_hi)[order]
    return np.stack([photo_like(h, w, np.random.default_rng(s), d)
                     for s, d in zip(root.spawn(count), levels)])
