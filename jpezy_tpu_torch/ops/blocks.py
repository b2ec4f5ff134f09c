"""Plane <-> block layout transforms over image batches (torch).

Counterpart of jpezy_tpu/ops/blocks.py.  Pure reshape/permute; block order
matches the reference MCU walk: MCUs raster row-major, luma blocks
TL,TR,BL,BR within an MCU, component blocks raster within an MCU on decode.
"""
from __future__ import annotations

import torch


def pad_replicate(plane: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """Edge replication of [..., H, W] planes to [..., ph, pw]."""
    h, w = plane.shape[-2:]
    if (h, w) == (ph, pw):
        return plane
    rows = torch.arange(ph, device=plane.device).clamp(max=h - 1)
    cols = torch.arange(pw, device=plane.device).clamp(max=w - 1)
    return plane[..., rows[:, None], cols[None, :]]


def upsample_nearest(plane: torch.Tensor, dup_y: int,
                     dup_x: int) -> torch.Tensor:
    """Nearest-neighbour duplication of [..., H, W] planes."""
    if dup_y == 1 and dup_x == 1:
        return plane
    return plane.repeat_interleave(dup_y, dim=-2).repeat_interleave(
        dup_x, dim=-1)


def decimate_420(plane: torch.Tensor) -> torch.Tensor:
    """4:2:0 decimation of [..., H, W] planes: top-left of each 2x2, no
    averaging."""
    return plane[..., 0::2, 0::2]


def blockify_luma(y: torch.Tensor) -> torch.Tensor:
    """[N, H16, W16] -> [N, nmcu*4, 64], MCU order TL,TR,BL,BR."""
    n = y.shape[0]
    my, mx = y.shape[1] // 16, y.shape[2] // 16
    b = y.reshape(n, my, 2, 8, mx, 2, 8)
    b = b.permute(0, 1, 4, 2, 5, 3, 6)
    return b.reshape(n, my * mx * 4, 64)


def blockify_chroma(c: torch.Tensor) -> torch.Tensor:
    """[N, H8, W8] decimated chroma -> [N, nmcu, 64]."""
    n = c.shape[0]
    my, mx = c.shape[1] // 8, c.shape[2] // 8
    b = c.reshape(n, my, 8, mx, 8).permute(0, 1, 3, 2, 4)
    return b.reshape(n, my * mx, 64)


def deblockify(blocks: torch.Tensor, mcus_y: int, mcus_x: int,
               v: int, h: int) -> torch.Tensor:
    """[N, B, 64] MCU-ordered component blocks ->
    planes [N, mcus_y*v*8, mcus_x*h*8]."""
    n = blocks.shape[0]
    b = blocks.reshape(n, mcus_y, mcus_x, v, h, 8, 8)
    return b.permute(0, 1, 3, 5, 2, 4, 6).reshape(
        n, mcus_y * v * 8, mcus_x * h * 8)
