"""Shard-local codec steps and the collectives between shards.

Counterpart of jpezy_tpu/parallel/sharded.py.  Everything in the codec is
block-local except two sequential dependencies (SURVEY.md section 2.7):

  - the per-component DC predictor chain on encode: shard k's first
    predictor is shard k-1's last DC.  carry_in exchanges the [N, 3] last
    DCs in the tile group (the JAX ppermute);
  - the entropy bit cursor: each shard concatenates its own stream on its
    device (emit_stream), gather_tiles brings the tile group's streams to
    every rank of the group, and the host splices them (parallel/api.py).

The optimize encode derives one table set for the whole batch: sum_world
adds the symbol counts over every rank (the JAX psum over both axes).
Decode needs no collective at all: tile shards hold whole MCU rows, and
the 4:2:0 upsample and the colour conversion read within an MCU row.

The shard-local steps are pure functions of their inputs and the
carry-in, so one process can run every layout shard by shard.  The
collectives are the three small functions below; with tile == 1 (or a
1x1 mesh) they move nothing.  Under gloo the few bytes a collective moves
are staged through host memory (3 x N int32 of carry, 4 x 256 int32 of
counts, each shard's compressed stream or pixel rows): the kernels still
run on the card.

JAX function -> port:
  _encode_local / _encode_local_ycc -> torch_codec._quantize_batch_rgb
    (colour, 4:2:0 decimation, _quantize_local_ycc) on the tile's rows;
  make_sharded_encode, make_sharded_quantize -> quantize (with the carry
    and, for optimize, the summed counts);
  _emit_local, _concat_local_combined, make_sharded_encode_stream,
    make_sharded_emit_stream -> emit_stream: torch_codec._emit_local with
    the carry, then torch_codec._concat_batch_combined_comp with the
    caller's budget (one table set for the batch with optimize);
  _decode_local, make_sharded_decode_component, make_sharded_decode ->
    torch_codec._decode_fused_batch on tile_geom and tile_blocks;
  make_sharded_decode_device -> decode_device, which returns the scan's
    corruption flags (the JAX program drops them);
  shard_batch -> shard_batch.
_mesh_use_pallas chose between TPU packers; CUDA tensors have one route.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..codec import torch_codec as TC
from ..ops import entropy_decode as ED
from .mesh import Mesh

# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def _staging(mesh: Mesh, group) -> torch.device:
    """Where a collective's tensors live: the rank's card under NCCL, the
    host under gloo (ranks on the CPU, or ranks that share one card)."""
    if mesh.device.type == "cuda" and "nccl" in str(dist.get_backend(group)):
        return mesh.device
    return torch.device("cpu")


def _all_gather(mesh: Mesh, x: torch.Tensor, group) -> list[torch.Tensor]:
    dev = _staging(mesh, group)
    x = x.to(dev).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


def carry_in(mesh: Mesh, last: torch.Tensor) -> torch.Tensor:
    """[N, 3] last DC of each image's Y, Cb, Cr on this shard -> [N, 3]
    first predictors: the left neighbour's last DCs, zeros on tile shard
    0 (the JAX ppermute, as an all_gather in the tile group)."""
    if mesh.tile == 1:
        return torch.zeros_like(last)
    parts = _all_gather(mesh, last, mesh.tile_group)
    if mesh.tile_index == 0:
        return torch.zeros_like(last)
    return parts[mesh.tile_index - 1].to(last.device)


def sum_world(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x summed over every rank of the mesh (the JAX psum over
    ('data', 'tile')), on x's device."""
    if mesh.world == 1:
        return x
    y = x.to(_staging(mesh, None)).contiguous()
    dist.all_reduce(y)
    return y.to(x.device)


def gather_tiles(mesh: Mesh, x: torch.Tensor) -> np.ndarray:
    """[N, ...] per-shard rows -> host [N, tile, ...] of every shard of
    this rank's tile row, on every rank of the row."""
    if mesh.tile == 1:
        return x.cpu().numpy()[:, None]
    parts = _all_gather(mesh, x, mesh.tile_group)
    return torch.stack([p.cpu() for p in parts], dim=1).numpy()


# ---------------------------------------------------------------------------
# Shard-local steps
# ---------------------------------------------------------------------------


def last_dcs(q) -> torch.Tensor:
    """Quantized (yq, cbq, crq) [N, B_c, 64] -> [N, 3] last DC of each
    component chain: what the next tile shard takes as its carry."""
    return torch.stack([c[:, -1, 0] for c in q], dim=1).to(torch.int32)


def histograms_local(q, carry, *, restart_interval: int = 0):
    """Symbol counts [4, 256] int32 (Y-DC, Y-AC, C-DC, C-AC) of this
    shard's images, summed over them: the histogram kernel with the
    shard's block count per image, one launch for the three components."""
    return TC._symbol_histograms_batch(
        *q, restart_interval=restart_interval, carry=carry).sum(
            dim=0, dtype=torch.int32)


def emit_stream(q, carry, *, maxw: int, restart_interval: int = 0,
                tables=(None, None)) -> torch.Tensor:
    """Entropy-code this shard's quantized blocks from the carry-in and
    concatenate each image's stream on the device (the JAX _emit_local
    and _concat_local_combined).

    q: (yq, cbq, crq) [N, B_c, 64]; carry: [N, 3] first predictors;
    tables: (luma, chroma) Huffman tables, None or one set for the whole
    batch (optimize).  Returns combined [N, R + maxw] int64 holding words
    in [0, 2**32): column 0 the shard's total bits, then with
    restart_interval the shard's S per-segment bit counts, then the
    stream; each segment starts byte-aligned.  The caller keeps shard
    boundaries on segment boundaries."""
    wc, bc = TC._emit_local(*q, restart_interval, tables=tables, carry=carry)
    return TC._concat_batch_combined_comp(wc, bc, restart_interval,
                                          maxw=maxw)[0]


def tile_geom(geom, tile: int):
    """A frame's per-component (mcus_y, mcus_x, v, h, dup_y, dup_x) ->
    those of one of `tile` equal MCU-row shards."""
    return tuple((g[0] // tile,) + tuple(g[1:]) for g in geom)


def tile_blocks(coeff_all: np.ndarray, sizes, tile: int, t: int):
    """[N, sum(B_c), 64] coefficients of every component (MCU-raster
    order within each) -> (shard t's [N, sum(B_c) / tile, 64], its sizes).
    Each component's MCU rows are contiguous in its blocks."""
    parts, off = [], 0
    for n_b in sizes:
        k = n_b // tile
        parts.append(coeff_all[:, off + t * k: off + (t + 1) * k])
        off += n_b
    return (np.ascontiguousarray(np.concatenate(parts, axis=1)),
            tuple(n_b // tile for n_b in sizes))


def decode_device(words, nblk, lut, tsel, rawlen, *, n: int, ri: int, geom,
                  level: int, qtuple):
    """Full device decode of this shard's restart segments of n standard
    4:2:0 images: the Huffman scan (one lane a segment), then the rgb
    transport's program (dequantize, float32 IDCT, upsample, colour)
    (the JAX make_sharded_decode_device).

    words/nblk/tsel/rawlen: the shard's lanes, image-major; lut [T, 6,
    65536]; geom: the shard's (tile_geom), whose MCU rows the segments
    cover exactly; qtuple: one quant table per component.  Returns (rgb
    [n, H_tile, W_mcu, 3] uint8, bad [n] bool: a corrupt segment in the
    image), with the reference's clamp-after-colour pixels."""
    blocks, bad = ED.decode_segments(words, nblk, lut, tsel, rawlen,
                                     max_blocks=ri * 6)
    nm = geom[0][0] * geom[0][1]
    b6 = blocks.reshape(n, nm, 6, 64)
    coeff = torch.cat([b6[:, :, :4].reshape(n, nm * 4, 64), b6[:, :, 4],
                       b6[:, :, 5]], dim=1)
    rgb = TC._decode_fused_batch(coeff, geom=geom, level=level, gray=False,
                                 precision="fast", sizes=(4 * nm, nm, nm),
                                 qtuple=qtuple)
    return rgb, bad.reshape(n, -1).any(dim=1)


# ---------------------------------------------------------------------------
# Mesh programs
# ---------------------------------------------------------------------------


def quantize(mesh: Mesh, rgb: torch.Tensor, *, gray: bool = False,
             precision: str = "fast", rounded: bool = False,
             quality: int | None = None, restart_interval: int = 0,
             histograms: bool = False):
    """Pass 1 of the sharded encode on this rank's tile rows rgb [N,
    H_tile, W, 3] uint8: colour, decimation, DCT and quantize, then the
    carry exchange; with histograms (optimize), the symbol counts summed
    over the mesh.  Returns ((yq, cbq, crq), carry [N, 3], counts [4, 256]
    host int64 or None)."""
    q = TC._quantize_batch_rgb(rgb, gray=gray, precision=precision,
                               rounded=rounded, quality=quality)
    carry = carry_in(mesh, last_dcs(q))
    if not histograms:
        return q, carry, None
    counts = sum_world(mesh, histograms_local(
        q, carry, restart_interval=restart_interval))
    return q, carry, counts.cpu().numpy().astype(np.int64)


def shard_batch(mesh: Mesh, arr: np.ndarray) -> torch.Tensor:
    """This rank's block of a global host batch [N, H, ...]: the images of
    its data row and the rows of its tile, on its device (the JAX
    P('data', 'tile') placement).  N must divide over 'data'."""
    from .distributed import make_global_from_local

    n = arr.shape[0]
    if n % mesh.data:
        raise ValueError(f"a batch of {n} images does not divide over "
                         f"{mesh.data} data rows")
    k = n // mesh.data
    d = mesh.data_index
    return make_global_from_local(mesh, arr[d * k:(d + 1) * k])
