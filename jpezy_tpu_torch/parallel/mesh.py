"""The ('data', 'tile') mesh of the sharded codec, on torch.distributed.

Counterpart of jpezy_tpu/parallel/mesh.py.  The canonical mesh has two
dimensions:
  - 'data': independent images (pure data parallelism, no collectives);
  - 'tile': contiguous MCU-row ranges of each image (the DC-predictor carry
    and the gather of the shards' streams or pixel rows run between the
    ranks of one tile row).

The JAX layer is single-controller: one process drives every device of a
Mesh.  Here the idiom is SPMD, one rank per shard: rank r of a world of
data * tile ranks sits at data row r // tile and tile column r % tile.
Each rank holds the process group of its own tile row; collectives over
both dimensions use the default (world) group.  A 1x1 mesh needs no
process group at all, so the whole layer runs in one process, as
make_mesh(1, 1) does in JAX.

Mesh is a small class rather than torch.distributed.device_mesh.DeviceMesh:
a DeviceMesh needs (or creates) the default process group even at 1x1,
and picks each rank's card from its local rank, where ranks that share
one card (gloo) all name the same device.  Here the device is explicit.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..device import resolve


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a data x tile mesh.

    rank: this rank's index in the world (row-major over (data, tile)).
    tile_group: the process group of this rank's tile row; None when
    tile == 1 (the tile collectives are then the identity).  Collectives
    over the world use the default group, which exists whenever
    data * tile > 1."""

    data: int
    tile: int
    device: torch.device
    rank: int = 0
    tile_group: object = None

    @property
    def world(self) -> int:
        return self.data * self.tile

    @property
    def data_index(self) -> int:
        return self.rank // self.tile

    @property
    def tile_index(self) -> int:
        return self.rank % self.tile


def make_mesh(data: int = 1, tile: int | None = None, *,
              device: str | torch.device = "cuda") -> Mesh:
    """The data x tile mesh over the ranks of the default process group
    (one process, no group, for 1x1).  data * tile must equal the world
    size; tile defaults to world // data.  device: this rank's device
    (default "cuda", the rank's current card; raises without one, see
    device.resolve).

    Every rank must call it, in the same order as its other group
    creations: it makes the process group of every tile row."""
    dev = resolve(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if tile is None:
        tile = world // data
    if data < 1 or tile < 1 or data * tile != world:
        raise ValueError(f"mesh {data}x{tile} needs a world of {data * tile}"
                         f" ranks; this one has {world}")
    rank = dist.get_rank() if world > 1 else 0
    tile_group = None
    if tile > 1:
        for d in range(data):
            group = dist.new_group(list(range(d * tile, (d + 1) * tile)))
            if d == rank // tile:
                tile_group = group
    return Mesh(data, tile, dev, rank, tile_group)
