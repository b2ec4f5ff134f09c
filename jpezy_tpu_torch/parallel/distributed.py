"""Process-group start-up and per-rank placement for the sharded codec.

Counterpart of jpezy_tpu/parallel/distributed.py.  Every rank calls
initialize() once (torchrun's environment, or an explicit init_method,
world size and rank), builds the mesh with make_global_mesh(), and feeds
the images of its own data row: make_global_from_local() cuts its tile's
rows and places them on its device (the JAX make_global_batch and
make_global_from_local in one), so no image bytes cross between data
rows.
The 'data' axis carries no collective; the DC carry and the gathers run
in each rank's tile group.

Backend: the caller's process group names it.  NCCL is for ranks on
distinct cards.  gloo is for ranks on the CPU and for ranks that share one
card (NCCL refuses two ranks on one device); under gloo the collectives
of parallel/sharded.py stage their few bytes through host memory while
the kernels run on the card.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh


def initialize(init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               backend: str | None = None) -> None:
    """dist.init_process_group with torchrun's environment (WORLD_SIZE,
    RANK, MASTER_ADDR, MASTER_PORT) as the fallback; a no-op for one
    process.  init_method: e.g. "tcp://localhost:<port>" or
    "file://<path>"; backend: "nccl", "gloo", or None for torch's
    default (gloo for CPU tensors, NCCL for CUDA ones).

    Where LOCAL_RANK names a card of this host (torchrun sets it), that
    card becomes the rank's current one, so device="cuda" in
    make_global_mesh is the rank's own card.  Ranks that share one card
    (more local ranks than cards) keep the current card and must take
    backend="gloo"; NCCL refuses two ranks on one device."""
    local = os.environ.get("LOCAL_RANK")
    if (local is not None and torch.cuda.is_available()
            and int(local) < torch.cuda.device_count()):
        torch.cuda.set_device(int(local))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size == 1:
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def make_global_mesh(data: int | None = None, tile: int | None = None, *,
                     device: str | torch.device = "cuda") -> Mesh:
    """The mesh over every rank.  Default: 'tile' spans the ranks of one
    host (torchrun's LOCAL_WORLD_SIZE), 'data' spans the hosts, so the
    carry and the gathers stay on a host's interconnect."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if tile is None:
        tile = (world // data if data is not None
                else int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if data is None:
        data = world // tile
    return make_mesh(data, tile, device=device)


def make_global_from_local(mesh: Mesh, local: np.ndarray) -> torch.Tensor:
    """This rank's tile of a rank-local host array whose axis 1 splits
    over 'tile' (image rows, restart segments), on its device."""
    n = local.shape[1]
    if n % mesh.tile:
        raise ValueError(f"axis 1 of {n} does not divide over {mesh.tile} "
                         "tile shards")
    k = n // mesh.tile
    t = mesh.tile_index
    return torch.from_numpy(
        np.ascontiguousarray(local[:, t * k:(t + 1) * k])).to(mesh.device)



def replicate_global(mesh: Mesh, lut: np.ndarray) -> torch.Tensor:
    """The decode LUT on this rank's device.  Every rank builds it from
    the same headers, so no bytes move between ranks; the upload is cached
    by content (ops/entropy_decode.device_lut)."""
    from ..ops.entropy_decode import device_lut

    return device_lut(lut, mesh.device)


def gather_local_rows(mesh: Mesh, part: torch.Tensor) -> np.ndarray:
    """[N, rows, ...] rows of this rank's tile -> host [N, tile * rows,
    ...]: the tile group's rows in order, on every rank of the group."""
    from .sharded import gather_tiles

    g = gather_tiles(mesh, part)
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])
