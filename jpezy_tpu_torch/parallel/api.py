"""Sharded codec entry points, one rank per shard.

Counterpart of jpezy_tpu/parallel/api.py.

encode_sharded: this rank's images -> JFIF streams, with the DC carry
between tile shards and on-device per-shard stream concat; every rank of
the tile row gathers the row's shard streams and splices them on the host.

decode_sharded: same-geometry JPEGs -> pixels.  Restart streams whose
segments fall on the tile shards' MCU rows decode entirely on each
shard's device (the Huffman scan, then dequantize, IDCT, upsample and
colour); other streams take the host Huffman frontend, and each shard
runs the device stages on its own MCU rows.  No collective but the final
gather of the pixel rows.

Semantics per rank (they differ from JAX, where one process holds every
shard):
  - each rank passes the images of its data row; every rank of a tile
    row passes the same images (at world size 1, the whole batch, as in
    JAX);
  - every rank of the tile row gets back the streams, or the
    [N_loc, H, W, 3] pixels, of those images.

All encode extensions (quality, restart_interval, optimize) carry the
semantics of torch_codec.encode_batch(transport="rgb"), except that
optimize derives ONE optimal Huffman table set for the whole mesh's batch
(the counts are summed over every rank), as the JAX package does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..bitstream import writer
from ..bitstream.splice import splice_blocks
from ..codec import host_glue as HG
from ..codec import torch_codec as TC
from ..core import tables as T
from ..core.geometry import EncodeGeometry
from ..core.props import make_encode_props
from ..ops import entropy as E
from . import sharded
from .distributed import (gather_local_rows, make_global_from_local,
                          replicate_global)
from .mesh import Mesh


def shard_budget_words(mcus_per_shard: int) -> int:
    """The default stream budget (words) of a tile shard of mcus_per_shard
    MCUs: 24 a MCU (2 bits a pixel), at least 4096.  encode_sharded emits
    a shard whose stream outgrows it again, into a fitted budget."""
    return max(4096, mcus_per_shard * 24)


def encode_sharded(mesh: Mesh, batch_rgb: np.ndarray, *, gray: bool = False,
                   precision: str = "fast", rounded: bool = False,
                   quality: int | None = None, restart_interval: int = 0,
                   optimize: bool = False) -> list[bytes]:
    """Encode this rank's [N, H, W, 3] uint8 images over the mesh -> list
    of JFIF streams (on every rank of the tile row).

    Constraints: H % 16 == 0, W % 16 == 0, (H/16) % tile == 0; with
    restart_interval, the MCUs of a tile shard must be a multiple of
    restart_interval (shard boundaries on segment boundaries)."""
    return encode_sharded_finish(encode_sharded_dispatch(
        mesh, batch_rgb, gray=gray, precision=precision, rounded=rounded,
        quality=quality, restart_interval=restart_interval,
        optimize=optimize))


def encode_sharded_dispatch(mesh: Mesh, batch_rgb: np.ndarray, *,
                            gray: bool = False, precision: str = "fast",
                            rounded: bool = False,
                            quality: int | None = None,
                            restart_interval: int = 0,
                            optimize: bool = False):
    """Device half of encode_sharded: upload this rank's tile rows, run
    the shard's program with the collectives, gather the tile row's
    compact streams.  Returns a ticket for encode_sharded_finish (the host
    splice)."""
    n, h, w = batch_rgb.shape[:3]
    ri = restart_interval
    if ri < 0:
        raise ValueError(f"restart_interval must be >= 0, got {ri}")
    if h % 16 or w % 16:
        raise ValueError("encode_sharded needs multiple-of-16 dims")
    TC._dtype(precision)
    if quality is not None:
        T.scale_quant_tables(quality)  # validate before any device work
    if (h // 16) % mesh.tile:
        raise ValueError(f"{h // 16} MCU rows do not divide over "
                         f"{mesh.tile} tile shards")
    mcus_per_shard = EncodeGeometry(width=w, height=h).num_mcus // mesh.tile
    if ri and mcus_per_shard % ri:
        raise ValueError(
            f"restart_interval {ri} must divide MCUs per tile shard "
            f"({mcus_per_shard}) so segments align with shard boundaries")

    q, carry, counts = sharded.quantize(
        mesh, make_global_from_local(mesh, np.ascontiguousarray(batch_rgb)),
        gray=gray, precision=precision, rounded=rounded, quality=quality,
        restart_interval=ri, histograms=optimize)
    huff, tables = None, (None, None)
    if optimize:
        huff, tables = one_table_set(counts)
        if mesh.device.type == "cuda":  # the kernel's rows, one upload each
            tables = tuple(E.kernel_tables(t, mesh.device) for t in tables)

    def dispatch(maxw: int) -> np.ndarray:
        return sharded.gather_tiles(mesh, sharded.emit_stream(
            q, carry, maxw=maxw, restart_interval=ri, tables=tables))

    S_shard = mcus_per_shard // ri if ri else 0
    maxw = shard_budget_words(mcus_per_shard)
    combined = dispatch(maxw)                      # [n, tile, R + maxw]
    max_total = int(combined[:, :, 0].max())
    if max_total > 32 * maxw:
        # dense content outgrew the default budget: emit again into one
        # fitted to the row's largest shard stream (every rank of the row
        # sees the same totals, so all of them re-dispatch together)
        maxw = -(-max_total // 32)
        maxw += (-maxw) % 128
        combined = dispatch(maxw)
    return (combined.astype(np.uint32), n, w, h, gray, quality, ri, huff,
            S_shard, maxw)


def one_table_set(counts: np.ndarray):
    """Summed symbol counts [4, 256] -> (the DHT (bits, vals) blobs, the
    (luma, chroma) flat tables in the JAX order): optimize's one table set
    for the whole batch (T.81 K.2)."""
    ydc_bv, yac_bv, *yflat = T.optimal_flat_tables(counts[0], counts[1])
    cdc_bv, cac_bv, *cflat = T.optimal_flat_tables(counts[2], counts[3])
    return (ydc_bv, cdc_bv, yac_bv, cac_bv), (yflat, cflat)


def encode_sharded_finish(ticket) -> list[bytes]:
    """Host half of encode_sharded: splice the tile shards' streams and
    write the headers."""
    combined, n, w, h, gray, quality, ri, huff, S_shard, maxw = ticket
    ntile = combined.shape[1]
    qt = T.scale_quant_tables(quality) if quality is not None else None
    header = writer.write_header(make_encode_props(w, h, gray=gray),
                                 restart_interval=ri, quant_tables=qt,
                                 huff_tables=huff)
    out = []
    for i in range(n):
        totals = combined[i, :, 0].astype(np.int64)
        if np.any(totals > 32 * maxw):
            raise OverflowError("per-shard stream budget overflow")
        if ri:
            # per-shard streams hold whole byte-aligned segments; chain
            # them with globally cycling RSTn indices
            seg_bits = np.concatenate(
                [combined[i, t, 1:1 + S_shard] for t in range(ntile)])
            raw = b"".join(
                combined[i, t, 1 + S_shard:].astype(">u4").tobytes()[
                    :(int(totals[t]) + 7) // 8] for t in range(ntile))
            out.append(header + HG._assemble_restart_segments(raw, seg_bits)
                       + writer.EOI)
            continue
        packed, _ = splice_blocks(
            np.ascontiguousarray(combined[i, :, 1:]), totals)
        out.append(writer.assemble(header, packed))
    return out


def device_refusal(pjs, geom, tile: int, *, gray: bool,
                   precision: str) -> str | None:
    """Why this batch cannot take the sharded device decode, from the
    headers alone (None: it can)."""
    p0 = pjs[0]
    ri = p0.restart_interval
    if ri <= 0 or precision != "fast" or gray or not TC._std420(p0):
        return ("sharded device decode needs fast-precision standard 4:2:0 "
                "colour restart streams")
    if any(pj.restart_interval != ri for pj in pjs[1:]):
        return "uniform DRI required"
    mcus_y, mcus_x = geom[0][:2]
    nmcu = mcus_y * mcus_x
    if nmcu % ri:
        return "sharded device decode needs ri | nmcu"
    nseg = nmcu // ri
    if nseg % tile or (nseg // tile * ri) % mcus_x:
        return "mesh shape does not divide segments/MCU rows"
    return None


def decode_sharded(mesh: Mesh, streams: list[bytes], *, gray: bool = False,
                   precision: str = "fast") -> np.ndarray:
    """Decode this rank's same-geometry JPEGs with the device stages
    sharded over the tile row's MCU rows -> [N, H, W, 3] uint8 (on every
    rank of the tile row).

    Every stream must be decodable (DHT, DQT, SOS) and share the frame's
    geometry and quant tables (ValueError otherwise).  Restart streams at
    fast precision whose segments fall on the shards' MCU rows decode on
    the device, Huffman scan included (decided from the headers before
    any device work); a corrupt segment raises ValueError on every rank
    of the tile row.  Other streams take the host Huffman frontend.
    Pixels are the rgb transport's (clamp after colour)."""
    pjs, geom, level = _parse_checked(streams, mesh.tile, gray=gray,
                                      precision=precision)
    rgb, bad = _decode_shard(mesh, pjs, geom, level, gray=gray,
                             precision=precision)
    rows = gather_local_rows(mesh, rgb)
    bad = sharded.gather_tiles(mesh, bad.to(torch.uint8)).any(axis=1)
    if bad.any():
        raise ValueError("corrupt entropy data in stream(s) "
                         f"{np.nonzero(bad)[0].tolist()} (device Huffman "
                         "scan)")
    props = pjs[0].props
    out = rows[:, :props.height, :props.width]
    return np.repeat(out, 3, axis=-1) if out.shape[-1] == 1 else out


def _parse_checked(streams: list[bytes], tile: int, *, gray: bool,
                   precision: str):
    """Marker parse with the batch path's checks (decodable streams,
    uniform geometry), one set of quant tables, and MCU rows that divide
    over the tile shards.  Returns (pjs, geom, level)."""
    pjs, geom, level = TC._parse_batch(streams, gray=gray,
                                       precision=precision)
    HG._check_uniform_quant(pjs, pjs[0])
    if geom[0][0] % tile:
        raise ValueError(f"{geom[0][0]} MCU rows do not divide over {tile} "
                         "tile shards")
    return pjs, geom, level


def _decode_shard(mesh: Mesh, pjs, geom, level, *, gray: bool,
                  precision: str):
    """This rank's MCU rows of every image: no collective.  Returns (rgb
    [N, H_tile, W_mcu, 3 or 1] uint8 on the device, bad [N] bool)."""
    p0 = pjs[0]
    geom_t = sharded.tile_geom(geom, mesh.tile)
    qtuple = tuple(tuple(int(x) for x in p0.quant[fc.Tq])
                   for fc in p0.frame_components)
    if device_refusal(pjs, geom, mesh.tile, gray=gray,
                      precision=precision) is None:
        return _decode_shard_device(mesh, pjs, geom_t, level, qtuple)
    coeff_all, kw = TC._rgb_host_prep(pjs, geom, level, gray=gray,
                                      precision=precision)
    coeff, sizes = sharded.tile_blocks(coeff_all, kw["sizes"], mesh.tile,
                                       mesh.tile_index)
    rgb = TC._decode_fused_batch(torch.from_numpy(coeff).to(mesh.device),
                                 **dict(kw, geom=geom_t, sizes=sizes))
    return rgb, torch.zeros(len(pjs), dtype=torch.bool, device=mesh.device)


def _decode_shard_device(mesh: Mesh, pjs, geom_t, level, qtuple):
    """This shard's full device decode of restart 4:2:0 streams: host
    destuff of the segments (C++), this shard's lanes uploaded, the scan
    and the device stages (sharded.decode_device) -> (rgb rows, bad [N])."""
    p0 = pjs[0]
    ri = p0.restart_interval
    n = len(pjs)
    mcus_x = geom_t[0][1]
    nmcu = geom_t[0][0] * mcus_x * mesh.tile
    nseg = nmcu // ri
    words, nblk, rawlen = HG._device_host_frontend(pjs, nmcu, ri, nseg)
    lut, tsel = HG._device_luts(pjs, nseg)

    def lanes(a):
        """This shard's lanes of a per-lane array, image-major."""
        a = np.ascontiguousarray(a)
        return make_global_from_local(
            mesh, a.reshape(n, nseg, *a.shape[1:])).reshape(
                -1, *a.shape[1:])

    return sharded.decode_device(
        lanes(words.view(np.int32)), lanes(nblk.astype(np.int32)),
        replicate_global(mesh, lut), lanes(tsel.astype(np.int32)),
        lanes(rawlen.astype(np.int32)), n=n, ri=ri, geom=geom_t,
        level=level, qtuple=qtuple)
