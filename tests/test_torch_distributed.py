"""The sharded codec of jpezy_tpu_torch/parallel over real gloo ranks on
the CPU: the counterpart of tests/test_distributed.py.

Two spawns, each module-scoped: 2 ranks on a 1x2 (data x tile) mesh and 4
ranks on a 2x2 mesh, initialised through a FileStore under the test's
temporary directory (no TCP port, so parallel test workers cannot race
for one).  Each rank imports neither jax nor jpezy_tpu, passes the images
of its data row (every rank of a tile row the same ones), runs
encode_sharded and decode_sharded with the collectives (the DC carry in
the tile row, optimize's counts summed over the world, the gathers of
streams and pixel rows), and writes what it got to an .npz.  The parent
compares the ranks' results with jpezy_tpu's encode_sharded on a 2x4 mesh,
with the unsharded port and with the host C++ codec: exact-mode streams
byte-identical (tolerance 0), exact decode pixels identical, fast device
decode pixels within 1 of the unsharded rgb transport's (a float32
matmul's row result depends on the rows in the call).  Each spawn has its
own timeout, so a hang fails its tests rather than the suite.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jpezy_tpu_torch.codec import host_codec
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.parallel import api as A
from jpezy_tpu_torch.parallel import distributed as D

from test_torch_host_copies import build_host_runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 120
N, H, W, RI = 4, 128, 64, 4

_CHILD = r"""
import os, sys
rank, world, data, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4], sys.argv[5])
repo = os.environ["JPEZY_REPO"]
sys.path[:0] = [repo, os.path.join(repo, "tests")]
import numpy as np
from imagegen import make_test_image
from jpezy_tpu_torch.bitstream.reader import parse
from jpezy_tpu_torch.parallel import decode_sharded, encode_sharded
from jpezy_tpu_torch.parallel.api import (encode_sharded_dispatch,
                                          encode_sharded_finish)
from jpezy_tpu_torch.parallel.distributed import initialize, make_global_mesh

initialize(f"file://{store}", world, rank, backend="gloo")
mesh = make_global_mesh(data, device="cpu")
batch = np.stack([make_test_image(128, 64, seed=10 + i) for i in range(4)])
n_loc = 4 // data
local = batch[mesh.data_index * n_loc:(mesh.data_index + 1) * n_loc]
res = dict(rank=rank, data_index=mesh.data_index, tile_index=mesh.tile_index)
for name, kw in (("plain", {}), ("restart", {"restart_interval": 4}),
                 ("optimize", {"optimize": True, "restart_interval": 4}),
                 ("quality", {"quality": 85, "restart_interval": 4})):
    streams = encode_sharded(mesh, local, precision="exact", **kw)
    res["streams_" + name] = np.frombuffer(b"".join(streams), np.uint8)
    res["lens_" + name] = np.array([len(s) for s in streams])
    if name == "restart":
        restart = streams
# dense content over the shards' default budget: emitted again, fitted
dense = np.random.default_rng(70).integers(0, 256, (4, 256, 128, 3),
                                           dtype=np.uint8)
dense = dense[mesh.data_index * n_loc:(mesh.data_index + 1) * n_loc]
for name, ri in (("dense", 0), ("dense_restart", 4)):
    ticket = encode_sharded_dispatch(mesh, dense, precision="exact",
                                     quality=100, restart_interval=ri)
    res["maxw_" + name] = ticket[-1]
    streams = encode_sharded_finish(ticket)
    res["streams_" + name] = np.frombuffer(b"".join(streams), np.uint8)
    res["lens_" + name] = np.array([len(s) for s in streams])
fast = encode_sharded(mesh, local, restart_interval=4)
res["streams_fast"] = np.frombuffer(b"".join(fast), np.uint8)
res["lens_fast"] = np.array([len(s) for s in fast])
res["px_device"] = decode_sharded(mesh, fast)
res["px_exact"] = decode_sharded(mesh, restart, precision="exact")
# the first segment of batch image 1 (data row 0, tile 0) is zeroed
bad = list(restart)
if mesh.data_index == 0:
    broken = bytearray(bad[1])
    es = parse(bad[1]).entropy_start
    broken[es:es + 6] = bytes(6)
    bad[1] = bytes(broken)
try:
    decode_sharded(mesh, bad)
    res["corrupt_error"] = ""
except ValueError as exc:
    res["corrupt_error"] = str(exc)
res["leaked"] = " ".join(sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jpezy_tpu")))
np.savez(out, **res)
import torch.distributed as dist
dist.barrier()
dist.destroy_process_group()  # gloo's threads end before the interpreter
print(f"rank {rank}: OK", flush=True)
"""


def _spawn(tmp, world: int, data: int) -> list[dict]:
    """Run `world` gloo ranks of _CHILD on a data x (world/data) mesh;
    returns each rank's results.  Any failure or timeout fails."""
    script = tmp / "child.py"
    script.write_text(_CHILD)
    store = tmp / "store"
    # one intra-op thread a rank: the ranks share the test worker's cores
    env = dict(os.environ, JPEZY_REPO=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(data),
         str(store), str(tmp / f"rank{r}.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=SPAWN_TIMEOUT_S)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r}: OK" in out, (
            f"rank {r} of {world} failed:\n{out[-4000:]}")
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module", params=[(2, 1), (4, 2)],
                ids=["2ranks-1x2", "4ranks-2x2"])
def ranks(request, tmp_path_factory):
    # the host library's own build is not safe from several processes
    build_host_runtime()
    world, data = request.param
    return _spawn(tmp_path_factory.mktemp(f"ranks{world}"), world, data)


@pytest.fixture(scope="module")
def batch():
    from imagegen import make_test_image

    return np.stack([make_test_image(H, W, seed=10 + i) for i in range(N)])


@pytest.fixture(scope="module")
def dense():
    """The children's dense batch: seeded noise, at quality 100 about 8.4
    bits a pixel, over the default budget of its 64-MCU tile shards."""
    return np.random.default_rng(70).integers(0, 256, (N, 256, 128, 3),
                                              dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_exact(batch):
    """jpezy_tpu's encode_sharded on a 2x4 mesh, exact, restart and
    optimize (these images have no Huffman slot over 64 bits)."""
    from jpezy_tpu.parallel.api import encode_sharded
    from jpezy_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(2, 4)
    return {name: encode_sharded(mesh, batch, precision="exact",
                                 restart_interval=RI, **kw)
            for name, kw in (("restart", {}), ("optimize",
                                               {"optimize": True}))}


def _streams(res, name):
    data = res["streams_" + name].tobytes()
    offs = np.concatenate([[0], np.cumsum(res["lens_" + name])])
    return [data[a:b] for a, b in zip(offs[:-1], offs[1:])]


def _row_streams(ranks, name):
    """The whole batch's streams, from tile shard 0 of each data row."""
    out = []
    for res in sorted(ranks, key=lambda r: int(r["data_index"])):
        if int(res["tile_index"]) == 0:
            out += _streams(res, name)
    return out


def _planes(im):
    return im[..., 0], im[..., 1], im[..., 2]


def test_every_rank_ran_without_jax(ranks):
    assert [str(r["leaked"]) for r in ranks] == [""] * len(ranks)


def test_ranks_of_a_tile_row_agree(ranks):
    for name in ("plain", "restart", "optimize", "quality", "fast", "dense",
                 "dense_restart"):
        for res in ranks:
            first = next(r for r in ranks
                         if int(r["data_index"]) == int(res["data_index"]))
            assert _streams(res, name) == _streams(first, name)
    for key in ("px_device", "px_exact"):
        for res in ranks:
            first = next(r for r in ranks
                         if int(r["data_index"]) == int(res["data_index"]))
            assert np.array_equal(res[key], first[key])


@pytest.mark.parametrize("name,kw", [
    ("plain", {}), ("restart", {"restart_interval": RI}),
    ("quality", {"quality": 85, "restart_interval": RI})])
def test_exact_streams_equal_host_codec_and_batch_path(ranks, batch, name,
                                                       kw):
    got = _row_streams(ranks, name)
    assert got == [host_codec.encode(*_planes(im), **kw) for im in batch]
    assert got == TC.encode_batch(batch, precision="exact", transport="rgb",
                                  device="cpu", **kw)


@pytest.mark.parametrize("name", ["restart", "optimize"])
def test_exact_streams_equal_jax_encode_sharded(ranks, jax_exact, name):
    assert _row_streams(ranks, name) == jax_exact[name]


def test_optimize_sums_counts_over_the_world(ranks):
    """One DHT for the whole batch, on every rank of every data row."""
    dht = {s[s.find(b"\xff\xc4"):s.find(b"\xff\xda")]
           for res in ranks for s in _streams(res, "optimize")}
    assert len(dht) == 1


def test_device_decode_within_one_of_rgb_transport(ranks):
    fast = _row_streams(ranks, "fast")
    want, _ = TC.decode_batch(fast, transport="rgb", device="cpu")
    got = np.concatenate([r["px_device"] for r in sorted(
        ranks, key=lambda r: int(r["data_index"]))
        if int(r["tile_index"]) == 0])
    assert got.shape == (N, H, W, 3)
    assert np.abs(got.astype(np.int64) - want).max() <= 1


def test_exact_decode_equals_rgb_transport(ranks):
    restart = _row_streams(ranks, "restart")
    want, _ = TC.decode_batch(restart, transport="rgb", precision="exact",
                              device="cpu")
    got = np.concatenate([r["px_exact"] for r in sorted(
        ranks, key=lambda r: int(r["data_index"]))
        if int(r["tile_index"]) == 0])
    assert np.array_equal(got, want)


def test_corrupt_stream_raises_on_its_tile_row(ranks):
    """Image 1's first segment sits on tile shard 0 of data row 0: every
    rank of that row raises naming it; the other data row decodes."""
    for res in ranks:
        err = str(res["corrupt_error"])
        if int(res["data_index"]) == 0:
            assert "corrupt" in err and "[1]" in err, err
        else:
            assert err == ""


@pytest.mark.parametrize("name,ri", [("dense", 0), ("dense_restart", RI)])
def test_dense_streams_emitted_again_equal_host_codec(ranks, dense, name,
                                                      ri):
    """Every shard's stream outgrew the default budget, so every rank of
    the tile row emitted again into the fitted one; the spliced exact
    streams equal the host codec's and the rgb transport's."""
    for res in ranks:
        assert int(res["maxw_" + name]) > A.shard_budget_words(64)
    got = _row_streams(ranks, name)
    kw = {"quality": 100, "restart_interval": ri}
    assert got == [host_codec.encode(*_planes(im), **kw) for im in dense]
    assert got == TC.encode_batch(dense, precision="exact", transport="rgb",
                                  device="cpu", **kw)


@pytest.mark.parametrize("local,cards,want", [
    ("2", 4, [2]), ("3", 1, []), (None, 4, [])],
    ids=["own-card", "shared-card", "no-local-rank"])
def test_initialize_selects_the_local_ranks_card(monkeypatch, local, cards,
                                                 want):
    """initialize() makes LOCAL_RANK's card current where the host has
    it, so make_global_mesh(device="cuda") is the rank's own card; ranks
    that share one card keep the current one (gloo).  torch.cuda is
    stubbed: this runs without a card, in one process."""
    chosen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    monkeypatch.setenv("WORLD_SIZE", "1")
    if local is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local)
    D.initialize()
    assert chosen == want
