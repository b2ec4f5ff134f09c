"""The sharded codec of jpezy_tpu_torch/parallel against jpezy_tpu.parallel,
the unsharded port and the host C++ codec, in one process on the CPU.

The shard-local steps run rank by rank for the layouts (data x tile) 1x1,
1x2, 2x2, 1x4 and 2x4, with the DC carry passed by hand (the left shard's
last DCs), optimize's symbol counts summed by hand, and each data row's
shard streams spliced by parallel.api.encode_sharded_finish; decode runs
parallel.api._decode_shard for every rank and stacks the tile rows.  The
collectives themselves run in tests/test_torch_distributed.py.

Tolerances.  precision="exact" is integer-exact end to end, so streams
must be byte-identical to the unsharded port's rgb transport, to the host
C++ codec and to jpezy_tpu's encode_sharded on a 2x4 mesh (tolerance 0),
and exact decode pixels identical.  Two exceptions of the JAX package are
shown rather than copied: its jitted float64 DCT is not the oracle's at
every truncation tie, so at quality 85 its streams differ from the host
codec's (ROADMAP fault K; the port's equal the host codec's), and its
decode_sharded dequantizes every image with the first stream's tables
(fault I).  Optimize derives one table set for the batch; these images
have no Huffman slot over 64 bits, where the JAX encoder keeps only 64
(fault H), so its streams are comparable.  Fast mode: a float32 matmul's
row result depends on the number of rows in the call, so a shard's DCT
may differ from the whole image's at truncation ties.  The carry and the
splice are therefore held byte-identical on the SAME quantized blocks
split into shards, and the whole fast path to the envelope of
tests/test_torch_codec.py: streams identical or within 0.05 dB PSNR,
decoded pixels within 1 of the unsharded path's.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jpezy_tpu.ops import entropy as JE
from jpezy_tpu.parallel import api as JA
from jpezy_tpu.parallel.mesh import make_mesh as jax_mesh
from jpezy_tpu_torch.bitstream.reader import parse
from jpezy_tpu_torch.codec import host_codec
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.ops import entropy as TE
from jpezy_tpu_torch.parallel import api as A
from jpezy_tpu_torch.parallel import sharded as S
from jpezy_tpu_torch.parallel.mesh import Mesh, make_mesh

from test_torch_host_copies import host_runtime  # noqa: F401 (autouse)

CPU = torch.device("cpu")
LAYOUTS = [(1, 1), (1, 2), (2, 2), (1, 4), (2, 4)]
LAYOUT_IDS = [f"{d}x{t}" for d, t in LAYOUTS]
# 128x64: 8 MCU rows of 4, 8 MCUs a shard at tile 4, so restart interval 4
CONFIGS = {
    "plain": {},
    "quality85": {"quality": 85},
    "restart": {"restart_interval": 4},
    "gray": {"gray": True},
    "optimize": {"optimize": True, "restart_interval": 4},
}


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


def _planes(im):
    return im[..., 0], im[..., 1], im[..., 2]


def _host_px(s):
    return np.stack(host_codec.decode(s)[:3], -1)


@pytest.fixture(scope="module")
def batch4():
    from imagegen import make_test_image

    return np.stack([make_test_image(128, 64, seed=10 + i) for i in range(4)])


@pytest.fixture(scope="module")
def jax_exact(batch4):
    """jpezy_tpu's encode_sharded on a 2x4 mesh, exact, per config (one
    compile each, made when first asked for)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = JA.encode_sharded(jax_mesh(2, 4), batch4,
                                            precision="exact",
                                            **CONFIGS[name])
        return cache[name]
    return get


@pytest.fixture(scope="module")
def port_exact(batch4):
    """The port's shard-local exact streams per (layout, config)."""
    cache = {}

    def get(layout, name):
        if (layout, name) not in cache:
            cache[layout, name] = _layout_encode(
                batch4, *layout, precision="exact", **CONFIGS[name])
        return cache[layout, name]
    return get


def _layout_encode(batch, data, tile, *, precision="fast", gray=False,
                   quality=None, restart_interval=0, optimize=False,
                   blocks=None):
    """encode_sharded of `batch` on a data x tile mesh, rank by rank in
    this process.  blocks: full-image quantized blocks (yq, cbq, crq) to
    cut into the shards' MCU rows instead of quantizing each shard's
    pixel rows."""
    n, h, w = batch.shape[:3]
    n_loc = n // data
    ri = restart_interval
    q = {}
    for d in range(data):
        for t in range(tile):
            if blocks is None:
                rgb = S.shard_batch(Mesh(data, tile, CPU, d * tile + t),
                                    batch)
                q[d, t] = TC._quantize_batch_rgb(
                    rgb, gray=gray, precision=precision, rounded=False,
                    quality=quality)
            else:
                q[d, t] = tuple(
                    c[d * n_loc:(d + 1) * n_loc].reshape(
                        n_loc, tile, -1, 64)[:, t] for c in blocks)
    # the carry, by hand: the left shard's last DCs, zeros on shard 0
    carry = {(d, t): S.last_dcs(q[d, t - 1]) if t else
             torch.zeros((n_loc, 3), dtype=torch.int32) for d, t in q}
    huff, tables = None, (None, None)
    if optimize:
        counts = sum(S.histograms_local(q[k], carry[k], restart_interval=ri)
                     for k in q)
        huff, tables = A.one_table_set(counts.numpy().astype(np.int64))
    mcus_t = (h // 16) * (w // 16) // tile
    maxw = A.shard_budget_words(mcus_t)
    streams = []
    for d in range(data):
        combined = np.stack(
            [S.emit_stream(q[d, t], carry[d, t], maxw=maxw,
                           restart_interval=ri, tables=tables).numpy()
             for t in range(tile)], axis=1)
        streams += A.encode_sharded_finish(
            (combined.astype(np.uint32), n_loc, w, h, gray, quality, ri,
             huff, mcus_t // ri if ri else 0, maxw))
    return streams


def _layout_decode(streams, data, tile, *, gray=False, precision="fast"):
    """decode_sharded of `streams` on a data x tile mesh, rank by rank in
    this process -> (pixels [N, H, W, 3], bad flags [data, tile, N_loc])."""
    n_loc = len(streams) // data
    out, flags = [], []
    for d in range(data):
        pjs, geom, level = A._parse_checked(
            streams[d * n_loc:(d + 1) * n_loc], tile, gray=gray,
            precision=precision)
        shards = [A._decode_shard(Mesh(data, tile, CPU, d * tile + t), pjs,
                                  geom, level, gray=gray, precision=precision)
                  for t in range(tile)]
        px = np.concatenate([rgb.numpy() for rgb, _ in shards], axis=1)
        props = pjs[0].props
        px = px[:, :props.height, :props.width]
        out.append(np.repeat(px, 3, axis=-1) if px.shape[-1] == 1 else px)
        flags.append([bad.numpy() for _, bad in shards])
    return np.concatenate(out), np.array(flags)


class TestConcat:
    """The per-shard concat, torch_codec._concat_batch_combined_comp with
    the caller's budget, against the JAX package's stream-ordered
    concat_device_batch and concat_device_restart_batch."""

    NM = 8  # MCUs an image: 48 blocks in stream order (Y0..Y3, Cb, Cr)

    @classmethod
    def _blocks(cls, seed):
        """Stream-ordered words [3, 48, 64] uint32 (zero past each block's
        bits) and bits [3, 48] int32, and the same split into per-component
        (words, bits) as torch tensors."""
        rng = np.random.default_rng(seed)
        bits = rng.integers(0, 1700, (3, cls.NM * 6)).astype(np.int32)
        bits[:, ::7] = 0
        words = rng.integers(0, 2 ** 32, (3, cls.NM * 6, 64), dtype=np.uint64)
        w = np.arange(64)[None, None, :]
        nfull = (bits // 32)[..., None].astype(np.int64)
        tail = (bits % 32)[..., None].astype(np.int64)
        keep = np.where(w < nfull, 0xFFFFFFFF,
                        np.where((w == nfull) & (tail > 0),
                                 (0xFFFFFFFF << (32 - tail)) & 0xFFFFFFFF, 0))
        words = (words & keep.astype(np.uint64)).astype(np.uint32)

        def comps(a):
            a6 = torch.from_numpy(a.astype(np.int64)).reshape(
                3, cls.NM, 6, *a.shape[2:])
            return (a6[:, :, :4].reshape(3, cls.NM * 4, *a.shape[2:]),
                    a6[:, :, 4], a6[:, :, 5])
        return words, bits, comps(words), comps(bits)

    @pytest.mark.parametrize("maxw", [4096, 300])  # 300: writes dropped
    def test_concat_device_batch_matches_jax(self, maxw):
        words, bits, wc, bc = self._blocks(maxw)
        got = TC._concat_batch_combined_comp(wc, bc, 0, maxw=maxw)[0]
        stream, total = JE.concat_device_batch(jnp.asarray(words),
                                               jnp.asarray(bits), maxw)
        assert got.shape == (3, 1 + maxw)
        assert np.array_equal(got[:, 0].numpy(), np.asarray(total))
        assert np.array_equal(got[:, 1:].numpy(), np.asarray(stream))

    @pytest.mark.parametrize("ri", [1, 4, 17])  # 17: one short segment
    def test_concat_device_restart_batch_matches_jax(self, ri):
        words, bits, wc, bc = self._blocks(ri)
        got = TC._concat_batch_combined_comp(wc, bc, ri, maxw=4096)[0]
        stream, total, seg_bits = JE.concat_device_restart_batch(
            jnp.asarray(words), jnp.asarray(bits), 4096, 6 * ri)
        s = seg_bits.shape[1]
        assert got.shape == (3, 1 + s + 4096)
        assert np.array_equal(got[:, 0].numpy(), np.asarray(total))
        assert np.array_equal(got[:, 1:1 + s].numpy(), np.asarray(seg_bits))
        assert np.array_equal(got[:, 1 + s:].numpy(), np.asarray(stream))


class TestDcCarry:
    @pytest.mark.parametrize("seg_blocks", [0, 4, 5])
    def test_carry_takes_the_leading_zeros_place(self, seg_blocks):
        rng = np.random.default_rng(seg_blocks)
        dc = rng.integers(-1024, 1017, (3, 20)).astype(np.int32)
        first = rng.integers(-1024, 1017, 3).astype(np.int32)
        got = TE.dc_predictors_restart(torch.from_numpy(dc), seg_blocks,
                                       torch.from_numpy(first)).numpy()
        want = np.concatenate([first[:, None], dc[:, :-1]], axis=1)
        if seg_blocks:
            want[:, ::seg_blocks] = 0  # the restart reset wins
        assert np.array_equal(got, want)


class TestExactEncode:
    @pytest.mark.parametrize("name", ["plain", "quality85", "restart", "gray"])
    @pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
    def test_equals_batch_path_and_host_codec(self, batch4, port_exact,
                                              layout, name):
        kw = CONFIGS[name]
        got = port_exact(layout, name)
        assert got == TC.encode_batch(batch4, precision="exact",
                                      transport="rgb", device=CPU, **kw)
        assert got == [host_codec.encode(*_planes(im), **kw)
                       for im in batch4]

    @pytest.mark.parametrize("name", ["plain", "restart", "gray", "optimize"])
    @pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
    def test_equals_jax_encode_sharded(self, port_exact, jax_exact, layout,
                                       name):
        assert port_exact(layout, name) == jax_exact(name)

    def test_jax_quality85_differs_from_host_codec(self, batch4, port_exact,
                                                   jax_exact):
        """Fault K of the JAX package: its jitted float64 DCT differs from
        the oracle's at some truncation ties, visible at quality 85; the
        port's streams are the host codec's.  JAX's still decode within
        0.05 dB."""
        host = [host_codec.encode(*_planes(im), quality=85) for im in batch4]
        assert port_exact((2, 4), "quality85") == host
        jax = jax_exact("quality85")
        assert jax != host
        for j, h, im in zip(jax, host, batch4):
            assert _psnr(_host_px(j), im) >= _psnr(_host_px(h), im) - 0.05

    def test_optimize_one_table_set(self, port_exact, jax_exact):
        """One optimal DHT for the whole batch, JAX's; the streams decode
        to the fixed-table restart streams' pixels and are smaller."""
        opt = port_exact((2, 4), "optimize")
        dht = {s[s.find(b"\xff\xc4"):s.find(b"\xff\xda")] for s in opt}
        assert len(dht) == 1
        assert dht == {s[s.find(b"\xff\xc4"):s.find(b"\xff\xda")]
                       for s in jax_exact("optimize")}
        fixed = port_exact((2, 4), "restart")
        assert sum(map(len, opt)) < sum(map(len, fixed))
        for a, b in zip(opt, fixed):
            assert np.array_equal(_host_px(a), _host_px(b))

    @pytest.mark.parametrize("name", ["plain", "restart", "optimize"])
    def test_shards_of_one_mcu_row(self, name):
        """64-row images over 4 tile shards: every shard one MCU row (its
        chroma one block row), restart segments of 2 MCUs."""
        from imagegen import make_test_image

        batch = np.stack([make_test_image(64, 48, seed=30 + i)
                          for i in range(2)])
        kw = {"plain": {}, "restart": {"restart_interval": 3},
              "optimize": {"optimize": True, "restart_interval": 3}}[name]
        got = _layout_encode(batch, 1, 4, precision="exact", **kw)
        assert got == _layout_encode(batch, 1, 1, precision="exact", **kw)
        if name != "optimize":
            assert got == [host_codec.encode(*_planes(im), **kw)
                           for im in batch]


class TestFastEncode:
    @pytest.mark.parametrize("ri", [0, 4])
    @pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
    def test_same_blocks_byte_identical(self, batch4, layout, ri):
        """The carry and the splice alone: the unsharded path's fast
        quantized blocks, cut into the shards' MCU rows, give the batch
        path's streams byte for byte."""
        blocks = TC._quantize_batch_rgb(torch.from_numpy(batch4))
        wc, bc = TC._emit_local(*blocks, ri)
        combined, words, bits = TC._concat_batch_combined_comp(wc, bc, ri)
        want = TC.encode_batch_finish(dict(
            n=4, h=128, w=64, gray=False, quality=None, ri=ri, huff=None,
            size=None, props=None, combined=combined, words=words,
            bits=bits))
        got = _layout_encode(batch4, *layout, restart_interval=ri,
                             blocks=blocks)
        assert got == want

    @pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
    def test_full_fast_path_within_envelope(self, batch4, layout):
        got = _layout_encode(batch4, *layout, restart_interval=4)
        ref = TC.encode_batch(batch4, transport="rgb", restart_interval=4,
                              device=CPU)
        for g, r, im in zip(got, ref, batch4):
            if g != r:
                assert _psnr(_host_px(g), im) >= _psnr(_host_px(r), im) - 0.05
        px, flags = _layout_decode(got, *layout)
        want, _ = TC.decode_batch(got, transport="rgb", device=CPU)
        assert not flags.any()
        assert np.abs(px.astype(np.int64) - want).max() <= 1


class TestDecode:
    @pytest.mark.parametrize("name", ["plain", "restart", "gray"])
    @pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
    def test_exact_pixels_equal_rgb_transport(self, port_exact, layout,
                                              name):
        streams = port_exact((1, 1), name)
        gray = name == "gray"
        px, _ = _layout_decode(streams, *layout, gray=gray,
                               precision="exact")
        want, _ = TC.decode_batch(streams, transport="rgb", gray=gray,
                                  precision="exact", device=CPU)
        assert np.array_equal(px, want)

    def test_exact_pixels_equal_jax_decode_sharded(self, port_exact):
        streams = port_exact((1, 1), "plain")
        want = JA.decode_sharded(jax_mesh(2, 4), streams, precision="exact")
        px, _ = _layout_decode(streams, 2, 4, precision="exact")
        assert np.array_equal(px, want)

    @pytest.mark.parametrize("layout", LAYOUTS, ids=LAYOUT_IDS)
    def test_device_decode(self, port_exact, layout):
        """Restart streams at fast precision take the sharded device
        decode (the Huffman scan per shard): pixels within 1 of the
        unsharded rgb transport's and of jpezy_tpu's decode_sharded (2x4,
        its own device decode), equal at 1x1."""
        streams = port_exact((1, 1), "restart")
        pjs, geom, _ = A._parse_checked(streams, layout[1], gray=False,
                                        precision="fast")
        assert A.device_refusal(pjs, geom, layout[1], gray=False,
                                precision="fast") is None
        px, flags = _layout_decode(streams, *layout)
        assert not flags.any()
        want, _ = TC.decode_batch(streams, transport="rgb", device=CPU)
        diff = np.abs(px.astype(np.int64) - want)
        assert diff.max() <= (0 if layout == (1, 1) else 1)
        jax = JA.decode_sharded(jax_mesh(2, 4), streams)
        assert np.abs(px.astype(np.int64) - jax).max() <= 1

    def test_api_on_a_one_by_one_mesh(self, batch4, port_exact):
        """The entry points themselves on a 1x1 mesh (no process group)."""
        mesh = make_mesh(1, 1, device="cpu")
        for name in ("plain", "restart", "optimize"):
            streams = A.encode_sharded(mesh, batch4, precision="exact",
                                       **CONFIGS[name])
            assert streams == port_exact((1, 1), name)
            want, _ = TC.decode_batch(streams, transport="rgb", device=CPU)
            assert np.array_equal(A.decode_sharded(mesh, streams), want)


class TestOverflow:
    @pytest.mark.parametrize("ri", [0, 4])
    def test_dense_content_emits_again_into_a_fitted_budget(self, ri):
        """Seeded noise at quality 100 needs about 8.4 bits a pixel, more
        than a shard's default budget (at least 4096 words, 2 bits a
        pixel): encode_sharded_dispatch sees the totals over it and emits
        again into a budget fitted to the largest shard stream.  Exact
        streams equal the host codec's and the rgb transport's (whose own
        overflow takes the per-image host splice)."""
        rng = np.random.default_rng(60 + ri)
        batch = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
        kw = {"quality": 100, "restart_interval": ri}
        ticket = A.encode_sharded_dispatch(make_mesh(1, 1, device="cpu"),
                                           batch, precision="exact", **kw)
        default = A.shard_budget_words(8 * 8)
        maxw = ticket[-1]
        assert maxw > default and maxw % 128 == 0
        totals = ticket[0][:, :, 0].astype(np.int64)
        assert totals.max() > 32 * default and totals.max() <= 32 * maxw
        got = A.encode_sharded_finish(ticket)
        assert got == [host_codec.encode(*_planes(im), **kw) for im in batch]
        assert got == TC.encode_batch(batch, precision="exact",
                                      transport="rgb", device=CPU, **kw)


class TestErrors:
    def test_restart_misaligned_raises(self, batch4):
        with pytest.raises(ValueError, match="segment"):
            A.encode_sharded(Mesh(2, 4, CPU), batch4, restart_interval=3)

    def test_negative_restart_raises(self, batch4):
        with pytest.raises(ValueError, match="restart_interval"):
            A.encode_sharded(Mesh(1, 1, CPU), batch4, restart_interval=-1)

    def test_tiles_misaligned_raise(self, batch4, port_exact):
        with pytest.raises(ValueError, match="MCU rows do not divide"):
            A.encode_sharded(Mesh(1, 3, CPU), batch4)
        with pytest.raises(ValueError, match="MCU rows do not divide"):
            A.decode_sharded(Mesh(1, 3, CPU), port_exact((1, 1), "plain"))

    def test_batch_must_divide_over_data(self, batch4):
        with pytest.raises(ValueError, match="data rows"):
            S.shard_batch(Mesh(3, 1, CPU), batch4)

    def test_device_decode_refused_from_headers(self):
        """Segments that do not fall on the shards' MCU rows take the host
        frontend (decided from the headers; JAX's messages), with the
        same pixels."""
        from imagegen import make_test_image

        batch = np.stack([make_test_image(64, 48, seed=40 + i)
                          for i in range(2)])          # 4 x 3 MCUs
        for ri, tile, why in ((2, 2, None), (5, 1, "ri | nmcu"),
                              (2, 4, "does not divide"),
                              (4, 2, "does not divide")):
            streams = [host_codec.encode(*_planes(im), restart_interval=ri)
                       for im in batch]
            pjs, geom, _ = A._parse_checked(streams, tile, gray=False,
                                            precision="fast")
            got = A.device_refusal(pjs, geom, tile, gray=False,
                                   precision="fast")
            assert (got is None) if why is None else why in got
            px, _ = _layout_decode(streams, 1, tile, precision="exact")
            want, _ = TC.decode_batch(streams, transport="rgb",
                                      precision="exact", device=CPU)
            assert np.array_equal(px, want)

    def test_mixed_quant_tables_raise_fault_i(self):
        """Fault I: jpezy_tpu's decode_sharded dequantizes every image with
        the first stream's tables, so image 1 decodes wrongly; the port
        raises."""
        from imagegen import make_test_image

        im = make_test_image(32, 32, seed=50)
        streams = [host_codec.encode(*_planes(im), quality=q)
                   for q in (30, 95)]
        with pytest.raises(ValueError, match="quant tables"):
            A.decode_sharded(make_mesh(1, 1, device="cpu"), streams)
        jax = JA.decode_sharded(jax_mesh(1, 1), streams, precision="exact")
        assert np.array_equal(jax[0], _host_px(streams[0]))
        assert np.abs(jax[1].astype(np.int64)
                      - _host_px(streams[1])).max() > 100

    def test_corrupt_segment_raises_fault_d(self, port_exact):
        """Fault D: the JAX sharded device decode drops the scan's flags;
        the port flags the shard that holds the corrupt segment and
        decode_sharded raises."""
        streams = list(port_exact((1, 1), "restart"))
        broken = bytearray(streams[1])
        es = parse(streams[1]).entropy_start
        broken[es:es + 6] = bytes(6)         # the first segment: tile 0
        streams[1] = bytes(broken)
        with pytest.raises(ValueError, match=r"corrupt .*\[1\]"):
            A.decode_sharded(make_mesh(1, 1, device="cpu"), streams)
        _, flags = _layout_decode(streams, 2, 2)
        assert flags.tolist() == [[[False, True], [False, False]],
                                  [[False, False], [False, False]]]

    def test_optimize_with_rgb_transport_raises_fault_j(self, batch4):
        with pytest.raises(ValueError, match="optimize"):
            TC.encode_batch(batch4[:1], optimize=True, transport="rgb",
                            device=CPU)
