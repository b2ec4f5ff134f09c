"""The fused entropy kernel's schedule and the 32-bit words it hands the
stream concat, on the CPU.

jpezy_tpu_torch/testing/encode_runs.py models csrc/entropy_pack.cu's
jz_encode_blocks_batch: runs of 32 blocks of one component a thread block
(one image's blocks where each image has its own table set and fewer
blocks), the table sets a run stages, each block's DC predictor source
(the neighbouring lane, a 4-byte load, the carry or 0) and a lane's
sequential bit writer.  Here the model equals encode_blocks_batch_plain
(restart intervals 0, 1 and 8, with and without a carry, the fixed tables,
one custom set and a set an image, on 3 images of 16x16, 48x16, 48x32,
48x48 and 128x64, whose block counts are no multiple of a run) and the
JAX package's parallel/sharded.py:_emit_local, each image on its own with
its set (one compile a shape: the restart interval is traced, see
_Interval); the schedule meets the cases where trouble is likely (runs
across images and segments, a carry inside a run, tail runs, two sets in
a run); edge-case, dense, the longest and 74-bit-emission blocks agree
too.  The
concat dispatcher gives the same combined from int32 words as from int64
words and as the JAX concat, words at or above 2**31 included.  The CUDA
wrapper refuses misaligned inputs before any build.  Tolerance 0: all of
it is integer-exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpezy_tpu.codec import jax_codec as JC
from jpezy_tpu.parallel import sharded as JS
from jpezy_tpu_torch.codec import host_glue as HG
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.core import tables as T
from jpezy_tpu_torch.ops import concat_cuda, pack_cuda
from jpezy_tpu_torch.ops import entropy as TE
from jpezy_tpu_torch.testing import encode_runs as ER

from test_torch_host_copies import host_runtime  # noqa: F401 (autouse)

NIMAGES = 3
SIZES = {"16x16": (16, 16), "48x16": (16, 48), "48x32": (32, 48),
         "48x48": (48, 48), "128x64": (64, 128)}  # width x height: (H, W)
TABLES = ("fixed", "one set", "a set an image")
FIXED = ((T.Y_DC_SIZE, T.Y_DC_CODE, T.Y_AC_SIZE, T.Y_AC_CODE),
         (T.C_DC_SIZE, T.C_DC_CODE, T.C_AC_SIZE, T.C_AC_CODE))


@functools.lru_cache(maxsize=None)
def _batch(size: str):
    """(quantized (yq, cbq, crq) of NIMAGES test images, {kind: tables in
    the JAX order}), fast precision's exact quantizer."""
    from imagegen import make_test_image

    h, w = SIZES[size]
    rgbs = np.stack([make_test_image(h, w, seed=900 + i)
                     for i in range(NIMAGES)])
    y, cb, cr = HG.host_rgb_to_ycc420(rgbs)
    q = TC._quantize_local_ycc(
        torch.from_numpy(y), torch.from_numpy(cb), torch.from_numpy(cr),
        gray=False, dtype=torch.float64, rounded=False)
    hists = TC._symbol_histograms_batch(*q).numpy()
    _, ytabs, ctabs = TC._optimal_tables(hists)
    total = hists.sum(axis=0)
    _, _, *yone = T.optimal_flat_tables(total[0], total[1])
    _, _, *cone = T.optimal_flat_tables(total[2], total[3])
    return q, {"fixed": (None, None),
               "one set": (tuple(yone), tuple(cone)),
               "a set an image": (ytabs, ctabs)}


def _carry(seed: int = 11) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -1000, 1000, (NIMAGES, 3)).astype(np.int32))


def _same(got, want):
    for g, w in zip(list(got[0]) + list(got[1]),
                    list(want[0]) + list(want[1])):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("tables", TABLES)
@pytest.mark.parametrize("carry", [False, True], ids=["no-carry", "carry"])
@pytest.mark.parametrize("ri", [0, 1, 8])
@pytest.mark.parametrize("size", list(SIZES))
def test_model_equals_plain(size, ri, carry, tables):
    q, tabs = _batch(size)
    c = _carry() if carry else None
    _same(ER.encode(*q, ri, c, tabs[tables]),
          TE.encode_blocks_batch_plain(*q, ri, c, tabs[tables]))


class _Interval:
    """A restart interval that JAX's _emit_local traces: its `> 0` is a
    Python True and its products are traced, so one compile serves every
    interval; 0 is passed as a segment longer than any image, which resets
    only each image's first block, whose predictor is 0 anyway."""

    def __init__(self, value):
        self.value = value

    def __gt__(self, other):
        return True

    def __mul__(self, k):
        return self.value * k


@jax.jit
def _jax_emit(yq, cbq, crq, interval, ytabs, ctabs):
    return JS._emit_local(yq, cbq, crq, tile_axis=None, use_pallas=False,
                          tables=(ytabs, ctabs),
                          restart_interval=_Interval(interval),
                          interleave=False)


def _jax_image(q, i: int, ri: int, tabs):
    """Image i of q through JAX's _emit_local with its (luma, chroma)
    tables (one set each, the fixed ones given as such)."""
    args = [jnp.asarray(c[i:i + 1].numpy()) for c in q]
    sets = [tuple(jnp.asarray(np.asarray(a, np.int32)) for a in t)
            for t in tabs]
    words, bits = _jax_emit(*args, jnp.int32(ri if ri else 1 << 20), *sets)
    return ([np.asarray(w)[0].astype(np.int64) for w in words],
            [np.asarray(b)[0].astype(np.int64) for b in bits])


@pytest.mark.parametrize("tables", TABLES)
@pytest.mark.parametrize("ri", [0, 1, 8])
@pytest.mark.parametrize("size", list(SIZES))
def test_model_equals_jax(size, ri, tables):
    q, tabs = _batch(size)
    words, bits = ER.encode(*q, ri, None, tabs[tables])
    for i in range(NIMAGES):
        if tables == "fixed":
            sets = FIXED
        elif tables == "one set":
            sets = tabs["one set"]
        else:
            sets = tuple(tuple(t[i] for t in side)
                         for side in tabs["a set an image"])
        _same(([w[i] for w in words], [b[i] for b in bits]),
              _jax_image(q, i, ri, sets))


def _blocks(size: str):
    q, _ = _batch(size)
    return [c.shape[1] for c in q[:2]]


@pytest.mark.parametrize("ri", [0, 1, 8])
@pytest.mark.parametrize("size", list(SIZES))
def test_schedule_covers_every_block_once(size, ri):
    """Each component's blocks in runs of at most 32, each block once; a
    4-byte load only for a run's first block; with a set an image at most
    two sets a run, each block's slot its own image's."""
    by, bc = _blocks(size)
    for nsets in (1, NIMAGES):
        seen = {0: [], 1: [], 2: []}
        for u in ER.schedule(NIMAGES, by, bc, ri, nsets, carry=True):
            assert 0 < u.count <= ER.RUN_BLOCKS
            seen[u.comp] += range(u.b0, u.b0 + u.count)
            assert "load" not in u.sources[1:] and u.sources[0] != "lane"
            per_image = by if u.comp == 0 else bc
            if nsets > 1:
                assert 1 <= len(u.staged) <= ER.RUN_SETS
                for lane, slot in enumerate(u.slots):
                    assert u.staged[slot] == (u.b0 + lane) // per_image
            else:
                assert u.staged == ()
        for comp, per_image in ((0, by), (1, bc), (2, bc)):
            assert seen[comp] == list(range(NIMAGES * per_image))


def test_schedule_meets_the_hard_cases():
    """Across the sizes and intervals above: runs that start mid-image
    (a 4-byte load), runs across images with the fixed tables and with a
    set an image (two sets staged), a carry and a segment start inside a
    run, and tail runs shorter than 32."""
    met = set()
    for size in SIZES:
        by, bc = _blocks(size)
        for ri in (0, 1, 8):
            for nsets in (1, NIMAGES):
                for u in ER.schedule(NIMAGES, by, bc, ri, nsets, carry=True):
                    per_image = by if u.comp == 0 else bc
                    images = {(u.b0 + k) // per_image for k in range(u.count)}
                    if u.sources[0] == "load":
                        met.add("load")
                    if len(images) > 1:
                        met.add(f"across images, {nsets} sets")
                    if len(u.staged) == 2:
                        met.add("two sets")
                    if "carry" in u.sources[1:]:
                        met.add("carry inside")
                    if ri and any(s == "zero" and (u.b0 + k) % per_image
                                  for k, s in enumerate(u.sources) if k):
                        met.add("segment inside")
                    if u.count < ER.RUN_BLOCKS:
                        met.add("tail")
    assert met == {"load", "across images, 1 sets", f"across images, "
                   f"{NIMAGES} sets", "two sets", "carry inside",
                   "segment inside", "tail"}


def _one_image(blocks: np.ndarray):
    """An image's three components cut from [B, 64] blocks: all as Y, the
    first and last quarter as Cb and Cr."""
    qt = torch.from_numpy(blocks.astype(np.int32))
    k = max(1, qt.shape[0] // 4)
    return qt[None], qt[None, :k], qt[None, -k:]


@pytest.mark.parametrize("ri", [0, 1])
@pytest.mark.parametrize("case", ["edge", "dense", "longest", "74 bits"])
def test_model_equals_plain_on_hard_blocks(case, ri):
    """ZRL runs, the extreme DC differences and the EOB-free blocks of
    entropy.edge_case_blocks; dense blocks of |v| <= 1023; the longest
    blocks (encode_runs.longest_tables); slots of 74 bits under long-code
    tables."""
    rng = np.random.default_rng(17)
    tabs = (None, None)
    if case == "edge":
        blocks = TE.edge_case_blocks(19)
    elif case == "dense":
        blocks = rng.integers(1, 1024, (96, 64)) * rng.choice([-1, 1],
                                                             (96, 64))
    elif case == "longest":
        blocks = ER.longest_blocks(40)
        tabs = (ER.longest_tables(), ER.longest_tables(24))
    else:
        _, _, *flat = TE.long_emission_tables()
        blocks, tabs = TE.long_emission_blocks(), (flat, flat)
    comps = _one_image(blocks)
    want = TE.encode_blocks_batch_plain(*comps, ri, tables=tabs)
    _same(ER.encode(*comps, ri, tables=tabs), want)
    if case == "longest":
        assert int(want[1][0].max()) == 1791
    if case == "74 bits":
        _, _, nbits = TE.block_emissions(
            comps[0][0], TE.dc_predictors(comps[0][0, :, 0]), False, flat)
        assert int(nbits.max()) == 74


def test_words32_keeps_bit_patterns():
    w = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1])
    w32 = TE.words32(w)
    assert w32.dtype == torch.int32
    assert w32.tolist() == [0, 1, 2 ** 31 - 1, -2 ** 31, -1]
    assert torch.equal(TE.words64(w32), w)
    assert np.array_equal(w32.numpy().view(np.uint32),
                          w.numpy().astype(np.uint32))


@pytest.mark.parametrize("ri", [0, 8])
def test_concat_takes_32bit_words(ri):
    """The dispatcher's combined from int32 words (the kernel's layout)
    equals that from int64 words and the JAX package's concat, words at
    or above 2**31 among them; nothing is launched on CPU tensors."""
    nm = 40
    wc, bc = TE.stream_blocks(3, nm, seed=30 + ri)
    w32 = tuple(TE.words32(w) for w in wc)
    assert all(int((w < 0).sum()) > 0 for w in w32)  # >= 2**31 as int32
    before = concat_cuda.launches
    got32, kept, _ = TC._concat_batch_combined_comp(w32, bc, ri)
    got64, _, _ = TC._concat_batch_combined_comp(wc, bc, ri)
    assert concat_cuda.launches == before and kept is w32
    ref, _, _ = JC._concat_batch_combined_comp(
        tuple(jnp.asarray(w.numpy().astype(np.uint32)) for w in wc),
        tuple(jnp.asarray(b.numpy()) for b in bc), ri)
    assert torch.equal(got32, got64)
    assert np.array_equal(got32.numpy(), np.asarray(ref).astype(np.int64))


def test_overflow_splice_reads_32bit_words():
    """An image that outgrows its budget is spliced on the host from the
    per-component words, int32 patterns or int64 values alike."""
    wc, bc = TE.stream_blocks(2, 6, seed=41)
    w32 = tuple(TE.words32(w) for w in wc)
    for i in range(2):
        a = TC._image_words_bits(wc, bc, i)
        b = TC._image_words_bits(w32, bc, i)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


def _misaligned(shape):
    """A contiguous int32 tensor whose data sits 4 bytes past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 4, dtype=torch.int32)[1:n + 1].view(shape)


@pytest.mark.parametrize("which", ["yq", "cbq", "crq", "luma tables",
                                   "chroma tables"])
def test_encode_wrapper_refuses_misaligned_before_building(which):
    """The kernel copies blocks and table rows 16 bytes at a time: a
    contiguous view off a 16-byte boundary is refused before any build."""
    q = torch.zeros((2, 8, 64), dtype=torch.int32)
    comps = [q, q[:, :2].clone(), q[:, :2].clone()]
    rows = [torch.zeros((2, pack_cuda.KERNEL_ROW), dtype=torch.int32)
            for _ in range(2)]
    names = ["yq", "cbq", "crq", "luma tables", "chroma tables"]
    k = names.index(which)
    if k < 3:
        comps[k] = _misaligned(comps[k].shape)
        assert comps[k].is_contiguous() and comps[k].data_ptr() % 16
    else:
        rows[k - 3] = _misaligned(rows[k - 3].shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pack_cuda.encode_blocks_batch_cuda(*comps, tables=tuple(rows))
    assert pack_cuda.LIB.handle is None
