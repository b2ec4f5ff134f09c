"""The batched stream concat of jpezy_tpu_torch against jpezy_tpu.

On CPU tensors torch_codec._concat_batch_combined_comp takes the plain
form (entropy.concat_streams_plain); on CUDA tensors it calls the
hand-written kernel (ops/concat_cuda.py, csrc/stream_concat.cu), which
tests/test_torch_cuda.py holds to the plain form on the card.  Here, on
the CPU: the dispatching function equals the JAX package's
_concat_batch_combined_comp bit for bit, with and without restart
markers; a numpy model of the kernel's two passes (offsets with each
segment's byte padding inserted before the next segment, then an OR of
only each block's used words) equals the plain form, as does the
entropy kernel's promise that words past a block's bits are zero; an
image over the stream budget takes the per-component host splice and
still gives host_codec's bytes; the CUDA wrappers refuse what they do not
take before anything is built.  Tolerance 0 throughout: all of it is
integer-exact.
"""
import bisect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jpezy_tpu.codec import jax_codec as JC
from jpezy_tpu_torch.codec import host_codec
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.ops import concat_cuda, pack_cuda
from jpezy_tpu_torch.ops import entropy as TE

from test_torch_host_copies import host_runtime  # noqa: F401 (autouse)

NM = 40  # MCUs an image: 240 blocks
M32 = 0xFFFFFFFF


THREADS = 512  # kThreads of csrc/stream_concat.cu: a thread block a tile
STAGE = 32768   # kStage: most words a tile assembles in shared memory at once


def _ceil8(x: int) -> int:
    return (x + 7) & ~7


def _then(f, g):
    """Run f, then run g; a run (a, c, bound) maps the running bit offset
    x to x + a, or to ceil8(x + a) + c when a segment starts in it."""
    (fa, fc, fb), (ga, gc, gb) = f, g
    if not gb:
        return (fa, fc + ga, 1) if fb else (fa + ga, 0, 0)
    if not fb:
        return (fa + ga, gc, 1)
    return (fa, _ceil8(fc + ga) + gc, 1)


def _apply(f, x: int) -> int:
    a, c, bound = f
    return _ceil8(x + a) + c if bound else x + a


def _model(words, bits, ri: int, maxw: int, tile_mcus=None,
           stage_words: int | None = None) -> np.ndarray:
    """The CUDA kernel's algorithm in numpy, a thread block at a time: the
    tiles of concat_cuda.tile_layout (or of tile_mcus MCUs); each tile
    folds the MCUs from its image's start to its end in THREADS contiguous
    runs, scans the runs in order, walks them again for its MCUs'
    first-block offsets (after the segment's byte padding) and the base of
    the segment open at its start, writes the bit counts of the segments
    that end in it and, in the last tile, the total; then it assembles
    each stream word whose first bit lies in [the tile's offset, the next
    tile's), STAGE words at a time: each of its blocks ORs in its words
    shifted to their phase, clipped to those words, and the last word
    takes the bits of the next tiles' blocks by a walk from the next
    tile's offset; the last tile writes zeros after the data up to maxw.
    Every element of combined must be written exactly once.  stage_words:
    the stage's size, None for the kernel's min(STAGE, maxw) (a smaller
    one makes a tile assemble its words in several rounds)."""
    N, nm = bits[1].shape
    if tile_mcus is None:
        ntiles, tile_mcus = concat_cuda.tile_layout(nm)
    else:
        ntiles = -(-nm // tile_mcus)
    S = -(-nm // ri) if ri else 0
    stage_words = stage_words or min(STAGE, maxw)
    out = np.zeros((N, 1 + S + maxw), np.int64)
    writes = np.zeros(out.shape, np.int64)

    def put(n, col, v):
        out[n, col] = v
        writes[n, col] += 1

    for n in range(N):
        mcu = np.concatenate([bits[0][n].numpy().reshape(nm, 4),
                              bits[1][n].numpy()[:, None],
                              bits[2][n].numpy()[:, None]], 1).astype(np.int64)
        blk = [[words[0][n, 4 * m + j].numpy() for j in range(4)]
               + [words[1][n, m].numpy(), words[2][n, m].numpy()]
               for m in range(nm)]

        def starts(m):
            return bool(ri) and m > 0 and m % ri == 0

        def run_of(m):
            b = int(mcu[m].sum())
            return (0, b, 1) if starts(m) else (b, 0, 0)

        def piece(m, j, o, p):
            """Bits [p, p + 32) of block j of MCU m at offset o."""
            w, nb = blk[m][j], int(mcu[m, j])
            if o >= p:
                return int(w[0]) >> (o - p)
            i, r = divmod(p - o, 32)
            lo = int(w[i + 1]) if r and 32 * (i + 1) < nb else 0
            return ((int(w[i]) << r) | (lo >> (32 - r))) & M32

        def bits_past_tile(m1, s_next, p):
            word, o, m = 0, s_next, m1
            while m < nm and o < p + 32:
                o = _ceil8(o) if starts(m) else o
                for j in range(6):
                    nb = int(mcu[m, j])
                    if nb > 0 and o < p + 32 and o + nb > p:
                        word |= piece(m, j, o, p)
                    o += nb
                m += 1
            return word

        for t in range(ntiles):
            m0, m1 = t * tile_mcus, min(nm, (t + 1) * tile_mcus)
            last = m1 == nm
            open_ = m0 // ri * ri if ri else m0
            chunk = -(-m1 // THREADS)
            chunks = [(min(m1, i * chunk), min(m1, (i + 1) * chunk))
                      for i in range(THREADS)]
            runs = []
            for c0, c1 in chunks:
                r = (0, 0, 0)
                for m in range(c0, c1):
                    r = _then(r, run_of(m))
                runs.append(r)
            before, whole = [], (0, 0, 0)
            for r in runs:           # the block's exclusive scan
                before.append(whole)
                whole = _then(whole, r)
            s_next = _apply(whole, 0)
            off = [0] * (m1 - m0)
            marks = {}
            for (c0, c1), r in zip(chunks, before):
                if c1 <= open_:
                    continue
                v = _apply(r, 0)
                for m in range(c0, c1):
                    if m == m0:
                        marks["s_t"] = v
                    if starts(m):
                        v = _ceil8(v)
                    if m == open_ and m < m0:
                        marks["open"] = v
                    if m >= m0:
                        off[m - m0] = v
                    v += int(mcu[m].sum())
            s_t = marks["s_t"]
            for s in range(m0 // ri, (m1 - 1) // ri + 1) if ri else ():
                e = min((s + 1) * ri, nm) - 1
                if e >= m1:
                    continue
                base = off[s * ri - m0] if s * ri >= m0 else marks["open"]
                put(n, 1 + s, off[e - m0] + int(mcu[e].sum()) - base)
            if last:
                put(n, 0, _ceil8(s_next) if ri else s_next)
            w0, w_data = (s_t + 31) >> 5, min(maxw, (s_next + 31) >> 5)
            for lo in range(w0, w_data, stage_words):
                hi = min(lo + stage_words, w_data)
                stage = [0] * (hi - lo)
                for k in range(m1 - m0):       # a thread a block
                    o = off[k]
                    for j in range(6):
                        nb = int(mcu[m0 + k, j])
                        q, r, nw = o >> 5, o & 31, -(-nb // 32)
                        w = blk[m0 + k][j]
                        for x in range(max(0, lo - q),
                                       min(nw if r else nw - 1, hi - 1 - q)
                                       + 1):
                            cur = int(w[x]) if x < nw else 0
                            prev = int(w[x - 1]) if x > 0 else 0
                            stage[q + x - lo] |= (
                                cur >> r | (prev << (32 - r)) & M32
                                if r else cur)
                        o += nb
                if not last and hi == w_data and s_next & 31:
                    stage[-1] |= bits_past_tile(m1, s_next, (w_data - 1) << 5)
                for x, v in enumerate(stage):
                    put(n, 1 + S + lo + x, v)
            if last:
                for w in range(max(w0, w_data), maxw):
                    put(n, 1 + S + w, 0)
    assert (writes == 1).all(), "an element written other than once"
    return out


def _short_blocks(n: int, nm: int, seed: int):
    """Per-component packed blocks of 0 to 4 bits (every seventh MCU
    empty): six blocks of an MCU hold fewer than 32 bits, so with tiles of
    one MCU a word spans several tiles, and empty tiles own no word."""
    rng = np.random.default_rng(seed)
    words, bits = [], []
    for per_mcu in (4, 1, 1):
        b = rng.integers(2, 5, (n, per_mcu * nm))
        b[:, ::3] = rng.integers(0, 2, b[:, ::3].shape) * 2
        b.reshape(n, nm, per_mcu)[:, ::7] = 0
        top = rng.integers(0, 16, b.shape) << 28
        w = np.zeros((*b.shape, 64), np.int64)
        w[..., 0] = top & ((M32 << (32 - b)) & M32)
        words.append(torch.from_numpy(w))
        bits.append(torch.from_numpy(b.astype(np.int32)))
    return tuple(words), tuple(bits)


@pytest.mark.parametrize("ri", [0, 1, 8, 17])
def test_dispatch_equals_jax(ri):
    """_concat_batch_combined_comp on CPU tensors equals the JAX
    package's on the same seeded blocks (17: a short last segment)."""
    wc, bc = TE.stream_blocks(3, NM, seed=ri)
    before = concat_cuda.launches
    got, w_out, b_out = TC._concat_batch_combined_comp(wc, bc, ri)
    assert concat_cuda.launches == before
    ref, _, _ = JC._concat_batch_combined_comp(
        tuple(jnp.asarray(w.numpy().astype(np.uint32)) for w in wc),
        tuple(jnp.asarray(b.numpy()) for b in bc), ri)
    S = -(-NM // ri) if ri else 0
    assert got.dtype == torch.int64
    assert got.shape == (3, 1 + S + TC.stream_budget_words_batch(6 * NM))
    assert np.array_equal(got.numpy(), np.asarray(ref).astype(np.int64))
    assert w_out is wc and b_out is bc  # kept per component, not copied


@pytest.mark.parametrize("ri,maxw", [(0, 4096), (3, 4096), (17, 4096),
                                     (0, 900), (8, 900)],
                         ids=["plain", "ri3", "ri17", "drops", "drops-ri8"])
def test_kernel_model_equals_plain(ri, maxw):
    """The kernel's algorithm, modelled in numpy (one tile an image at 24
    MCUs), gives the plain form's combined bit for bit; with a budget
    under the streams the words past it are dropped and the totals stay
    exact."""
    wc, bc = TE.stream_blocks(2, 24, seed=100 + ri)
    got = TE.concat_streams_plain(wc, bc, ri, maxw)
    assert np.array_equal(_model(wc, bc, ri, maxw), got.numpy())
    if maxw < 4096:
        assert int(got[:, 0].max()) > 32 * maxw


@pytest.mark.parametrize("nm,ri,tile,maxw", [
    (24, 0, 5, 4096), (24, 1, 5, 4096), (24, 8, 7, 4096), (24, 17, 5, 4096),
    (24, 30, 4, 4096), (1, 0, None, 4096), (1, 4, None, 64),
    (301, 8, None, 12000), (24, 8, 5, 700)],
    ids=["ri0", "ri1", "ri8", "ri17", "ri-past-nm", "one-mcu",
         "one-mcu-ri", "tiles-of-101", "drops-tiled"])
def test_tiled_model_equals_plain(nm, ri, tile, maxw):
    """The model with several tiles an image: tiles of 4 to 7 MCUs on 24
    (the last one shorter, a restart segment across tiles and across
    several, one segment longer than the image), one MCU, and 301 MCUs in
    tile_layout's own 3 tiles (101, 101, 99); and words dropped past a
    small budget."""
    if nm == 301:
        assert concat_cuda.tile_layout(nm) == (3, 101)
    wc, bc = TE.stream_blocks(2, nm, seed=200 + nm + ri)
    got = TE.concat_streams_plain(wc, bc, ri, maxw)
    assert np.array_equal(_model(wc, bc, ri, maxw, tile), got.numpy())
    assert np.array_equal(_model(wc, bc, ri, maxw, tile, stage_words=7),
                          got.numpy())
    if maxw == 700:
        assert int(got[:, 0].max()) > 32 * maxw


@pytest.mark.parametrize("ri", [0, 1, 3])
def test_model_words_straddle_tiles(ri):
    """Blocks of 2 to 4 bits in tiles of one MCU: a word takes bits of up
    to several tiles (the walk past the tile's end), tiles of only empty
    blocks own no word, and the model still equals the plain form."""
    wc, bc = _short_blocks(2, 30, seed=300 + ri)
    per_mcu = sum(b.reshape(2, 30, -1).sum(-1) for b in bc)
    assert int(per_mcu.max()) < 32 and int((per_mcu == 0).sum()) > 0
    got = TE.concat_streams_plain(wc, bc, ri, 64)
    assert np.array_equal(_model(wc, bc, ri, 64, 1), got.numpy())


def test_tile_layout():
    """At least 8 tiles a 512x512 image, at most 16 for 3840x2160 (each
    tile re-reads its predecessors' counts), none over the kernel's
    shared offsets, and every MCU in one tile."""
    assert concat_cuda.tile_layout(1024) == (8, 128)
    assert concat_cuda.tile_layout(32400) == (16, 2025)
    assert concat_cuda.tile_layout(1) == (1, 1)
    for nm in (1, 2, 127, 129, 1000, 4097, 32400, 40000, 262144):
        tiles, mcus = concat_cuda.tile_layout(nm)
        assert (tiles - 1) * mcus < nm <= tiles * mcus
        assert mcus <= concat_cuda.MAX_TILE_MCUS
        assert tiles <= concat_cuda.MAX_TILES or mcus > (
            concat_cuda.MAX_TILE_MCUS // 2)


def test_words_past_the_bits_are_zero():
    """What the kernel relies on to read only ceil(bits / 32) words: the
    entropy encode leaves every word past a block's bits zero, also for
    the densest blocks."""
    rng = np.random.default_rng(7)
    dense = rng.integers(512, 1024, (64, 64)) * rng.choice([-1, 1], (64, 64))
    for q in (TE.edge_case_blocks(8), dense.astype(np.int32)):
        qt = torch.from_numpy(q)
        for chroma in (False, True):
            w, b = TE.encode_block_words(qt, TE.dc_predictors(qt[:, 0]),
                                         chroma)
            used = -(-b.to(torch.int64) // 32)
            past = torch.arange(64)[None, :] >= used[:, None]
            assert not bool((w * past).any())
            tail = b % 32
            last = w.gather(1, (used - 1).clamp(min=0)[:, None])[:, 0]
            low = torch.where(tail > 0, (1 << (32 - tail)) - 1, 0)
            assert not bool((last & low).any())
    assert int(b.max()) > 32 * 32  # the dense blocks reach words 32 and up


@pytest.mark.parametrize("ri", [0, 4])
def test_overflow_takes_the_host_splice(ri):
    """Noise at quality 100 outgrows the batch budget: those images are
    spliced on the host from the per-component words, and every stream
    equals host_codec's byte for byte."""
    rgbs = np.random.default_rng(9).integers(0, 256, (2, 128, 128, 3),
                                             dtype=np.uint8)
    ticket = TC.encode_batch_dispatch(rgbs, precision="exact", quality=100,
                                      restart_interval=ri, device="cpu")
    maxw = TC.stream_budget_words_batch(6 * 64)
    assert int(ticket["combined"][:, 0].min()) > 32 * maxw  # both overflow
    assert isinstance(ticket["words"], tuple) and len(ticket["words"]) == 3
    got = TC.encode_batch_finish(ticket)
    want = [host_codec.encode(im[..., 0], im[..., 1], im[..., 2],
                              quality=100, restart_interval=ri)
            for im in rgbs]
    assert got == want


def _concat_args(words64=False, bits_dtype=torch.int32):
    """The concat wrapper's arguments on the CPU: int32 words (the 32-bit
    patterns the entropy kernel writes, the layout the wrapper takes) or
    with words64 the plain forms' int64 values, which it refuses."""
    wc, bc = TE.stream_blocks(1, 4, seed=3)
    return (tuple(w if words64 else TE.words32(w) for w in wc),
            tuple(b.to(bits_dtype) for b in bc))


@pytest.mark.parametrize("case", ["cpu", "words dtype", "bits dtype",
                                  "bits rank", "not three"])
def test_concat_wrapper_refuses_before_building(case):
    wc, bc = _concat_args()
    if case == "words dtype":
        wc, bc = _concat_args(words64=True)
    elif case == "bits dtype":
        wc, bc = _concat_args(bits_dtype=torch.int64)
    elif case == "bits rank":
        bc = tuple(b.reshape(-1) for b in bc)
    elif case == "not three":
        wc, bc = wc[:2], bc[:2]
    with pytest.raises(ValueError, match="concat_streams_cuda"):
        concat_cuda.concat_streams_cuda(wc, bc, maxw=4096)
    assert concat_cuda.LIB.handle is None


@pytest.mark.parametrize("case", ["cpu", "dtype", "carry dtype", "rank",
                                  "carry shape"])
def test_histogram_wrapper_refuses_before_building(case):
    q = torch.zeros((2, 8, 64), dtype=torch.int32)
    comps, carry = [q, q[:, :2], q[:, :2]], None
    if case == "dtype":
        comps[1] = comps[1].to(torch.int64)
    elif case == "carry dtype":
        carry = torch.zeros((2, 3), dtype=torch.int64)
    elif case == "rank":
        comps[0] = q.reshape(-1, 64)
    elif case == "carry shape":
        carry = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="symbol_histograms_batch_cuda"):
        pack_cuda.symbol_histograms_batch_cuda(*comps, carry=carry)
    assert pack_cuda.LIB.handle is None
