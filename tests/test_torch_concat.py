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


def _model(words, bits, ri: int, maxw: int) -> np.ndarray:
    """The CUDA kernel's algorithm in numpy: pass 1 scans the MCUs' bit
    counts with the byte padding of segment s inserted before segment
    s + 1's first MCU; pass 2 ORs only each block's ceil(bits / 32) used
    words, shifted to the block's phase, into the zeroed stream."""
    N, nm = bits[1].shape
    S = -(-nm // ri) if ri else 0
    out = np.zeros((N, 1 + S + maxw), np.int64)
    for n in range(N):
        mcu = np.concatenate([bits[0][n].numpy().reshape(nm, 4),
                              bits[1][n].numpy()[:, None],
                              bits[2][n].numpy()[:, None]], 1).astype(np.int64)
        seg = (np.add.reduceat(mcu.sum(1), np.arange(0, nm, ri)) if ri
               else np.zeros(0, np.int64))
        pad = (8 - seg % 8) % 8
        off, goff = 0, np.zeros((nm, 6), np.int64)
        for m in range(nm):
            if ri and m and m % ri == 0:
                off += pad[m // ri - 1]
            goff[m] = off + np.concatenate([[0], np.cumsum(mcu[m])[:-1]])
            off += mcu[m].sum()
        out[n, 0] = off + (pad[-1] if ri else 0)
        out[n, 1:1 + S] = seg
        stream = out[n, 1 + S:]
        for c, (w_c, b_c) in enumerate(zip(words, bits)):
            for i in range(b_c.shape[1]):
                m, j = (i // 4, i % 4) if c == 0 else (i, 3 + c)
                nb, o = int(b_c[n, i]), int(goff[m, j])
                used = w_c[n, i, :-(-nb // 32)].numpy()
                r, q = o & 31, o >> 5
                for k in range(used.size + 1):
                    cur = int(used[k]) if k < used.size else 0
                    prev = int(used[k - 1]) if k else 0
                    v = (cur >> r) | ((prev << (32 - r)) & 0xFFFFFFFF
                                      if r else 0)
                    if v and q + k < maxw:
                        stream[q + k] |= v
    return out


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
    """The kernel's two passes, modelled in numpy, give the plain form's
    combined bit for bit; with a budget under the streams the words past
    it are dropped and the totals stay exact."""
    wc, bc = TE.stream_blocks(2, 24, seed=100 + ri)
    got = TE.concat_streams_plain(wc, bc, ri, maxw)
    assert np.array_equal(_model(wc, bc, ri, maxw), got.numpy())
    if maxw < 4096:
        assert int(got[:, 0].max()) > 32 * maxw


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


def _concat_args(dtype=torch.int64, bits_dtype=torch.int32):
    wc, bc = TE.stream_blocks(1, 4, seed=3)
    return (tuple(w.to(dtype) for w in wc),
            tuple(b.to(bits_dtype) for b in bc))


@pytest.mark.parametrize("case", ["cpu", "words dtype", "bits dtype",
                                  "bits rank", "not three"])
def test_concat_wrapper_refuses_before_building(case):
    wc, bc = _concat_args()
    if case == "words dtype":
        wc, bc = _concat_args(dtype=torch.int32)
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
