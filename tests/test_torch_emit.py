"""The batched entropy encode of jpezy_tpu_torch (entropy.encode_blocks_batch,
what torch_codec._emit_local runs) against jpezy_tpu.

On CPU tensors encode_blocks_batch takes encode_blocks_batch_plain: per
component the DC predictor chain of each image (reset every restart
interval, the carry at the image's first block), then the plain emissions
and pack.  On CUDA tensors it launches one kernel for the three
components, which finds the predictors itself; tests/test_torch_cuda.py
and chip_smoke.py hold it to the plain form on the card.  Here, on 2
images of 128x64: the plain form equals the per-component composition
that _emit_local ran before the kernel found the predictors, and the JAX
package's parallel/sharded.py:_emit_local (restart intervals 0, 1 and 8,
one custom table set, gray) and jax_codec._encode_batch_custom (a table
set per image); a carry moves only each chain's first predictor; CPU
tensors launch and build nothing.  Each JAX shape is compiled once per
module.  Tolerance 0: all of it is integer-exact.
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
from jpezy_tpu_torch.ops import entropy as TE
from jpezy_tpu_torch.ops import pack_cuda

from test_torch_host_copies import host_runtime  # noqa: F401 (autouse)

H, W = 64, 128  # 32 MCUs an image: 128 luma and 32 chroma blocks


def _quantize(gray: bool):
    from imagegen import make_test_image

    rgbs = np.stack([make_test_image(H, W, seed=500 + i) for i in range(2)])
    y, cb, cr = HG.host_rgb_to_ycc420(rgbs)
    return TC._quantize_local_ycc(
        torch.from_numpy(y), torch.from_numpy(cb), torch.from_numpy(cr),
        gray=gray, dtype=torch.float64, rounded=False)


@pytest.fixture(scope="module")
def quantized():
    return _quantize(False)


@pytest.fixture(scope="module")
def tables(quantized):
    """(per-image (luma, chroma) tables with a leading [2] axis, one set
    (luma, chroma) for both images), optimal for the batch, JAX order."""
    hists = TC._symbol_histograms_batch(*quantized).numpy()
    _, ytabs, ctabs = TC._optimal_tables(hists)
    total = hists.sum(axis=0)
    _, _, *yone = T.optimal_flat_tables(total[0], total[1])
    _, _, *cone = T.optimal_flat_tables(total[2], total[3])
    return (ytabs, ctabs), (tuple(yone), tuple(cone))


@functools.lru_cache(maxsize=None)
def _jax_emit(ri: int, custom: bool):
    """JAX's shard-local entropy encode, jitted once per (ri, tables)."""
    def fn(yq, cbq, crq, yt, ct):
        return JS._emit_local(yq, cbq, crq, tile_axis=None, use_pallas=False,
                              tables=(yt, ct) if custom else (None, None),
                              restart_interval=ri, interleave=False)
    return jax.jit(fn)


def _jax(q, ri: int = 0, tabs=None):
    args = [jnp.asarray(c.numpy()) for c in q]
    yt, ct = (None, None) if tabs is None else (
        tuple(jnp.asarray(t) for t in tabs[0]),
        tuple(jnp.asarray(t) for t in tabs[1]))
    words, bits = _jax_emit(ri, tabs is not None)(*args, yt, ct)
    return ([np.asarray(w).astype(np.int64) for w in words],
            [np.asarray(b).astype(np.int64) for b in bits])


def _old_composition(q, ri: int, carry=None, tables=(None, None)):
    """What _emit_local ran before the kernel found the predictors: per
    component the plain predictor chain, then the per-component encode."""
    words, bits = [], []
    for c, (qc, chroma, bpm, tabs) in enumerate((
            (q[0], False, 4, tables[0]), (q[1], True, 1, tables[1]),
            (q[2], True, 1, tables[1]))):
        n, b, _ = qc.shape
        pred = TE.dc_predictors_restart(
            qc[:, :, 0], ri * bpm, None if carry is None else carry[:, c])
        w, bt = TE.encode_block_words(qc.reshape(-1, 64), pred.reshape(-1),
                                      chroma, tables=tabs,
                                      blocks_per_image=b)
        words.append(w.reshape(n, b, 64))
        bits.append(bt.reshape(n, b))
    return words, bits


def _same(got, want):
    for g, w in zip(got[0] + got[1], list(want[0]) + list(want[1])):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        w = w.numpy() if isinstance(w, torch.Tensor) else w
        assert g.shape == w.shape and np.array_equal(g, w)


def _carry(n: int, seed: int = 7) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -1000, 1000, (n, 3)).astype(np.int32))


@pytest.mark.parametrize("ri", [0, 1, 8])
def test_plain_equals_jax(quantized, ri):
    got = TE.encode_blocks_batch_plain(*quantized, ri)
    _same(got, _jax(quantized, ri))
    assert all(g.dtype == torch.int64 for g in got[0])
    assert all(b.dtype == torch.int32 for b in got[1])


@pytest.mark.parametrize("ri,carry", [(0, False), (1, False), (8, False),
                                      (0, True), (8, True)],
                         ids=["ri0", "ri1", "ri8", "carry", "carry-ri8"])
def test_plain_equals_old_composition(quantized, ri, carry):
    c = _carry(2) if carry else None
    _same(TE.encode_blocks_batch_plain(*quantized, ri, c),
          _old_composition(quantized, ri, c))


@pytest.mark.parametrize("ri", [0, 8])
def test_carry_moves_only_the_first_predictor(quantized, ri):
    """The carry is each image's first DC predictor per component: only
    each chain's first block changes, its DC difference by the carry (with
    restarts the first segment still resets it to 0, as
    dc_predictors_restart defines it)."""
    carry = _carry(2, seed=8)
    with_c = TE.encode_blocks_batch_plain(*quantized, ri, carry)
    without = TE.encode_blocks_batch_plain(*quantized, ri)
    for c in range(3):
        differs = (with_c[1][c] != without[1][c]) | (
            with_c[0][c] != without[0][c]).any(-1)
        assert not bool(differs[:, 1:].any())
        assert bool(differs[:, 0].any()) == (ri == 0)


def test_single_custom_set_equals_jax(quantized, tables):
    _, one = tables
    _same(TE.encode_blocks_batch_plain(*quantized, tables=one),
          _jax(quantized, 0, one))


def test_per_image_sets_equal_jax(quantized, tables):
    """A table set per image equals jax_codec._encode_batch_custom's words
    and bits (MCU order there), and each image coded alone with its set."""
    per_image, _ = tables
    words, bits = TE.encode_blocks_batch_plain(*quantized, 2,
                                               tables=per_image)
    _, ref_w, ref_b = JC._encode_batch_custom(
        *(jnp.asarray(c.numpy()) for c in quantized),
        tuple(jnp.asarray(t) for t in per_image[0]),
        tuple(jnp.asarray(t) for t in per_image[1]), restart_interval=2)
    nm = quantized[1].shape[1]
    mcu_w = torch.cat([words[0].reshape(2, nm, 4, 64),
                       words[1].reshape(2, nm, 1, 64),
                       words[2].reshape(2, nm, 1, 64)], 2).reshape(2, -1, 64)
    mcu_b = torch.cat([bits[0].reshape(2, nm, 4), bits[1].reshape(2, nm, 1),
                       bits[2].reshape(2, nm, 1)], 2).reshape(2, -1)
    assert np.array_equal(mcu_w.numpy(), np.asarray(ref_w).astype(np.int64))
    assert np.array_equal(mcu_b.numpy(), np.asarray(ref_b).astype(np.int64))
    for i in range(2):
        one = tuple(tuple(t[i] for t in tabs) for tabs in per_image)
        w1, b1 = TE.encode_blocks_batch_plain(
            *(c[i:i + 1] for c in quantized), 2, tables=one)
        _same((w1, b1), ([w[i:i + 1] for w in words],
                         [b[i:i + 1] for b in bits]))


def test_gray_equals_jax():
    gray = _quantize(True)
    assert not bool(gray[1].any()) and not bool(gray[2].any())
    _same(TE.encode_blocks_batch_plain(*gray), _jax(gray, 0))


def test_emit_local_takes_the_dispatcher_on_cpu(quantized, tables):
    """_emit_local is encode_blocks_batch; on CPU tensors that is the
    plain form, and nothing is launched, built or loaded."""
    before = (pack_cuda.launches, pack_cuda.encode_launches)
    carry = _carry(2)
    for kw in ({}, {"carry": carry}, {"tables": tables[1]}):
        got = TC._emit_local(*quantized, 8, **kw)
        _same(got, TE.encode_blocks_batch_plain(*quantized, 8, **kw))
    assert (pack_cuda.launches, pack_cuda.encode_launches) == before
    assert pack_cuda.LIB.handle is None


def test_meta_device_raises(quantized):
    meta = tuple(c.to("meta") for c in quantized)
    with pytest.raises(ValueError, match="unsupported device"):
        TE.encode_blocks_batch(*meta)
    with pytest.raises(ValueError, match="unsupported device"):
        TE.encode_block_words(meta[0].reshape(-1, 64), meta[0][:, :, 0],
                              False)


@pytest.mark.parametrize("case", ["cpu", "dtype", "carry dtype", "rank",
                                  "carry shape", "tables", "table sets"])
def test_batched_wrapper_refuses_before_building(case):
    q = torch.zeros((2, 8, 64), dtype=torch.int32)
    comps, kw = [q, q[:, :2], q[:, :2]], {}
    if case == "dtype":
        comps[1] = comps[1].to(torch.int64)
    elif case == "carry dtype":
        kw["carry"] = torch.zeros((2, 3), dtype=torch.int64)
    elif case == "rank":
        comps[0] = q.reshape(-1, 64)
    elif case == "carry shape":
        kw["carry"] = torch.zeros((3, 2), dtype=torch.int32)
    elif case == "tables":
        kw["tables"] = (torch.zeros((1, 348), dtype=torch.int32),)
    elif case == "table sets":
        rows = torch.zeros((3, 348), dtype=torch.int32)
        kw["tables"] = (rows, rows)
    with pytest.raises(ValueError, match="encode_blocks_batch_cuda"):
        pack_cuda.encode_blocks_batch_cuda(*comps, **kw)
    assert pack_cuda.LIB.handle is None
