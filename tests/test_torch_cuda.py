"""CUDA-only checks of jpezy_tpu_torch: the hand-written kernels (the pack
alone, the batched entropy encode with its predictors, the symbol
histograms, the one-launch stream concat, the Huffman scan of the device
decode, the block transforms and the rgb transport's colour kernels and
fast IDCT) against their plain torch versions, and
the codec on the card against the codec on the CPU.  Marked
`cuda`; each test skips when no CUDA device is present (decided inside the
fixture, never at import).  On a card:

    python -m pytest tests/test_torch_cuda.py -q
"""
import functools

import numpy as np
import pytest
import torch

from jpezy_tpu_torch.codec import host_glue as HG
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.ops import entropy as TE
from jpezy_tpu_torch.ops import entropy_decode as ED
from jpezy_tpu_torch.testing import colour_sets as CS
from jpezy_tpu_torch.testing import exact_ties as XT
from jpezy_tpu_torch.testing import rgb_ties as RT

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _blocks(dev):
    """Quantized [B, 64] int32 blocks with their chroma flag: the three
    components of two test images, dense worst-case blocks and the
    edge-case blocks."""
    from imagegen import make_test_image

    rgbs = np.stack([make_test_image(128, 128, seed=120 + i) for i in range(2)])
    y, cb, cr = HG.host_rgb_to_ycc420(rgbs)
    q = TC._quantize_local_ycc(*(torch.from_numpy(a).to(dev) for a in (y, cb, cr)),
                               gray=False, dtype=torch.float32, rounded=False)
    rng = np.random.default_rng(121)
    worst = rng.integers(1, 1024, (512, 64)) * rng.choice([-1, 1], (512, 64))
    worst[:, 0] = rng.integers(-1024, 1017, 512)
    blocks = [(qc.reshape(-1, 64), i > 0) for i, qc in enumerate(q)]
    blocks.append((torch.from_numpy(worst.astype(np.int32)).to(dev), False))
    edge = torch.from_numpy(TE.edge_case_blocks(122)).to(dev)
    blocks += [(edge, False), (edge[:-1], True)]     # even and odd counts
    return blocks


def _emissions(dev):
    return [TE.block_emissions(b, TE.dc_predictors(b[:, 0]), chroma)
            for b, chroma in _blocks(dev)]


def test_pack_kernel_matches_plain(cuda):
    from jpezy_tpu_torch.ops import pack_cuda

    ems = _emissions(cuda)
    before = (pack_cuda.launches, pack_cuda.encode_launches)
    for hi, lo, nb in ems:
        wk, bk = pack_cuda.pack_words_cuda(hi, lo, nb)
        wp, bp = TE.pack_block_words_plain(hi, lo, nb)
        torch.cuda.synchronize()
        assert wk.dtype == torch.int64 and torch.equal(wk, wp)
        assert torch.equal(bk, bp)
    assert pack_cuda.launches - before[0] == len(ems)
    assert pack_cuda.encode_launches == before[1]
    assert int(TE.pack_block_words_plain(*ems[3])[1].max()) > 32 * 32
    wk, bk = TE.pack_block_words(*ems[0])           # the dispatching form
    assert torch.equal(wk, TE.pack_block_words_plain(*ems[0])[0])
    assert pack_cuda.launches - before[0] == len(ems) + 1


def test_fused_kernel_matches_plain(cuda):
    """The batched entropy kernel, one launch each, on every block set as
    one image's three components (Y with the luma tables, Cb and Cr with
    the chroma ones): words and bits equal the plain form's."""
    from jpezy_tpu_torch.ops import pack_cuda

    blocks = _blocks(cuda)
    before = (pack_cuda.launches, pack_cuda.encode_launches)
    for q, _ in blocks:
        k = max(1, q.shape[0] // 4)
        comps = (q[None], q[None, :k], q[None, -k:])
        wk, bk = pack_cuda.encode_blocks_batch_cuda(*comps)
        wp, bp = TE.encode_blocks_batch_plain(*(c.cpu() for c in comps))
        torch.cuda.synchronize()
        for a, b in zip(wk + bk, wp + bp):
            assert torch.equal(a.cpu(), b)
        assert all(w.dtype == torch.int64 for w in wk)
    assert pack_cuda.encode_launches - before[1] == len(blocks)
    assert pack_cuda.launches == before[0]


def _batch_cases(dev):
    """(label, (yq, cbq, crq), restart_interval, carry) of the batched
    entropy kernel: the real components with restart intervals 0, 1 and
    8 (a segment shorter than a warp's blocks, and longer), a carry, and
    images whose odd chroma block counts put a warp's two blocks in two
    images."""
    q, _, _ = _optimize_inputs(dev)
    rng = np.random.default_rng(173)
    carry = torch.from_numpy(rng.integers(-1000, 1000, (3, 3)).astype(
        np.int32)).to(dev)
    edge = torch.from_numpy(TE.edge_case_blocks(174)).to(dev)
    n = edge.shape[0] // 13
    blk = edge[:n * 13].reshape(n, 13, 64)
    odd = (blk[:, :7], blk[:, 7:10], blk[:, 10:])
    return ([(f"real ri={ri}", q, ri, None) for ri in (0, 1, 8)]
            + [("real, carry", q, 0, carry), ("real, carry ri=1", q, 1, carry),
               ("odd", odd, 0, None), ("odd ri=1", odd, 1, None)])


def test_fused_kernel_dispatch_predictors_and_tables(cuda):
    """encode_blocks_batch launches the kernel once for CUDA tensors and
    finds every predictor itself (restarts, a carry, warps across images);
    the Annex K tables passed as the caller's (the custom-table
    instantiation) give the fixed-table words; an empty batch launches
    nothing."""
    from jpezy_tpu_torch.ops import pack_cuda

    annex_k = tuple(TE.annex_k_tables("cpu", c) for c in (False, True))
    for label, comps, ri, carry in _batch_cases(cuda):
        before = pack_cuda.encode_launches
        got = TE.encode_blocks_batch(*comps, ri, carry)
        as_custom = TE.encode_blocks_batch(*comps, ri, carry, annex_k)
        want = TE.encode_blocks_batch_plain(
            *(c.cpu() for c in comps), ri,
            None if carry is None else carry.cpu())
        torch.cuda.synchronize()
        assert pack_cuda.encode_launches - before == 2, label
        for a, b, c in zip(got[0] + got[1], as_custom[0] + as_custom[1],
                           want[0] + want[1]):
            assert torch.equal(a.cpu(), c) and torch.equal(b.cpu(), c), label
    q = _batch_cases(cuda)[0][1]
    before = pack_cuda.encode_launches
    empty_w, empty_b = pack_cuda.encode_blocks_batch_cuda(*(c[:0] for c in q))
    assert empty_w[0].shape == (0, q[0].shape[1], 64)
    assert empty_b[1].shape == (0, q[1].shape[1])
    assert pack_cuda.encode_launches == before  # nothing to launch


def test_fused_and_concat_kernels_4k(cuda):
    """One 3840x2160 image (32,400 MCUs: the concat's 16 tiles of 2,025
    MCUs) without and with restart markers: the entropy kernel's words
    and bits, and the concat's combined, equal the plain forms'."""
    from jpezy_tpu_torch.ops import concat_cuda

    img = _transform_images(2160, 3840, 175, n=1)
    q = TC._quantize_batch_rgb(torch.from_numpy(img).to(cuda))
    assert concat_cuda.tile_layout(q[1].shape[1]) == (16, 2025)
    for ri in (0, 8):
        wc, bc = TC._emit_local(*q, ri)
        wp, bp = TE.encode_blocks_batch_plain(*(c.cpu() for c in q), ri)
        torch.cuda.synchronize()
        for a, b in zip(wc + bc, wp + bp):
            assert torch.equal(a.cpu(), b), ri
        got, _, _ = TC._concat_batch_combined_comp(wc, bc, ri)
        maxw = got.shape[1] - 1 - (-(-q[1].shape[1] // ri) if ri else 0)
        want = TE.concat_streams_plain(wp, bp, ri, maxw)
        assert torch.equal(got.cpu(), want), ri


def test_codec_on_card_matches_cpu(cuda):
    from imagegen import make_test_image

    from jpezy_tpu_torch.ops import concat_cuda, pack_cuda

    rgbs = np.stack([make_test_image(64, 64, seed=130 + i) for i in range(2)])
    before = (pack_cuda.launches, pack_cuda.encode_launches,
              concat_cuda.launches)
    exact = TC.encode_batch(rgbs, precision="exact", device=cuda)
    # one fused launch for the three components and one concat; the pack
    # alone is off the codec's path
    assert (pack_cuda.launches, pack_cuda.encode_launches,
            concat_cuda.launches) == (before[0], before[1] + 1, before[2] + 1)
    assert exact == TC.encode_batch(rgbs, precision="exact", device="cpu")
    flat, kw, *_ = TC._decode_host_prep(exact, gray=False, precision="fast",
                                        transport=None)
    on_card = TC._decode_fused_batch_ycc420(
        torch.from_numpy(flat).to(cuda), **kw).cpu()
    on_cpu = TC._decode_fused_batch_ycc420(torch.from_numpy(flat), **kw)
    # float32 IDCT summation order differs between cuBLAS and the CPU
    assert (on_card.to(torch.int32) - on_cpu.to(torch.int32)).abs().max() <= 1


PER_LANE = ("words", "nblk", "tsel", "rawlen", "skip0", "preds0")


def _lanes(kw, index):
    """The decode_segments arguments `kw` with the lanes `index`."""
    return {k: (v[index] if k in PER_LANE else v) for k, v in kw.items()}


def _repad(kw, lw):
    wide = np.zeros((kw["words"].shape[0], lw), np.uint32)
    wide[:, :kw["words"].shape[1]] = kw["words"]
    return dict(kw, words=wide)


@functools.lru_cache(maxsize=None)
def _scan_cases():
    """{label: kwargs of decode_segments as numpy arrays} for the scan
    kernel: real restart segments, noise, pseudo-segments of the indexed
    transport, a mixed-table batch, seeded corruptions of the first, and
    the shapes the kernel's layout is sensitive to (row lengths, more
    block slots than blocks, a segment count that fills no whole thread
    block, segments without blocks, two table sets in one thread block)."""
    from imagegen import make_test_image

    from jpezy_tpu_torch.bitstream.reader import parse
    from jpezy_tpu_torch.codec import host_codec

    rgbs = np.stack([make_test_image(128, 128, seed=140 + i) for i in range(3)])
    rng = np.random.default_rng(141)
    noise = rng.integers(0, 256, (2, 64, 64, 3), np.uint8)
    cases = {}

    def restart_case(label, streams, ri):
        pjs = [parse(s) for s in streams]
        nmcu = (pjs[0].props.height // 16) * (pjs[0].props.width // 16)
        nseg = -(-nmcu // ri)
        words, nblk, rawlen = HG._device_host_frontend(pjs, nmcu, ri, nseg)
        lut, tsel = HG._device_luts(pjs, nseg)
        cases[label] = dict(words=words, nblk=nblk, lut=lut, tsel=tsel,
                            rawlen=rawlen, max_blocks=ri * 6)

    std = TC.encode_batch(rgbs, restart_interval=3, device="cpu")
    restart_case("real", std, 3)
    restart_case("noise", TC.encode_batch(noise, restart_interval=1,
                                          quality=95, device="cpu"), 1)
    opt = [host_codec.encode(im[..., 0], im[..., 1], im[..., 2],
                             optimize=True, restart_interval=3) for im in rgbs]
    restart_case("mixed tables", [std[0], opt[1], opt[2]], 3)
    pjs = [parse(s) for s in TC.encode_batch(rgbs, device="cpu")]
    words, nblk, skip0, preds0 = HG._indexed_host_frontend(pjs, 64, 8, 8)
    lut, tsel = HG._device_luts(pjs, 8)
    cases["indexed"] = dict(words=words, nblk=nblk, lut=lut, tsel=tsel,
                            skip0=skip0, preds0=preds0, max_blocks=48)
    real = cases["real"]
    for seed in range(4):
        cases[f"corrupt {seed}"] = dict(real, words=ED.corrupt_rows(
            real["words"], real["rawlen"], 150 + seed))
    lw = real["words"].shape[1]
    cases["rows of 64 words"] = _repad(real, max(64, 2 * lw))
    cases["rows of 128 words"] = _repad(real, max(128, 4 * lw))
    restart_case("long rows", TC.encode_batch(
        noise[:1], restart_interval=8, quality=95, device="cpu"), 8)
    assert cases["long rows"]["words"].shape[1] > 64     # past two chunks
    cases["more slots than blocks"] = dict(real, max_blocks=25)
    cases["ragged segment count"] = _lanes(real, slice(0, 37))
    empty = dict(real, nblk=real["nblk"].copy(), rawlen=None)
    empty["nblk"][::3] = 0
    empty["nblk"][1::5] = 7
    del empty["rawlen"]
    cases["segments without blocks"] = empty
    mixed = cases["mixed tables"]
    n = mixed["words"].shape[0]
    cases["interleaved tables"] = _lanes(
        mixed, np.arange(n).reshape(3, -1).T.reshape(-1))
    return cases


SCAN_CASES = ("real", "noise", "mixed tables", "indexed", "corrupt 0",
              "corrupt 1", "corrupt 2", "corrupt 3", "rows of 64 words",
              "rows of 128 words", "long rows", "more slots than blocks",
              "ragged segment count", "segments without blocks",
              "interleaved tables")


def _scan_args(kw, dev):
    out = {}
    for k, v in kw.items():
        if k == "words":
            out[k] = ED.words_tensor(v).to(dev)
        elif k == "max_blocks":
            out[k] = v
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(dev)
    return out


@pytest.mark.parametrize("label", SCAN_CASES)
def test_scan_kernel_matches_plain(cuda, label):
    from jpezy_tpu_torch.ops import scan_cuda

    kw = _scan_cases()[label]
    before = scan_cuda.launches
    blocks, bad = ED.decode_segments(**_scan_args(kw, cuda))
    pb, pbad = ED.decode_segments_plain(**_scan_args(kw, "cpu"))
    torch.cuda.synchronize()
    assert blocks.dtype == torch.int16 and bad.dtype == torch.bool
    assert torch.equal(blocks.cpu(), pb)
    assert torch.equal(bad.cpu(), pbad)
    if label.startswith("corrupt"):
        assert pbad.any() and not pbad.all()
    else:
        assert not pbad.any()
    assert scan_cuda.launches - before == 1
    if label == "interleaved tables":
        first = kw["tsel"][:scan_cuda.layout()["warps_per_block"]]
        assert len(set(first.tolist())) > 1    # one thread block, two sets
    if label == "real":
        args = _scan_args(kw, cuda)
        empty, _ = ED.decode_segments(**dict(args, max_blocks=0))
        assert empty.shape == (args["words"].shape[0], 0, 64)
        assert scan_cuda.launches - before == 1       # nothing to launch


def test_scan_kernel_overwrites_its_output(cuda):
    """The kernel writes every block slot, the undecoded ones as zeros: a
    buffer filled with a pattern comes back equal to the plain version."""
    from jpezy_tpu_torch.ops import scan_cuda

    kw = _scan_cases()["segments without blocks"]
    args = _scan_args(dict(kw, max_blocks=kw["max_blocks"] + 3), cuda)
    S, mb = args["words"].shape[0], args["max_blocks"]
    blocks = torch.full((S, mb, 64), 0x5A5A, dtype=torch.int16, device=cuda)
    bad = torch.full((S,), 0x5A, dtype=torch.uint8, device=cuda)
    scan_cuda._launch([args.get(k) for k in (
        "words", "nblk", "lut", "tsel", "rawlen", "skip0", "preds0")],
        blocks, bad)
    pb, pbad = ED.decode_segments_plain(
        **{k: (v.cpu() if torch.is_tensor(v) else v) for k, v in args.items()})
    torch.cuda.synchronize()
    assert torch.equal(blocks.cpu(), pb)
    assert torch.equal(bad.cpu().bool(), pbad) and int(bad.max()) <= 1


def test_scan_kernel_index_bits_are_the_models(cuda):
    """entropy_decode.first_level_table models the built kernel's table."""
    from jpezy_tpu_torch.ops import scan_cuda

    assert scan_cuda.layout()["first_level_bits"] == ED.FIRST_LEVEL_BITS


def _scan_blocks(streams, ri):
    """The quantized blocks of restart streams, as the CPU's Huffman scan
    decodes them: [N * nseg, ri * 6, 64] int32."""
    from jpezy_tpu_torch.bitstream.reader import parse

    pjs = [parse(s) for s in streams]
    nmcu = (pjs[0].props.height // 16) * (pjs[0].props.width // 16)
    nseg = -(-nmcu // ri)
    words, nblk, rawlen = HG._device_host_frontend(pjs, nmcu, ri, nseg)
    lut, tsel = HG._device_luts(pjs, nseg)
    lanes = {k: torch.from_numpy(np.ascontiguousarray(v, np.int32))
             for k, v in dict(nblk=nblk, lut=lut, tsel=tsel,
                              rawlen=rawlen).items()}
    blocks, bad = ED.decode_segments(ED.words_tensor(words),
                                     max_blocks=ri * 6, **lanes)
    assert not bad.any()
    return blocks.numpy().astype(np.int32)


def _fdct_model_cpu(y, cb, cr, *, gray, rounded, qtables=None):
    """BT.fdct_quantize on CPU tensors through the fDCT kernel's numpy
    model (the separable form) in place of the plain version."""
    from jpezy_tpu_torch.ops import block_transform as BT

    assert not y.is_cuda
    qt = None if qtables is None else tuple(
        np.asarray(torch.as_tensor(t).cpu()) for t in qtables)
    return tuple(torch.from_numpy(b) for b in BT.fdct_quantize_model(
        y.numpy(), cb.numpy(), cr.numpy(), gray=gray, rounded=rounded,
        qtables=qt))


def test_device_transports_on_card_match_cpu(cuda, monkeypatch):
    from imagegen import make_test_image

    from jpezy_tpu_torch.ops import block_transform as BT
    from jpezy_tpu_torch.ops import scan_cuda

    rgbs = np.stack([make_test_image(64, 64, seed=160 + i) for i in range(2)])
    restart = TC.encode_batch(rgbs, restart_interval=2, device=cuda)
    assert TC.encode_batch(rgbs, restart_interval=2, precision="exact",
                           device=cuda) == TC.encode_batch(
        rgbs, restart_interval=2, precision="exact", device="cpu")
    # fast mode: byte for byte the CPU's streams with the kernel's model in
    # place of the plain product
    with monkeypatch.context() as m:
        m.setattr(BT, "fdct_quantize", _fdct_model_cpu)
        assert restart == TC.encode_batch(rgbs, restart_interval=2,
                                          device="cpu")
    # and beside the CPU's plain product (the 64-term form, which may round
    # a coefficient apart at a truncation tie): the scan's blocks of both
    # streams within 1, on at most 2e-3 of them
    got, want = (_scan_blocks(st, 2) for st in (
        restart, TC.encode_batch(rgbs, restart_interval=2, device="cpu")))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    assert (got != want).sum() <= 2e-3 * got.size
    plain = TC.encode_batch(rgbs, device="cpu")
    before = scan_cuda.launches
    a, _ = TC.decode_batch(restart, device=cuda)              # auto: device
    assert scan_cuda.launches - before == 1     # the auto call alone
    b, _ = TC.decode_batch(restart, transport="ycc420", device=cuda)
    assert scan_cuda.launches - before == 1
    c, _ = TC.decode_batch(plain, transport="indexed", device=cuda)
    assert scan_cuda.launches - before == 2
    d, _ = TC.decode_batch(plain, transport="ycc420", device=cuda)
    assert scan_cuda.launches - before == 2
    assert np.array_equal(a, b) and np.array_equal(c, d)
    # float32 IDCT summation order differs between cuBLAS and the CPU
    cpu, _ = TC.decode_batch(restart, device="cpu")
    assert np.abs(a.astype(int) - cpu.astype(int)).max() <= 2
    data = bytearray(restart[0])
    from jpezy_tpu_torch.bitstream.reader import parse
    es = parse(restart[0]).entropy_start
    data[es:es + 6] = bytes(6)
    with pytest.raises(ValueError, match="corrupt"):
        TC.decode_batch([bytes(data)], transport="device", device=cuda)


def _optimize_inputs(dev):
    """(q [B, 64], pred [B], blocks_per_image) of three components of three
    test images, per-image tables of luma and chroma in the JAX order, and
    the edge-case and long-emission blocks."""
    from imagegen import make_test_image

    rgbs = np.stack([make_test_image(64, 48, seed=170 + i) for i in range(3)])
    y, cb, cr = HG.host_rgb_to_ycc420(rgbs)
    q = TC._quantize_local_ycc(*(torch.from_numpy(a).to(dev)
                                 for a in (y, cb, cr)),
                               gray=False, dtype=torch.float32, rounded=False)
    hists = TC._symbol_histograms_batch(*(t.cpu() for t in q)).numpy()
    _, ytabs, ctabs = TC._optimal_tables(hists)
    return q, ytabs, ctabs


def _hist_cases(dev):
    """(label, (yq, cbq, crq), restart_interval, carry) of the batched
    histogram kernel: the real components; images of 1 to 140 blocks cut
    from the edge-case and long-emission blocks (Y 4 times chroma, as the
    codec has it, and not); a carry; restarts."""
    q, _, _ = _optimize_inputs(dev)
    edge = torch.from_numpy(TE.edge_case_blocks(171)).to(dev)
    longq = torch.from_numpy(TE.long_emission_blocks()).to(dev)
    cases = [("real", q, 0, None), ("real", q, 2, None)]
    src = torch.cat([edge] * 4)
    for ny, nc in ((4, 1), (140, 35), (1, 1), (7, 3), (128, 129)):
        n = src.shape[0] // (ny + 2 * nc)
        blk = src[:n * (ny + 2 * nc)].reshape(n, -1, 64)
        comps = (blk[:, :ny], blk[:, ny:ny + nc], blk[:, ny + nc:])
        cases += [(f"edge {ny}/{nc}", comps, ri, None) for ri in (0, 1, 3)]
    lq = longq.reshape(2, 4, 64)
    cases.append(("long", (lq, lq[:, :1], lq[:, 1:2]), 0, None))
    rng = np.random.default_rng(172)
    for ri in (0, 1, 2):
        carry = torch.from_numpy(rng.integers(-1000, 1000, (3, 3)).astype(
            np.int32)).to(dev)
        cases.append((f"carry ri={ri}", q, ri, carry))
    return cases


def test_histogram_kernel_matches_plain(cuda):
    """Per-image symbol counts of the batched kernel (one launch for the
    three components, predictors derived in it) equal the plain form's:
    real components, images of 1 to 140 blocks, edge-case and
    long-emission blocks, with restarts and a carry."""
    from jpezy_tpu_torch.ops import pack_cuda

    cases = _hist_cases(cuda)
    before = pack_cuda.histogram_launches
    for label, comps, ri, carry in cases:
        got = TE.symbol_histograms_batch(*comps, ri, carry)
        want = TE.symbol_histograms_batch_plain(
            *(c.cpu() for c in comps), ri,
            None if carry is None else carry.cpu())
        torch.cuda.synchronize()
        assert got.dtype == torch.int32, label
        assert torch.equal(got.cpu(), want), label
    assert pack_cuda.histogram_launches - before == len(cases)


def test_histogram_kernel_refuses_shapes(cuda):
    from jpezy_tpu_torch.ops import pack_cuda

    q = torch.zeros((2, 8, 64), dtype=torch.int32, device=cuda)
    for comps, carry in (((q, q[:, :2], q[:, :3]), None),
                         ((q, q[:1, :2], q[:1, :2]), None),
                         ((q, q[:, :2], q[:, :2]),
                          torch.zeros((2, 2), dtype=torch.int32,
                                      device=cuda))):
        with pytest.raises(ValueError, match="shape"):
            pack_cuda.symbol_histograms_batch_cuda(*comps, carry=carry)


def _concat_cases(dev):
    """(label, words, bits, restart_interval, maxw, tile_mcus) of the
    concat kernel on the card: real blocks with and without restarts
    (intervals 0, 1, 8, 17 and one past the image), gray, per-image table
    sets, dense noise with the default and a shrunk budget, seeded blocks
    whose bits reach word 63, in tile_layout's tiles and in tiles of 1 to
    7 MCUs (segments across tiles, the last tile shorter), one-MCU images,
    and blocks of 2 to 4 bits in tiles of one MCU (a word across several
    tiles, tiles that own no word)."""
    from imagegen import make_test_image

    rgbs = np.stack([make_test_image(64, 48, seed=180 + i) for i in range(3)])
    noise = np.random.default_rng(181).integers(0, 256, (2, 64, 64, 3),
                                                dtype=np.uint8)
    q = TC._quantize_batch_rgb(torch.from_numpy(rgbs).to(dev))
    qg = TC._quantize_batch_rgb(torch.from_numpy(rgbs).to(dev), gray=True)
    qn = TC._quantize_batch_rgb(torch.from_numpy(noise).to(dev), quality=100)
    hists = TC._symbol_histograms_batch(*q).cpu().numpy()
    _, ytabs, ctabs = TC._optimal_tables(hists)
    cases = []
    for ri in (0, 1, 8, 17, 20):
        wc, bc = TC._emit_local(*q, ri)
        cases.append((f"real ri={ri}", wc, bc, ri, None, None))
        if ri in (0, 8):
            cases += [(f"real ri={ri}, tiles of {t}", wc, bc, ri, None, t)
                      for t in (1, 5, 7)]
    cases.append(("gray", *TC._emit_local(*qg), 0, None, None))
    _, wc, bc = TC._encode_batch_custom(*q, ytabs, ctabs, restart_interval=2)
    cases.append(("per-image tables", wc, bc, 2, None, None))
    for ri in (0, 4):
        wc, bc = TC._emit_local(*qn, ri)
        cases += [(f"noise ri={ri}", wc, bc, ri, None, None),
                  (f"noise ri={ri}, maxw 700", wc, bc, ri, 700, None),
                  (f"noise ri={ri}, maxw 700, tiles of 3", wc, bc, ri, 700,
                   3)]
    wc, bc = TE.stream_blocks(3, 40, seed=5)
    cases.append(("word 63", tuple(w.to(dev) for w in wc),
                  tuple(b.to(dev) for b in bc), 3, None, None))
    for ri in (0, 1):
        wc, bc = TE.stream_blocks(4, 1, seed=6 + ri)
        cases.append((f"one MCU ri={ri}", tuple(w.to(dev) for w in wc),
                      tuple(b.to(dev) for b in bc), ri, 64, None))
    rng = np.random.default_rng(182)
    for ri in (0, 3):
        words, bits = [], []
        for per_mcu in (4, 1, 1):
            b = rng.integers(0, 5, (2, per_mcu * 30))
            b.reshape(2, 30, per_mcu)[:, ::7] = 0
            w = np.zeros((*b.shape, 64), np.int64)
            w[..., 0] = (rng.integers(0, 16, b.shape) << 28) & (
                (0xFFFFFFFF << (32 - b)) & 0xFFFFFFFF)
            words.append(torch.from_numpy(w).to(dev))
            bits.append(torch.from_numpy(b.astype(np.int32)).to(dev))
        cases.append((f"2-4-bit blocks ri={ri}, tiles of 1", tuple(words),
                      tuple(bits), ri, 64, 1))
    return cases


def _concat_in_tiles(wc, bc, ri, maxw, tile):
    """The concat kernel launched with tiles of `tile` MCUs (the wrapper
    takes tile_layout's), so that a word spans several tiles."""
    from jpezy_tpu_torch.ops import concat_cuda

    N, nm = bc[1].shape
    nseg = -(-nm // ri) if ri else 0
    out = torch.empty((N, 1 + nseg + maxw), dtype=torch.int64,
                      device=bc[1].device)
    rc = concat_cuda.LIB.get().jz_concat_streams(
        *(t.contiguous().data_ptr() for t in wc + bc), out.data_ptr(), N, nm,
        ri, nseg, maxw, tile, -(-nm // tile),
        torch.cuda.current_stream().cuda_stream)
    concat_cuda.LIB.raise_on("concat_streams", rc)
    return out


def test_concat_kernel_matches_plain(cuda):
    """combined of the concat kernel is bit-identical to the plain form's
    in every case (in tile_layout's tiles, one counted call each, and in
    tiles of 1 to 7 MCUs); the dense noise outgrows the shrunk budget
    (words dropped, totals exact)."""
    from jpezy_tpu_torch.ops import concat_cuda

    cases = _concat_cases(cuda)
    before = concat_cuda.launches
    overflowed = 0
    for label, wc, bc, ri, maxw, tile in cases:
        if tile is None:
            got, _, _ = TC._concat_batch_combined_comp(wc, bc, ri, maxw=maxw)
        else:
            got = _concat_in_tiles(wc, bc, ri, maxw or (
                TC.stream_budget_words_batch(6 * bc[1].shape[1])), tile)
        m = got.shape[1] - 1 - (-(-bc[1].shape[1] // ri) if ri else 0)
        want = TE.concat_streams_plain(tuple(w.cpu() for w in wc),
                                       tuple(b.cpu() for b in bc), ri, m)
        torch.cuda.synchronize()
        assert got.dtype == torch.int64, label
        assert torch.equal(got.cpu(), want), label
        overflowed += int((want[:, 0] > 32 * m).sum())
    assert concat_cuda.launches - before == sum(c[5] is None for c in cases)
    assert overflowed > 0


def test_concat_kernel_refuses_shapes(cuda):
    from jpezy_tpu_torch.ops import concat_cuda

    wc, bc = TE.stream_blocks(2, 4, seed=6)
    wc = tuple(w.to(cuda) for w in wc)
    bc = tuple(b.to(cuda) for b in bc)
    for w, b in (((wc[0][:, :15],) + wc[1:], bc),
                 (wc, (bc[0], bc[1], bc[2][:1])),
                 (tuple(w[..., :32] for w in wc), bc)):
        with pytest.raises(ValueError, match="shape"):
            concat_cuda.concat_streams_cuda(w, b, maxw=4096)


def test_fused_kernel_per_image_tables(cuda):
    """One launch with a table set per image (the custom instantiation)
    equals the plain form and each image coded alone with its set, with
    and without restarts; the long-emission tables (74-bit slots) too."""
    from jpezy_tpu_torch.ops import pack_cuda

    q, ytabs, ctabs = _optimize_inputs(cuda)
    for ri in (0, 2):
        before = pack_cuda.encode_launches
        wk, bk = TE.encode_blocks_batch(*q, ri, tables=(ytabs, ctabs))
        assert pack_cuda.encode_launches - before == 1
        wp, bp = TE.encode_blocks_batch_plain(*(c.cpu() for c in q), ri,
                                              tables=(ytabs, ctabs))
        torch.cuda.synchronize()
        for a, b in zip(wk + bk, wp + bp):
            assert torch.equal(a.cpu(), b), ri
        for i in range(q[0].shape[0]):
            one = tuple(tuple(t[i] for t in tabs) for tabs in (ytabs, ctabs))
            wi, bi = TE.encode_blocks_batch(*(c[i:i + 1] for c in q), ri,
                                            tables=one)
            for a, b in zip(wi + bi, wk + bk):
                assert torch.equal(a, b[i:i + 1]), (ri, i)
    _, _, *flat_tabs = TE.long_emission_tables()
    longq = torch.from_numpy(TE.long_emission_blocks()).to(cuda)
    comps = (longq[None], longq[None, :2], longq[None, 2:4])
    wk, bk = TE.encode_blocks_batch(*comps, tables=(flat_tabs, flat_tabs))
    wp, bp = TE.encode_blocks_batch_plain(*(c.cpu() for c in comps),
                                          tables=(flat_tabs, flat_tabs))
    for a, b in zip(wk + bk, wp + bp):
        assert torch.equal(a.cpu(), b)
    _, _, nbits = TE.block_emissions(longq.cpu(),
                                     TE.dc_predictors(longq[:, 0].cpu()),
                                     False, flat_tabs)
    assert int(nbits.max()) == 74


def test_optimize_and_rgb_on_card_match_cpu(cuda):
    """optimize and the rgb transports in exact mode: the card's streams
    and pixels equal the CPU's; optimize launches the histogram kernel,
    the fused kernel and the concat once each."""
    from imagegen import make_test_image

    from jpezy_tpu_torch.ops import concat_cuda, pack_cuda

    rgbs = np.stack([make_test_image(64, 64, seed=180 + i) for i in range(2)])
    before = (pack_cuda.histogram_launches, pack_cuda.encode_launches,
              concat_cuda.launches)
    opt = TC.encode_batch(rgbs, precision="exact", optimize=True,
                          restart_interval=2, device=cuda)
    assert (pack_cuda.histogram_launches - before[0],
            pack_cuda.encode_launches - before[1],
            concat_cuda.launches - before[2]) == (1, 1, 1)
    assert opt == TC.encode_batch(rgbs, precision="exact", optimize=True,
                                  restart_interval=2, device="cpu")
    rgb = TC.encode_batch(rgbs, precision="exact", transport="rgb",
                          device=cuda)
    assert rgb == TC.encode_batch(rgbs, precision="exact", device="cpu")
    for kw in (dict(precision="exact"), dict(precision="exact", gray=True)):
        a, _ = TC.decode_batch(opt, device=cuda, **kw)
        b, _ = TC.decode_batch(opt, device="cpu", **kw)
        assert np.array_equal(a, b)
    a, _ = TC.decode_batch(opt, transport="rgb", device=cuda)
    b, _ = TC.decode_batch(opt, transport="rgb", device="cpu")
    # float32 IDCT and colour differ in summation order from the CPU's
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 2


@pytest.mark.parametrize("kw", [{}, {"restart_interval": 2},
                                {"optimize": True, "restart_interval": 2}],
                         ids=["plain", "restart", "optimize"])
def test_sharded_on_card_matches_cpu(cuda, kw):
    """encode_sharded / decode_sharded on a 1x1 mesh on the card: exact
    streams equal the CPU mesh's, the kernels launch per shard (1 fused,
    1 concat, 1 histogram with optimize, 1 scan for restart streams), and
    the device decode's pixels equal the card's rgb transport's."""
    from imagegen import make_test_image

    from jpezy_tpu_torch.ops import concat_cuda, pack_cuda, scan_cuda
    from jpezy_tpu_torch.parallel import (decode_sharded, encode_sharded,
                                          make_mesh)

    rgbs = np.stack([make_test_image(64, 64, seed=190 + i) for i in range(2)])
    card, cpu = make_mesh(1, 1, device=cuda), make_mesh(1, 1, device="cpu")
    def counts():
        return (pack_cuda.encode_launches, concat_cuda.launches,
                pack_cuda.histogram_launches, scan_cuda.launches)

    before = counts()
    streams = encode_sharded(card, rgbs, precision="exact", **kw)
    px = decode_sharded(card, streams)
    assert tuple(a - b for a, b in zip(counts(), before)) == (
        1, 1, 1 if kw.get("optimize") else 0, 1 if kw else 0)
    assert streams == encode_sharded(cpu, rgbs, precision="exact", **kw)
    want, _ = TC.decode_batch(streams, transport="rgb", device=cuda)
    assert np.array_equal(px, want)


def _transform_images(h, w, seed, n=2):
    from imagegen import make_test_image

    return np.stack([make_test_image(h, w, seed=seed + i) for i in range(n)])


def _fdct_cases(dev):
    """(label, (y, cb, cr) on dev, kwargs of fdct_quantize) of the fDCT
    kernel: the ycc420 upload's int8 views (Annex K, quality 95, rounded,
    gray), noise, and the rgb path's int32 planes with strided chroma."""
    from jpezy_tpu_torch.core import tables as T
    from jpezy_tpu_torch.ops import blocks as B
    from jpezy_tpu_torch.ops import colorspace as C

    def upload(rgbs):
        y, cb, cr = HG.host_rgb_to_ycc420(rgbs)
        n, h, w = y.shape
        packed = torch.from_numpy(np.concatenate(
            [y.reshape(n, -1), cb.reshape(n, -1), cr.reshape(n, -1)],
            axis=1)).to(dev)
        return TC._unpack_ycc(packed, h, w)

    real = upload(_transform_images(128, 96, 400))
    noise = upload(np.random.default_rng(401).integers(
        0, 256, (2, 64, 48, 3), dtype=np.uint8))
    rgb = torch.from_numpy(_transform_images(64, 80, 402)).to(dev)
    y, cb, cr = C.rgb_to_ycc(rgb[..., 0], rgb[..., 1], rgb[..., 2])
    strided = (y, B.decimate_420(cb), B.decimate_420(cr))
    q95 = tuple(torch.from_numpy(t).to(dev) for t in
                T.scale_quant_tables(95))
    plain = dict(gray=False, rounded=False)
    return [("annexk", real, plain), ("q95", real, dict(plain, qtables=q95)),
            ("rounded", real, dict(plain, rounded=True)),
            ("gray", real, dict(plain, gray=True)),
            ("noise", noise, plain), ("rgb int32 strided", strided, plain)]


def test_fdct_kernel_matches_model(cuda):
    """The fDCT kernel is bit-identical to block_transform's numpy model
    (the same separable float32 sums) and within 1 of the plain version
    (cuBLAS sums the 64-term form), differing on at most 2e-3 of the
    coefficients; one launch a call, no copy of the strided planes."""
    from jpezy_tpu_torch.ops import block_transform as BT
    from jpezy_tpu_torch.ops import transform_cuda

    for label, planes, kw in _fdct_cases(cuda):
        before = transform_cuda.fdct_launches
        got = BT.fdct_quantize(*planes, **kw)
        assert transform_cuda.fdct_launches - before == 1, label
        plain = BT.fdct_quantize_plain(*planes, **kw)
        qt = kw.get("qtables")
        model = BT.fdct_quantize_model(
            *(p.cpu().numpy() for p in planes), gray=kw["gray"],
            rounded=kw["rounded"],
            qtables=None if qt is None else tuple(t.cpu().numpy()
                                                  for t in qt))
        torch.cuda.synchronize()
        n_diff = n_all = 0
        for g, p, m in zip(got, plain, model):
            assert g.dtype == torch.int32 and g.shape == p.shape, label
            assert np.array_equal(g.cpu().numpy(), m), label
            assert (g - p).abs().max() <= 1, label
            n_diff += int((g != p).sum())
            n_all += g.numel()
        assert n_diff <= 2e-3 * n_all, label


def _sparse_case(streams):
    flat, kw, *_ = TC._decode_host_prep(streams, gray=False,
                                        precision="fast", transport=None)
    return flat, kw


def test_idct_sparse_kernel_matches_model(cuda):
    """The sparse form of the IDCT kernel on the ycc420 upload: real
    images at quality 75 and 95, noise at quality 100 (every block an
    overflow row, the tails padded with the sentinel), 16x16, 48x16 (Cr
    fields off a word boundary) and 48x32 batches at quality 95 (overflow
    rows too), and at levels 128 and 2048 the overflow sets of
    testing/ycc_uploads (the float32 tie set, the mixed warp groups, blocks
    that clamp at both ends, noise, sampling factors 1 to 4 with fields at
    odd byte offsets, caps that are not a multiple of 8 and sentinel or
    junk padding): bit-identical to the model, within 1 of the plain
    version (which takes no index below 0, so not on the junk padding),
    one counted call each."""
    from jpezy_tpu_torch.ops import block_transform as BT
    from jpezy_tpu_torch.ops import transform_cuda
    from jpezy_tpu_torch.testing import ycc_uploads as YU
    from test_torch_host_copies import build_host_runtime

    build_host_runtime()       # YU.sparse_upload's native.sparsify8
    noise = np.random.default_rng(410).integers(0, 256, (3, 64, 64, 3),
                                                dtype=np.uint8)
    cases = {"real": TC.encode_batch(_transform_images(128, 96, 411),
                                     device="cpu"),
             "real q95": TC.encode_batch(_transform_images(128, 96, 411),
                                         quality=95, device="cpu"),
             "noise q100": TC.encode_batch(noise, quality=100, device="cpu")}
    for h, w in ((16, 16), (16, 48), (32, 48)):
        cases[f"{w}x{h}"] = TC.encode_batch(
            _transform_images(h, w, 412, n=3), quality=95, device="cpu")
    uploads = {label: _sparse_case(streams)
               for label, streams in cases.items()}
    assert all(uploads["noise q100"][1]["caps"])
    for level in (128, 2048):
        uploads.update({f"{label}, level {level}": up for label, up in
                        YU.overflow_sets(level).items()})
    for label, (flat, kw) in uploads.items():
        before = transform_cuda.idct_launches
        got = BT.idct_planes_sparse(torch.from_numpy(flat).to(cuda), **kw)
        assert transform_cuda.idct_launches - before == 1, label
        model = BT.idct_planes_sparse_model(flat, **kw)
        torch.cuda.synchronize()
        assert np.array_equal(got.cpu().numpy(), model), label
        if label.startswith("junk padding"):
            continue
        plain = BT.idct_planes_sparse_plain(torch.from_numpy(flat).to(cuda),
                                            **kw)
        assert (got.to(torch.int32) - plain.to(torch.int32)).abs().max() \
            <= 1, label


def test_idct_sparse_kernel_4k_wide(cuda):
    """The sparse form on one 3840x2160 image: each of its 135 MCU rows
    of 240 MCUs spans 60 warp units of 4 MCUs (16 luma blocks) and 15 of
    16 MCUs (16 blocks of each chroma component), so the bounded unit size
    is exercised at a 4K width (the short units are the 48-wide cases' of
    test_idct_sparse_kernel_matches_model); bit-identical to the model,
    within 1 of the plain version."""
    from jpezy_tpu_torch.ops import block_transform as BT

    img = _transform_images(2160, 3840, 415, n=1)
    flat, kw = _sparse_case(TC.encode_batch(img, device=cuda))
    assert kw["N"] == 1 and kw["shapes"][0] == 4 * 135 * 240
    got = BT.idct_planes_sparse(torch.from_numpy(flat).to(cuda), **kw)
    plain = BT.idct_planes_sparse_plain(torch.from_numpy(flat).to(cuda),
                                        **kw)
    model = BT.idct_planes_sparse_model(flat, **kw)
    torch.cuda.synchronize()
    assert np.array_equal(got.cpu().numpy(), model)
    assert (got.to(torch.int32) - plain.to(torch.int32)).abs().max() <= 1


def test_idct_dense_kernel_matches_model_and_sparse(cuda):
    """The dense form on the scan's blocks of restart segments and of the
    indexed transport's pseudo-segments: bit-identical to the model, its
    planes identical to the sparse form's on the same streams, and each
    image's flag byte set where one of its segments is corrupt."""
    from jpezy_tpu_torch.ops import block_transform as BT
    from jpezy_tpu_torch.ops import transform_cuda

    rgbs = _transform_images(64, 96, 420, n=3)
    for label, streams in (
            ("restart", TC.encode_batch(rgbs, restart_interval=5,
                                        device="cpu")),
            ("indexed", TC.encode_batch(rgbs, device="cpu"))):
        pjs, geom, level = TC._parse_batch(streams)
        nmcu = geom[0][0] * geom[0][1]
        if label == "restart":
            ri = 5
            nseg = -(-nmcu // ri)
            words, nblk, rawlen = HG._device_host_frontend(pjs, nmcu, ri,
                                                           nseg)
            opt = dict(rawlen=rawlen)
        else:
            ri = 8
            nseg = -(-nmcu // ri)
            words, nblk, skip0, preds0 = HG._indexed_host_frontend(
                pjs, nmcu, ri, nseg)
            opt = dict(skip0=skip0, preds0=preds0)
        lut, tsel = HG._device_luts(pjs, nseg)
        args = {k: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(
            cuda) for k, v in dict(opt, nblk=nblk, tsel=tsel).items()}
        blocks, bad = ED.decode_segments(
            ED.words_tensor(words).to(cuda), lut=ED.device_lut(lut, cuda),
            max_blocks=ri * 6, **args)
        bad = bad.clone()
        bad[nseg + 1] = True                     # image 1 flagged
        qarr = torch.from_numpy(HG._quant_arr(pjs)).to(cuda)
        kw = dict(N=3, nseg=nseg, ri=ri, geom=geom, level=level)
        before = transform_cuda.idct_launches
        got = BT.idct_planes_dense(blocks, bad, qarr, **kw)
        assert transform_cuda.idct_launches - before == 1, label
        model = BT.idct_planes_dense_model(blocks.cpu().numpy(),
                                           bad.cpu().numpy(),
                                           qarr.cpu().numpy(), **kw)
        torch.cuda.synchronize()
        got = got.cpu().numpy()
        assert np.array_equal(got, model), label
        assert got[:, -1].tolist() == [0, 1, 0], label
        flat, skw = _sparse_case(streams)
        sparse = BT.idct_planes_sparse(torch.from_numpy(flat).to(cuda), **skw)
        assert np.array_equal(sparse.cpu().numpy(), got[:, :-1]), label


def test_transform_kernels_on_the_codec_paths(cuda):
    """Per batch: a fast encode launches the fDCT kernel once (ycc420, rgb
    and optimize alike), an exact one never; the ycc420, device and
    indexed decodes launch the IDCT kernel once, the rgb decode never."""
    from jpezy_tpu_torch.ops import transform_cuda

    rgbs = _transform_images(64, 64, 430)

    def counts():
        return transform_cuda.fdct_launches, transform_cuda.idct_launches

    for kw, want in (({}, (1, 0)), ({"transport": "rgb"}, (1, 0)),
                     ({"optimize": True, "restart_interval": 2}, (1, 0)),
                     ({"precision": "exact"}, (0, 0))):
        before = counts()
        TC.encode_batch(rgbs, device=cuda, **kw)
        assert tuple(a - b for a, b in zip(counts(), before)) == want, kw
    plain = TC.encode_batch(rgbs, device="cpu")
    restart = TC.encode_batch(rgbs, restart_interval=2, device="cpu")
    for streams, kw, want in ((plain, {"transport": "ycc420"}, (0, 1)),
                              (restart, {"transport": "device"}, (0, 1)),
                              (plain, {"transport": "indexed"}, (0, 1)),
                              (plain, {"transport": "rgb"}, (0, 0))):
        before = counts()
        TC.decode_batch(streams, device=cuda, **kw)
        assert tuple(a - b for a, b in zip(counts(), before)) == want, kw


def _exact_counts():
    from jpezy_tpu_torch.ops import exact_cuda, transform_cuda

    return (exact_cuda.fdct_exact_launches, exact_cuda.idct_exact_launches,
            transform_cuda.fdct_launches, transform_cuda.idct_launches)


def _rgb_upload(streams):
    """The rgb transport's coefficient upload of `streams` (host frontend)
    and its kwargs."""
    pjs, geom, level = TC._parse_batch(streams, precision="exact")
    return TC._rgb_host_prep(pjs, geom, level, gray=False,
                             precision="exact")


def test_exact_fdct_kernel_matches_plain(cuda):
    """fdct_quantize_exact on the card equals the plain float64 ordered
    sums on the card bit for bit: the tie set (int8 and int32 planes,
    quantizer 1 and Annex K), two 512x512 images' ycc420 upload at Annex
    K, quality 95, rounded and gray, their rgb path's int32 planes with
    strided chroma, and noise at quality 100; one launch a call, the fast
    kernel never."""
    from jpezy_tpu_torch.core import tables as T
    from jpezy_tpu_torch.ops import block_transform as BT
    from jpezy_tpu_torch.ops import blocks as B
    from jpezy_tpu_torch.ops import colorspace as C

    ties = XT.forward_tie_blocks(2048, 440)
    ones = torch.ones(64, dtype=torch.int32, device=cuda)
    plain = dict(gray=False, rounded=False)
    cases = [(f"ties {dt.__name__}{' q1' if q else ''}",
              tuple(torch.from_numpy(p.astype(dt)).to(cuda)
                    for p in XT.tie_planes(ties)),
              dict(plain, qtables=(ones, ones)) if q else plain)
             for dt in (np.int8, np.int32) for q in (True, False)]
    cases += [(label, planes, kw) for label, planes, kw in _fdct_cases(cuda)]
    imgs = _transform_images(512, 512, 441)
    y, cb, cr = HG.host_rgb_to_ycc420(imgs)
    up = tuple(torch.from_numpy(a).to(cuda) for a in (y, cb, cr))
    q95 = tuple(torch.from_numpy(t).to(cuda) for t in
                T.scale_quant_tables(95))
    q100 = tuple(torch.from_numpy(t).to(cuda) for t in
                 T.scale_quant_tables(100))
    rgb = torch.from_numpy(imgs).to(cuda)
    ry, rcb, rcr = C.rgb_to_ycc(rgb[..., 0], rgb[..., 1], rgb[..., 2],
                                torch.float64)
    noise = np.random.default_rng(442).integers(0, 256, (2, 512, 512, 3),
                                                dtype=np.uint8)
    cases += [("512 annexk", up, plain), ("512 q95", up,
                                           dict(plain, qtables=q95)),
              ("512 rounded", up, dict(plain, rounded=True)),
              ("512 gray", up, dict(plain, gray=True)),
              ("512 rgb int32 strided",
               (ry, B.decimate_420(rcb), B.decimate_420(rcr)), plain),
              ("noise q100", tuple(torch.from_numpy(a).to(cuda) for a in
                                   HG.host_rgb_to_ycc420(noise)),
               dict(plain, qtables=q100))]
    for label, planes, kw in cases:
        before = _exact_counts()
        got = BT.fdct_quantize_exact(*planes, **kw)
        after = _exact_counts()
        assert (after[0] - before[0], after[2] - before[2]) == (1, 0), label
        want = BT.fdct_quantize_plain(*planes, dtype=torch.float64, **kw)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and torch.equal(g, w), label


def test_exact_idct_kernel_matches_plain(cuda):
    """idct_planes_exact on the card equals the plain float64 ordered sums
    on the card bit for bit: the tie set at level 128 and 2048 (one
    component, quantizer 1), and two 512x512 images' rgb upload read as
    4:2:0, 4:2:2, 4:4:4, one component and gray, at level 128 and 2048,
    int16 and int32; one launch a call, the fast kernel never."""
    from jpezy_tpu_torch.ops import block_transform as BT

    cases = []
    for level in (128, 2048):
        ties = XT.inverse_tie_blocks(4096, 443, level)
        n = len(ties)
        cases.append((f"ties level {level}",
                      torch.from_numpy(ties[None]).to(cuda),
                      dict(geom=((1, n, 1, 1, 1, 1),), sizes=(n,),
                           gray=False, level=level,
                           qtuple=(tuple([1] * 64),))))
    streams = TC.encode_batch(_transform_images(512, 512, 444),
                              quality=90, device="cpu")
    coeff, kw = _rgb_upload(streams)
    coeff = torch.from_numpy(coeff).to(cuda)
    assert coeff.dtype == torch.int16
    my, mx = kw["geom"][0][:2]
    for label, (geom, sizes, gray) in XT.upload_layouts(my, mx).items():
        for level in (128, 2048):
            for dt in (torch.int16, torch.int32):
                cases.append((f"{label} level {level} {dt}", coeff.to(dt),
                              dict(geom=geom, sizes=sizes, gray=gray,
                                   level=level,
                                   qtuple=kw["qtuple"][:len(sizes)])))
    for label, src, kw in cases:
        before = _exact_counts()
        got = BT.idct_planes_exact(src, **kw)
        after = _exact_counts()
        assert (after[1] - before[1], after[3] - before[3]) == (1, 0), label
        want = BT.idct_planes_exact_plain(src, **kw)
        torch.cuda.synchronize()
        assert len(got) == len(want) == (1 if kw["gray"] else
                                         len(kw["sizes"])), label
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and torch.equal(g, w), label


def test_exact_kernels_4k(cuda):
    """One 3840x2160 image: its exact encode on the card is host_codec's
    stream (one exact fDCT launch) and its exact decode host_codec's pixels
    (one exact IDCT launch)."""
    from jpezy_tpu_torch.codec import host_codec

    img = _transform_images(2160, 3840, 445, n=1)
    before = _exact_counts()
    stream = TC.encode_batch(img, precision="exact", device=cuda)
    px, _ = TC.decode_batch(stream, precision="exact", device=cuda)
    after = _exact_counts()
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 0, 0)
    assert stream == [host_codec.encode(img[0, ..., 0], img[0, ..., 1],
                                        img[0, ..., 2])]
    assert np.array_equal(px[0], np.stack(host_codec.decode(stream[0])[:3],
                                          -1))


@pytest.mark.parametrize("kw", [{}, {"transport": "rgb"}, {"quality": 95},
                                {"optimize": True, "restart_interval": 2}],
                         ids=["ycc420", "rgb", "q95", "optimize"])
def test_exact_codec_on_card(cuda, kw):
    """encode_batch(precision="exact") and decode_batch(precision="exact"),
    colour and gray, on the card: streams equal the CPU's and host_codec's,
    pixels host_codec.decode's; per call one exact fDCT launch and no fast
    one, one exact IDCT launch and no fast one."""
    from jpezy_tpu_torch.codec import host_codec

    rgbs = _transform_images(96, 128, 446)
    before = _exact_counts()
    streams = TC.encode_batch(rgbs, precision="exact", device=cuda, **kw)
    after = _exact_counts()
    assert tuple(a - b for a, b in zip(after, before)) == (1, 0, 0, 0)
    assert streams == TC.encode_batch(rgbs, precision="exact", device="cpu",
                                      **kw)
    host_kw = {k: v for k, v in kw.items() if k != "transport"}
    assert streams == [host_codec.encode(im[..., 0], im[..., 1], im[..., 2],
                                         **host_kw) for im in rgbs]
    for gray in (False, True):
        before = _exact_counts()
        px, _ = TC.decode_batch(streams, precision="exact", gray=gray,
                                device=cuda)
        after = _exact_counts()
        assert tuple(a - b for a, b in zip(after, before)) == (0, 1, 0, 0)
        cpu, _ = TC.decode_batch(streams, precision="exact", gray=gray,
                                 device="cpu")
        assert np.array_equal(px, cpu), gray
        want = np.stack([np.stack(host_codec.decode(s, gray=gray)[:3], -1)
                         for s in streams])
        assert np.array_equal(px, want), gray


# ---------------------------------------------------------------------------
# The rgb transport's colour kernels (csrc/colour.cu) and its fast IDCT
# (exact_transforms.cu: idct_planes_rgb_kernel)
# ---------------------------------------------------------------------------


def _colour_counts():
    from jpezy_tpu_torch.ops import colour_cuda, exact_cuda

    return (colour_cuda.rgb_to_ycc420_launches,
            colour_cuda.ycc_planes_to_rgb_launches,
            exact_cuda.idct_rgb_launches)


def test_colour_encode_kernel_matches_plain(cuda):
    """rgb_to_ycc420 on the card equals the plain torch version on the card
    bit for bit at float32 and float64, and at float64 the host C++
    rgb_to_ycc420: two 512x512 test images, noise, every 256th RGB triple
    in its own 2x2 quad, and an upload whose first byte is not aligned;
    one launch a call."""
    from jpezy_tpu_torch.ops import colorspace as C
    from jpezy_tpu_torch.runtime import native

    from test_torch_host_copies import build_host_runtime

    build_host_runtime()
    noise = np.random.default_rng(450).integers(0, 256, (3, 64, 96, 3),
                                                dtype=np.uint8)
    buf = torch.from_numpy(np.concatenate([[7], noise.ravel()]).astype(
        np.uint8)).to(cuda)
    cases = [("512 test images",
              torch.from_numpy(_transform_images(512, 512, 451)).to(cuda)),
             ("noise", torch.from_numpy(noise).to(cuda)),
             ("triples", CS.triple_quads(cuda, stride=256)),
             ("misaligned", buf[1:].reshape(noise.shape))]
    assert cases[3][1].data_ptr() % 2 == 1
    for label, rgb in cases:
        for dt in (torch.float32, torch.float64):
            before = _colour_counts()
            got = C.rgb_to_ycc420(rgb, dt)
            assert tuple(a - b for a, b in zip(_colour_counts(), before)) \
                == (1, 0, 0), label
            want = C.rgb_to_ycc420_plain(rgb, dt)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert g.dtype == torch.int8 and torch.equal(g, w), (label,
                                                                     dt)
            if dt == torch.float64:
                host = native.rgb_to_ycc420(rgb.cpu().numpy())
                for g, h in zip(got, host):
                    assert np.array_equal(g.cpu().numpy(), h), label


@pytest.mark.parametrize("label", list(CS.SAMPLINGS))
def test_colour_decode_kernel_matches_plain(cuda, label):
    """planes_to_rgb on the card equals the plain torch version on the card
    bit for bit at float32 and float64 on planes past both clamps, and at
    float64 the host C++ ycc_to_rgb_i32 of the upsampled planes; one
    launch a call."""
    from jpezy_tpu_torch.ops import blocks as B
    from jpezy_tpu_torch.ops import colorspace as C
    from jpezy_tpu_torch.runtime import native

    from test_torch_host_copies import build_host_runtime

    build_host_runtime()
    dups, gray = CS.SAMPLINGS[label]
    planes = CS.sampling_planes(dups, 3, 96, 240, seed=452, device=cuda)
    used = planes[:1] if gray else planes
    geom = CS.geom_of(dups)
    for dt in (torch.float32, torch.float64):
        before = _colour_counts()
        got = C.planes_to_rgb(used, geom, gray, dt)
        assert tuple(a - b for a, b in zip(_colour_counts(), before)) == (
            0, 1, 0)
        want = C.planes_to_rgb_plain(used, geom, gray, dt)
        torch.cuda.synchronize()
        assert got.shape == (3, 96, 240, 1 if gray else 3)
        assert torch.equal(got, want), dt
        if dt == torch.float64 and not gray:
            up = [B.upsample_nearest(p, dy, dx).cpu().numpy()
                  for p, (dy, dx) in zip(used, dups)]
            host = np.stack([native.ycc_to_rgb_i32(*(u[i] for u in up))
                             for i in range(3)])
            assert np.array_equal(got.cpu().numpy(), host)


def test_colour_decode_kernel_every_ycc_triple(cuda):
    """Every (Y, Cb, Cr) triple of 0..255 at 4:4:4: the kernel equals the
    plain version at both precisions and the host C++ at float64."""
    from jpezy_tpu_torch.ops import colorspace as C
    from jpezy_tpu_torch.runtime import native

    from test_torch_host_copies import build_host_runtime

    build_host_runtime()
    planes = CS.ycc_triple_planes(cuda)
    geom = CS.geom_of(CS.SAMPLINGS["4:4:4"][0])
    for dt in (torch.float32, torch.float64):
        got = C.planes_to_rgb(planes, geom, False, dt)
        assert torch.equal(got, C.planes_to_rgb_plain(planes, geom, False,
                                                      dt)), dt
    host = native.ycc_to_rgb_i32(*(p[0].cpu().numpy() for p in planes))
    assert np.array_equal(got[0].cpu().numpy(), host)


def test_idct_rgb_kernel_matches_model(cuda):
    """idct_planes_rgb (fast) on the card equals idct_planes_rgb_model bit
    for bit and the plain matrix product within 1: two 512x512 images' rgb
    upload read as 4:2:0, 4:2:2, 4:4:4, one component and gray, at level
    128 and 2048, int16 and int32, noise at quality 100, and as one
    component at quantizer 1 the float32 tie set (rgb_ties) and the
    kernel's mixed warp groups at both levels; one launch a call,
    idct_planes_exact never."""
    from jpezy_tpu_torch.ops import block_transform as BT

    cases = []
    for label, imgs, quality in (
            ("images", _transform_images(512, 512, 453), 90),
            ("noise q100", np.random.default_rng(454).integers(
                0, 256, (2, 128, 128, 3), dtype=np.uint8), 100)):
        streams = TC.encode_batch(imgs, quality=quality, device="cpu")
        coeff, kw = _rgb_upload(streams)
        coeff = torch.from_numpy(coeff).to(cuda)
        my, mx = kw["geom"][0][:2]
        for lay, (geom, sizes, gray) in XT.upload_layouts(my, mx).items():
            for level in (128, 2048):
                for dt in (torch.int16, torch.int32):
                    cases.append((f"{label} {lay} level {level} {dt}",
                                  coeff.to(dt),
                                  dict(geom=geom, sizes=sizes, gray=gray,
                                       level=level,
                                       qtuple=kw["qtuple"][:len(sizes)])))
    for level in (128, 2048):
        for label, blocks in (
                ("float32 ties", RT.inverse_tie_blocks(8192, 455, level)),
                ("mixed groups", RT.mixed_coefficient_groups(512, 456,
                                                             level))):
            n = len(blocks)
            cases.append((f"{label} level {level}", torch.from_numpy(
                blocks[None].astype(np.int32)).to(cuda), dict(
                    geom=((1, n, 1, 1, 1, 1),), sizes=(n,), gray=False,
                    level=level, qtuple=(tuple([1] * 64),))))
    for label, src, kw in cases:
        before = _colour_counts() + _exact_counts()
        got = BT.idct_planes_rgb(src, precision="fast", **kw)
        after = _colour_counts() + _exact_counts()
        assert tuple(a - b for a, b in zip(after, before)) == (
            0, 0, 1, 0, 0, 0, 0), label
        plain = BT.idct_planes_rgb_plain(src, dtype=torch.float32, **kw)
        model = BT.idct_planes_rgb_model(src.cpu().numpy(), **kw)
        torch.cuda.synchronize()
        assert len(got) == len(model) == len(plain), label
        for g, m, p in zip(got, model, plain):
            assert g.dtype == torch.int32, label
            assert np.array_equal(g.cpu().numpy(), m), label
            # cuBLAS sums in another order: within 1 (ties)
            assert int((g - p).abs().max()) <= 1, label


@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_rgb_transport_launches(cuda, precision):
    """encode_batch(transport="rgb") on the card launches the colour
    kernel, the fDCT of its precision, the entropy kernel and the concat
    once each; decode_batch(transport="rgb"), colour and gray, the IDCT of
    its precision and the colour kernel once each.  Exact streams and
    pixels equal the CPU's."""
    from jpezy_tpu_torch.ops import concat_cuda, pack_cuda

    def counts():
        return _colour_counts() + _exact_counts() + (
            pack_cuda.encode_launches, concat_cuda.launches,
            pack_cuda.histogram_launches)

    exact = precision == "exact"
    rgbs = _transform_images(96, 128, 455)
    before = counts()
    streams = TC.encode_batch(rgbs, transport="rgb", precision=precision,
                              device=cuda)
    got = tuple(a - b for a, b in zip(counts(), before))
    # colour enc/dec, idct rgb, fdct/idct exact, fdct/idct fast, entropy,
    # concat, histograms
    assert got == (1, 0, 0, int(exact), 0, int(not exact), 0, 1, 1, 0)
    if exact:
        assert streams == TC.encode_batch(rgbs, transport="rgb",
                                          precision="exact", device="cpu")
    for gray in (False, True):
        before = counts()
        px, _ = TC.decode_batch(streams, transport="rgb", gray=gray,
                                precision=precision, device=cuda)
        got = tuple(a - b for a, b in zip(counts(), before))
        assert got == (0, 1, int(not exact), 0, int(exact), 0, 0, 0, 0, 0)
        cpu, _ = TC.decode_batch(streams, transport="rgb", gray=gray,
                                 precision=precision, device="cpu")
        diff = int(np.abs(px.astype(int) - cpu.astype(int)).max())
        # exact: float64 ordered sums on both; fast: the kernel's ascending
        # sums against the CPU's BLAS order, which may truncate 1 apart,
        # and colour then moves a pixel by up to 2
        assert diff <= (0 if exact else 2), gray


@pytest.mark.parametrize("restart", [0, 2])
def test_sharded_fast_decode_equals_rgb_decode(cuda, restart):
    """Fast decode_sharded's pixels, its tile shards decoded rank by rank
    in this process on 1x1, 1x2 and 1x4 meshes, equal decode_batch(
    transport="rgb")'s exactly on the card: the IDCT kernel's per-block
    sums do not depend on how many rows a shard holds."""
    from jpezy_tpu_torch.parallel import api as A
    from jpezy_tpu_torch.parallel.mesh import Mesh

    rgbs = _transform_images(128, 96, 456, n=2)
    streams = TC.encode_batch(rgbs, restart_interval=restart, device=cuda)
    want, _ = TC.decode_batch(streams, transport="rgb", device=cuda)
    for tile in (1, 2, 4):
        pjs, geom, level = A._parse_checked(streams, tile, gray=False,
                                            precision="fast")
        shards = [A._decode_shard(Mesh(1, tile, cuda, t), pjs, geom, level,
                                  gray=False, precision="fast")
                  for t in range(tile)]
        px = np.concatenate([rgb.cpu().numpy() for rgb, _ in shards],
                            axis=1)[:, :128, :96]
        assert np.array_equal(px, want), tile
