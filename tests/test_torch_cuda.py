"""CUDA-only checks of jpezy_tpu_torch: the hand-written entropy kernels
(the pack alone, the fused emissions + pack, and the Huffman scan of the
device decode) against their plain torch versions, and the codec on the
card against the codec on the CPU.  Marked
`cuda`; each test skips when no CUDA device is present (decided inside the
fixture, never at import).  On a card:

    python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from jpezy_tpu_torch.codec import host_glue as HG
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.ops import entropy as TE
from jpezy_tpu_torch.ops import entropy_decode as ED

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
    from jpezy_tpu_torch.ops import pack_cuda

    blocks = _blocks(cuda)
    before = (pack_cuda.launches, pack_cuda.encode_launches)
    for q, chroma in blocks:
        pred = TE.dc_predictors(q[:, 0])
        wk, bk = pack_cuda.encode_blocks_cuda(q, pred, chroma)
        wp, bp = TE.encode_block_words_plain(q, pred, chroma)
        torch.cuda.synchronize()
        assert wk.dtype == torch.int64 and torch.equal(wk, wp)
        assert torch.equal(bk, bp)
    assert pack_cuda.encode_launches - before[1] == len(blocks)
    assert pack_cuda.launches == before[0]


def test_fused_kernel_dispatch_predictors_and_tables(cuda):
    """encode_block_words launches the fused kernel for CUDA tensors; the
    kernel takes any predictors (a restart resets them) and explicit
    tables."""
    from jpezy_tpu_torch.ops import pack_cuda

    q = torch.from_numpy(TE.edge_case_blocks(123)).to(cuda)
    pred = TE.dc_predictors(q[:, 0])
    pred[::3] = 0
    before = pack_cuda.encode_launches
    wk, bk = TE.encode_block_words(q, pred, True)
    wt, bt = pack_cuda.encode_blocks_cuda(
        q, pred, pack_cuda.huffman_tables_i32(q.device, True))
    wp, bp = TE.encode_block_words_plain(q, pred, True)
    torch.cuda.synchronize()
    assert pack_cuda.encode_launches - before == 2
    assert torch.equal(wk, wp) and torch.equal(bk, bp)
    assert torch.equal(wt, wp) and torch.equal(bt, bp)
    empty_w, empty_b = pack_cuda.encode_blocks_cuda(q[:0], pred[:0], False)
    assert empty_w.shape == (0, 64) and empty_b.shape == (0,)
    assert pack_cuda.encode_launches - before == 2   # nothing to launch


def test_codec_on_card_matches_cpu(cuda):
    from imagegen import make_test_image

    from jpezy_tpu_torch.ops import pack_cuda

    rgbs = np.stack([make_test_image(64, 64, seed=130 + i) for i in range(2)])
    before = (pack_cuda.launches, pack_cuda.encode_launches)
    exact = TC.encode_batch(rgbs, precision="exact", device=cuda)
    # one fused launch per component; the pack alone is off the codec's path
    assert (pack_cuda.launches, pack_cuda.encode_launches) == (
        before[0], before[1] + 3)
    assert exact == TC.encode_batch(rgbs, precision="exact", device="cpu")
    flat, kw, *_ = TC._decode_host_prep(exact, gray=False, precision="fast",
                                        transport=None)
    on_card = TC._decode_fused_batch_ycc420(
        torch.from_numpy(flat).to(cuda), **kw).cpu()
    on_cpu = TC._decode_fused_batch_ycc420(torch.from_numpy(flat), **kw)
    # float32 IDCT summation order differs between cuBLAS and the CPU
    assert (on_card.to(torch.int32) - on_cpu.to(torch.int32)).abs().max() <= 1


def _scan_cases():
    """(label, kwargs of decode_segments as numpy arrays) for the scan
    kernel: real restart segments, noise, pseudo-segments of the indexed
    transport, a mixed-table batch, and seeded corruptions of the first."""
    from imagegen import make_test_image

    from jpezy_tpu_torch.bitstream.reader import parse
    from jpezy_tpu_torch.codec import host_codec

    rgbs = np.stack([make_test_image(128, 128, seed=140 + i) for i in range(3)])
    rng = np.random.default_rng(141)
    noise = rng.integers(0, 256, (2, 64, 64, 3), np.uint8)
    cases = []

    def restart_case(label, streams, ri):
        pjs = [parse(s) for s in streams]
        nmcu = (pjs[0].props.height // 16) * (pjs[0].props.width // 16)
        nseg = -(-nmcu // ri)
        words, nblk, rawlen = HG._device_host_frontend(pjs, nmcu, ri, nseg)
        lut, tsel = HG._device_luts(pjs, nseg)
        cases.append((label, dict(words=words, nblk=nblk, lut=lut, tsel=tsel,
                                  rawlen=rawlen, max_blocks=ri * 6)))

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
    cases.append(("indexed", dict(words=words, nblk=nblk, lut=lut, tsel=tsel,
                                  skip0=skip0, preds0=preds0, max_blocks=48)))
    real = cases[0][1]
    for seed in range(4):
        cases.append((f"corrupt {seed}", dict(real, words=ED.corrupt_rows(
            real["words"], real["rawlen"], 150 + seed))))
    return cases


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


def test_scan_kernel_matches_plain(cuda):
    from jpezy_tpu_torch.ops import scan_cuda

    cases = _scan_cases()
    before = scan_cuda.launches
    flagged = 0
    for label, kw in cases:
        blocks, bad = ED.decode_segments(**_scan_args(kw, cuda))
        pb, pbad = ED.decode_segments_plain(**_scan_args(kw, "cpu"))
        torch.cuda.synchronize()
        assert blocks.dtype == torch.int16 and bad.dtype == torch.bool
        assert torch.equal(blocks.cpu(), pb), label
        assert torch.equal(bad.cpu(), pbad), label
        if label.startswith("corrupt"):
            flagged += int(pbad.sum())
        else:
            assert not pbad.any(), label
    assert flagged > 0
    assert scan_cuda.launches - before == len(cases)
    kw = _scan_args(cases[0][1], cuda)
    empty, _ = ED.decode_segments(**dict(kw, max_blocks=0))
    assert empty.shape == (kw["words"].shape[0], 0, 64)
    assert scan_cuda.launches - before == len(cases)   # nothing to launch


def test_device_transports_on_card_match_cpu(cuda):
    from imagegen import make_test_image

    from jpezy_tpu_torch.ops import scan_cuda

    rgbs = np.stack([make_test_image(64, 64, seed=160 + i) for i in range(2)])
    restart = TC.encode_batch(rgbs, restart_interval=2, device=cuda)
    assert restart == TC.encode_batch(rgbs, restart_interval=2, device="cpu")
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
