"""CUDA-only checks of jpezy_tpu_torch: the hand-written pack kernel
against its plain torch version, and the codec on the card against the
codec on the CPU.  Marked `cuda`; each test skips when no CUDA device is
present (decided inside the fixture, never at import).  On a card:

    python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from jpezy_tpu_torch.codec import host_glue as HG
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.ops import entropy as TE

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _emissions(dev):
    from imagegen import make_test_image

    rgbs = np.stack([make_test_image(128, 128, seed=120 + i) for i in range(2)])
    y, cb, cr = HG.host_rgb_to_ycc420(rgbs)
    q = TC._quantize_local_ycc(*(torch.from_numpy(a).to(dev) for a in (y, cb, cr)),
                               gray=False, dtype=torch.float32, rounded=False)
    rng = np.random.default_rng(121)
    worst = rng.integers(1, 1024, (512, 64)) * rng.choice([-1, 1], (512, 64))
    worst[:, 0] = rng.integers(-1024, 1017, 512)
    blocks = [qc.reshape(-1, 64) for qc in q]
    blocks.append(torch.from_numpy(worst.astype(np.int32)).to(dev))
    out = []
    for i, b in enumerate(blocks):
        pred = TE.dc_predictors(b[:, 0])
        out.append(TE.block_emissions(b, pred, chroma=i in (1, 2)))
    return out


def test_pack_kernel_matches_plain(cuda):
    from jpezy_tpu_torch.ops import pack_cuda

    ems = _emissions(cuda)
    before = pack_cuda.launches
    for hi, lo, nb in ems:
        wk, bk = TE.pack_block_words(hi, lo, nb)
        wp, bp = TE.pack_block_words_plain(hi, lo, nb)
        torch.cuda.synchronize()
        assert torch.equal(wk, wp)
        assert torch.equal(bk, bp)
    assert pack_cuda.launches - before == len(ems)
    assert int(TE.pack_block_words_plain(*ems[-1])[1].max()) > 32 * 32


def test_codec_on_card_matches_cpu(cuda):
    from imagegen import make_test_image

    rgbs = np.stack([make_test_image(64, 64, seed=130 + i) for i in range(2)])
    exact = TC.encode_batch(rgbs, precision="exact", device=cuda)
    assert exact == TC.encode_batch(rgbs, precision="exact", device="cpu")
    flat, kw, *_ = TC._decode_host_prep(exact, gray=False, precision="fast",
                                        transport=None)
    on_card = TC._decode_fused_batch_ycc420(
        torch.from_numpy(flat).to(cuda), **kw).cpu()
    on_cpu = TC._decode_fused_batch_ycc420(torch.from_numpy(flat), **kw)
    # float32 IDCT summation order differs between cuBLAS and the CPU
    assert (on_card.to(torch.int32) - on_cpu.to(torch.int32)).abs().max() <= 1
