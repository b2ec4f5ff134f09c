"""The PyTorch port's pipeline, its jax-free import, and its host-glue copies.

- roundtrip_batches / encode_batches / decode_batches must give exactly
  what the unpipelined encode_batch + decode_batch give;
- importing jpezy_tpu_torch and running an encode must import neither jax
  nor jpezy_tpu;
- each function copied into jpezy_tpu_torch/codec/host_glue.py must give
  outputs identical to its original in jpezy_tpu.codec.jax_codec.
"""
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

from jpezy_tpu.bitstream.reader import parse
from jpezy_tpu.codec import jax_codec as JC
from jpezy_tpu_torch.codec import host_glue as HG
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.runtime import pipeline as P

from test_torch_host_copies import host_runtime  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


@pytest.fixture(scope="module")
def batches():
    from imagegen import make_test_image

    return [np.stack([make_test_image(64, 64, seed=100 + 2 * i + j)
                      for j in range(2)]) for i in range(3)]


@pytest.fixture(scope="module")
def serial(batches):
    streams = [TC.encode_batch(b, device=CPU) for b in batches]
    pixels = [TC.decode_batch(s, device=CPU)[0] for s in streams]
    return streams, pixels


class TestPipeline:
    def test_roundtrip_equals_serial(self, batches, serial):
        out = list(P.roundtrip_batches(batches, lookahead=1, device=CPU))
        assert len(out) == 3
        for (s, px), s_ref, px_ref in zip(out, *serial):
            assert s == s_ref
            assert np.array_equal(px, px_ref)

    def test_encode_decode_batches_equal_serial(self, batches, serial):
        streams = list(P.encode_batches(batches, lookahead=2, device=CPU))
        assert streams == serial[0]
        pixels = [px for px, _ in P.decode_batches(streams, device=CPU)]
        for px, px_ref in zip(pixels, serial[1]):
            assert np.array_equal(px, px_ref)

    def test_stage_error_propagates(self, batches):
        # the encode stages pass; the third stage refuses the indexed
        # transport for restart streams
        with pytest.raises(ValueError, match="restart-FREE"):
            list(P.roundtrip_batches(batches, restart_interval=2,
                                     transport="indexed", device=CPU))


def test_port_runs_without_jax():
    code = (
        "import sys, numpy as np\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import jpezy_tpu_torch as J\n"
        "rgb = (np.arange(32 * 32 * 3) % 251).astype(np.uint8)"
        ".reshape(1, 32, 32, 3)\n"
        "s = J.encode_batch(rgb, device='cpu')\n"
        "px, _ = J.decode_batch(s, device='cpu')\n"
        "assert s[0][:2] == b'\\xff\\xd8' and px.shape == (1, 32, 32, 3)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'jpezy_tpu'))\n"
        "assert not bad, bad\n"
        "print('NOJAX_OK')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NOJAX_OK" in res.stdout


class TestHostGlueCopies:
    """Copy and original (jax_codec) must agree on the same inputs."""

    @pytest.fixture(scope="class")
    def streams(self, batches):
        return JC.encode_batch(batches[0])

    def test_host_rgb_to_ycc420(self, batches):
        for a, b in zip(HG.host_rgb_to_ycc420(batches[1]),
                        JC.host_rgb_to_ycc420(batches[1])):
            assert np.array_equal(a, b)

    def test_stream_to_bytes(self):
        rng = np.random.default_rng(0)
        words = rng.integers(0, 2**32, 40, dtype=np.uint64).astype(np.uint32)
        for total in (0, 1, 7, 8, 31, 32, 33, 1000, 1280):
            assert (HG._stream_to_bytes(words, total)
                    == JC._stream_to_bytes(words, total))

    def test_words_comp_to_mcu(self):
        w = np.arange(6 * 5 * 3, dtype=np.uint32).reshape(30, 3)
        assert np.array_equal(HG._words_comp_to_mcu(w, 5),
                              JC._words_comp_to_mcu(w, 5))

    def test_decode_entropy_host(self, streams):
        pj = parse(streams[0])
        for a, b in zip(HG.decode_entropy_host(pj),
                        JC.decode_entropy_host(pj)):
            assert np.array_equal(a, b)

    def test_ycc420_host_frontend(self, streams):
        pjs = [parse(s) for s in streams]
        got, ref = HG._ycc420_host_frontend(pjs), JC._ycc420_host_frontend(pjs)
        assert np.array_equal(got[0], ref[0])
        assert got[1:] == ref[1:]

    def test_check_uniform_quant(self, batches, streams):
        pjs = [parse(s) for s in streams]
        HG._check_uniform_quant(pjs, pjs[0])
        JC._check_uniform_quant(pjs, pjs[0])
        mixed = pjs + [parse(TC.encode_batch(batches[0][:1], quality=80,
                                             device=CPU)[0])]
        for fn in (HG._check_uniform_quant, JC._check_uniform_quant):
            with pytest.raises(ValueError, match="uniform quant"):
                fn(mixed, mixed[0])

    def test_decode_batch_ycc420_finish(self, streams):
        flat, kw, props, mx, my = TC._decode_host_prep(
            streams, gray=False, precision="fast", transport=None)
        planes = np.asarray(JC._decode_fused_batch_ycc420(
            jnp.asarray(flat), **kw))
        ticket = ("ycc420", planes, props, kw["N"], mx, my)
        a, pa = HG._decode_batch_ycc420_finish(ticket)
        b, pb = JC._decode_batch_ycc420_finish(ticket)
        assert np.array_equal(a, b) and pa == pb
