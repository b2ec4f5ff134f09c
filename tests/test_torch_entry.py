"""The entry points of jpezy_tpu_torch against jpezy_tpu: encode/decode of
one image of any size, encode_mixed/decode_mixed, and the command line
(python -m jpezy_tpu_torch.cli), mirroring tests/test_cli.py.

Exact mode is integer-exact: streams byte-identical to jax_codec.encode
and to host_codec.encode (the true size in the SOF0, the pad replicated
from the edge), pixels identical to jax_codec.decode(precision="exact")
(tolerance 0).  Fast decode of the default ycc420 transport stays within
+-2 of JAX's, as tests/test_torch_codec.py holds it.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jpezy_tpu.codec import jax_codec as JC
from jpezy_tpu.runtime import batch as JBatch
from jpezy_tpu_torch.codec import host_codec
from jpezy_tpu_torch.codec import torch_codec as TC
from jpezy_tpu_torch.core.props import make_encode_props
from jpezy_tpu_torch.runtime import batch as TBatch

from test_torch_host_copies import host_runtime  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _image(h, w, seed):
    from imagegen import make_test_image

    return make_test_image(h, w, seed=seed)


def _planes(im):
    return im[..., 0], im[..., 1], im[..., 2]


@pytest.fixture(scope="module")
def odd():
    return _image(37, 50, 250)


class TestEncodeDecode:
    @pytest.mark.parametrize("hw", [(37, 50), (1, 1)], ids=["50x37", "1x1"])
    def test_exact_equals_jax_and_host(self, hw):
        im = _image(*hw, seed=251)
        got = TC.encode(*_planes(im), precision="exact", device=CPU)
        assert got == JC.encode(*_planes(im), precision="exact")
        assert got == host_codec.encode(*_planes(im))
        r, g, b, props = TC.decode(got, precision="exact", device=CPU)
        assert (props.width, props.height) == (hw[1], hw[0])
        jr, jg, jb, _ = JC.decode(got, precision="exact")
        for x, y in ((r, jr), (g, jg), (b, jb)):
            assert x.shape == hw and x.dtype == np.uint8
            assert np.array_equal(x, y)

    @pytest.mark.parametrize("hw", [(37, 50), (1, 1)], ids=["50x37", "1x1"])
    def test_fast_decode_within_two_of_jax(self, hw):
        s = TC.encode(*_planes(_image(*hw, seed=252)), device=CPU)
        got = np.stack(TC.decode(s, device=CPU)[:3], -1)
        ref = np.stack(JC.decode(s)[:3], -1)
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 2

    @pytest.mark.parametrize("kw", [
        {"optimize": True}, {"restart_interval": 2}, {"gray": True},
        {"quality": 70},
    ], ids=["optimize", "restart2", "gray", "quality70"])
    def test_extensions_equal_host(self, odd, kw):
        got = TC.encode(*_planes(odd), precision="exact", device=CPU, **kw)
        assert got == host_codec.encode(*_planes(odd), **kw)

    def test_props_carried_into_header(self, odd):
        props = make_encode_props(50, 37)
        props.comment = "port props"
        props.h_density = props.v_density = 300
        got = TC.encode(*_planes(odd), props, precision="exact", device=CPU)
        assert got == host_codec.encode(*_planes(odd), props)
        assert TC.decode(got, device=CPU)[3].comment == "port props"

    @pytest.mark.parametrize("transport", [None, "rgb", "device"])
    def test_decode_transports(self, odd, transport):
        s = TC.encode(*_planes(odd), restart_interval=1, device=CPU)
        got = np.stack(TC.decode(s, transport=transport, device=CPU)[:3], -1)
        ref = np.stack(JC.decode(s, transport="rgb")[:3], -1)
        assert got.shape == (37, 50, 3)
        # the ycc420/device tail clamps the planes before the colour
        # conversion (the JAX package's documented envelope)
        tol = 1 if transport == "rgb" else 64
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= tol

    def test_gray_decode_repeats_luma(self, odd):
        s = TC.encode(*_planes(odd), device=CPU)
        r, g, b, _ = TC.decode(s, gray=True, precision="exact", device=CPU)
        jr, _, _, _ = JC.decode(s, gray=True, precision="exact")
        assert np.array_equal(r, jr)
        assert np.array_equal(r, g) and np.array_equal(r, b)

    def test_verbose_prints_phases(self, odd, capsys):
        s = TC.encode(*_planes(odd), device=CPU)
        TC.decode(s, verbose=True, device=CPU)
        TC.decode(s, verbose=True, precision="exact", device=CPU)
        out = capsys.readouterr().out
        # every transport (ycc420, then rgb for exact) under the same phases
        for phase in ("analyzing header...",
                      "entropy frontend + sparse upload (dispatch)...",
                      "device backend + fetch + color tail..."):
            assert out.count(phase) == 2
        assert out.count("Done! Processing time") == 6

    def test_default_device_needs_cuda(self, odd):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TC.encode(*_planes(odd))


@pytest.fixture(scope="module")
def mixed():
    return [_image(37, 50, 260), _image(48, 64, 261), _image(1, 1, 262),
            _image(40, 60, 263), _image(20, 33, 264)]


class TestMixed:
    def test_encode_mixed_equals_jax(self, mixed):
        got = TBatch.encode_mixed(mixed, precision="exact", device=CPU)
        assert got == JBatch.encode_mixed(mixed, precision="exact")
        assert got == [host_codec.encode(*_planes(im)) for im in mixed]

    def test_decode_mixed_equals_jax(self, mixed):
        streams = TBatch.encode_mixed(mixed, precision="exact", device=CPU)
        got = TBatch.decode_mixed(streams, precision="exact", device=CPU)
        ref = JBatch.decode_mixed(streams, precision="exact")
        for g, r, im in zip(got, ref, mixed):
            assert g.shape == im.shape and np.array_equal(g, r)

    def test_mcu_pad(self):
        assert [TBatch.mcu_pad(x) for x in (1, 16, 17, 50)] == [
            JBatch.mcu_pad(x) for x in (1, 16, 17, 50)] == [16, 16, 32, 64]


def run_cli(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "jpezy_tpu_torch.cli", *args],
        capture_output=True, text=True, cwd=cwd, timeout=180, env=env)


@pytest.fixture()
def ppm_file(tmp_path, small_rgb):
    from jpezy_tpu_torch.runtime import ppm

    p = tmp_path / "in.ppm"
    ppm.write(str(p), small_rgb, fmt="P3")
    return str(p)


class TestCli:
    @pytest.mark.parametrize("backend", ["--host", "--cpu"])
    def test_encode_decode_roundtrip(self, ppm_file, tmp_path, small_rgb,
                                     backend):
        out = str(tmp_path / "out.jpg")
        res = run_cli(["encode", ppm_file, out, backend], tmp_path)
        assert res.returncode == 0, res.stderr
        assert "width: 48 height: 64" in res.stdout
        assert "Output size:" in res.stdout
        assert "Total processing time:" in res.stdout
        want = ("backend: host (C++ codec; forced by --host)"
                if backend == "--host" else "backend: cpu (torch; forced")
        assert want in res.stdout
        data = open(out, "rb").read()
        if backend == "--host":
            assert data == host_codec.encode(*_planes(small_rgb))
        else:
            assert data == TC.encode(*_planes(small_rgb), device=CPU)
        dec = str(tmp_path / "dec.ppm")
        res = run_cli(["decode", out, dec, backend], tmp_path)
        assert res.returncode == 0, res.stderr
        assert "Loaded JPEG: 48x64" in res.stdout
        from jpezy_tpu_torch.runtime import ppm

        w, h, _, px = ppm.read(dec)
        assert (w, h) == (48, 64)
        want = (host_codec.decode(data) if backend == "--host"
                else TC.decode(data, device=CPU))
        assert np.array_equal(px, np.stack(want[:3], -1))

    def test_small_image_auto_picks_card(self, ppm_file, tmp_path):
        """With no backend flag even a small image goes to the card; without
        one the run refuses, and never falls to the CPU or the host."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        res = run_cli(["encode", ppm_file, str(tmp_path / "o.jpg")], tmp_path)
        assert res.returncode != 0
        assert "backend: gpu (torch on the CUDA card; default" in res.stdout
        assert "no CUDA device" in res.stderr

    def test_encode_flags(self, ppm_file, tmp_path, small_rgb):
        out = str(tmp_path / "o.jpg")
        res = run_cli(["encode", ppm_file, out, "--gray", "--optimize",
                       "--quality", "70", "--restart-interval", "2", "--cpu"],
                      tmp_path)
        assert res.returncode == 0, res.stderr
        assert "srook::byte" in res.stdout  # reference gray quirk
        assert open(out, "rb").read() == TC.encode(
            *_planes(small_rgb), gray=True, optimize=True, quality=70,
            restart_interval=2, device=CPU)

    def test_ppm_passthrough(self, ppm_file, tmp_path):
        out = str(tmp_path / "copy.ppm")
        res = run_cli(["encode", ppm_file, out], tmp_path)
        assert res.returncode == 0, res.stderr
        assert open(out, "rb").read(32).startswith(b"P3\n48 64\n255\n")

    def test_verbose_decode(self, ppm_file, tmp_path):
        out = str(tmp_path / "o.jpg")
        assert run_cli(["encode", ppm_file, out, "--host"],
                       tmp_path).returncode == 0
        res = run_cli(["decode", out, str(tmp_path / "d.ppm"), "-v", "--cpu"],
                      tmp_path)
        assert res.returncode == 0, res.stderr
        assert "found marker: [SOF0]" in res.stdout
        assert "analyzing header..." in res.stdout

    @pytest.mark.parametrize("args", [
        [], ["encode"], ["decode", "a.png", "b.ppm"], ["frobnicate"],
        ["encode", "missing.ppm", "o.jpg"], ["encode", "x.ppm", "o.jpg",
                                             "--quality", "0"],
    ], ids=["none", "encode", "decode-ext", "command", "missing", "quality"])
    def test_usage_errors(self, tmp_path, args):
        res = run_cli(args, tmp_path)
        assert res.returncode == 1
        assert "Usage: jpezy-torch" in res.stderr

    def test_decode_garbage(self, tmp_path):
        bad = tmp_path / "bad.jpg"
        bad.write_bytes(b"\xff\xd8garbage")
        res = run_cli(["decode", str(bad), str(tmp_path / "o.ppm"), "--cpu"],
                      tmp_path)
        assert res.returncode == 1
        assert "decode failed" in res.stderr

    def test_gpu_without_card_refuses(self, ppm_file, tmp_path):
        """--gpu never runs on the CPU in the card's place."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        res = run_cli(["encode", ppm_file, str(tmp_path / "o.jpg"), "--gpu"],
                      tmp_path)
        assert res.returncode != 0
        assert "backend: gpu (torch on the CUDA card; forced by --gpu)" \
            in res.stdout
        assert "no CUDA device" in res.stderr


class TestPickBackend:
    def test_auto_and_forced(self, capsys):
        from jpezy_tpu_torch import cli

        assert cli._pick_backend(None) == "gpu"
        assert "card; default" in capsys.readouterr().out
        assert cli._pick_backend("host") == "host"
        assert cli._pick_backend("cpu") == "cpu"
        assert cli._pick_backend("gpu") == "gpu"
        assert "forced by --gpu" in capsys.readouterr().out

    def test_without_native_runtime(self, monkeypatch, capsys):
        """A forced --host raises; the default stays the card, never the
        CPU."""
        from jpezy_tpu_torch import cli
        from jpezy_tpu_torch.runtime import native

        def missing():
            raise native.NativeUnavailable("no compiler")

        monkeypatch.setattr(native, "get_lib", missing)
        with pytest.raises(ImportError):
            cli._pick_backend("host")
        assert cli._pick_backend(None) == "gpu"
        assert "backend: gpu" in capsys.readouterr().out
