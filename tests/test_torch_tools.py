"""The port's tools and entry points without a device kernel: the
bitstream differ (a verbatim copy), the profiling helpers, the host codec
facades, the reference's two-binary command line, and the rule that no
module of the port imports jax or jpezy_tpu (checked in a fresh
interpreter)."""
import os
import subprocess
import sys

import numpy as np
import pytest

from jpezy_tpu_torch.bitstream import differ
from jpezy_tpu_torch.codec import host_codec, oracle
from jpezy_tpu_torch.utils.profiling import (Stopwatch, device_trace,
                                             encode_flops)

from test_torch_host_copies import host_runtime  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def split(rgb):
    return rgb[..., 0], rgb[..., 1], rgb[..., 2]


class TestDiffer:
    """tests/test_tools.py::TestDiffer on the port's copy."""

    def test_identical(self, small_rgb):
        a = oracle.encode(*split(small_rgb))
        assert differ.diff(a, a) == []

    def test_segment_names(self, small_rgb):
        a = oracle.encode(*split(small_rgb))
        names = [s.name for s in differ.segment_list(a)]
        assert names[:4] == ["SOI", "APP0", "COM", "DQT"]
        assert "SOF0" in names and "SOS" in names and "SCAN" in names
        assert names[-1] == "EOI"

    def test_detects_payload_diff(self, small_rgb):
        a = oracle.encode(*split(small_rgb))
        b = oracle.encode(*split(small_rgb), gray=True)  # COM text differs
        assert any("COM" in line for line in differ.diff(a, b))

    def test_detects_missing_segment(self, small_rgb):
        a = oracle.encode(*split(small_rgb))
        b = oracle.encode(*split(small_rgb), restart_interval=4)
        assert differ.diff(a, b)  # DRI segment and scan framing differ


class TestProfiling:
    def test_flop_model(self):
        c = encode_flops(512, 512)
        assert c["blocks"] == 6144
        assert c["dct_flops"] == 6144 * 8192
        assert c["hbm_bytes"] == 512 * 512 * 3 + 6144 * 64 * 4 * 3

    def test_stopwatch(self):
        sw = Stopwatch()
        for _ in range(2):
            with sw.section("a"):
                pass
        with pytest.raises(RuntimeError):
            with sw.section("b"):
                raise RuntimeError("the section still counts")
        assert set(sw.totals) == {"a", "b"}
        assert "a" in sw.report() and sw.report().endswith("ms")

    def test_device_trace_writes_a_chrome_trace_on_the_cpu(self, tmp_path):
        import json

        import torch

        with device_trace(str(tmp_path / "trace")) as prof:
            torch.arange(4096, dtype=torch.float32).reshape(64, 64).sum()
        path = tmp_path / "trace" / "trace.json"
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        assert any("aten::sum" in str(e.get("name")) for e in events)
        assert any("aten::sum" in k.key for k in prof.key_averages())


class TestFacades:
    def test_encode_host_decode_host(self, small_rgb):
        import jpezy_tpu_torch as J

        s = J.encode_host(*split(small_rgb), restart_interval=2)
        assert s == host_codec.encode(*split(small_rgb), restart_interval=2)
        got, want = J.decode_host(s), host_codec.decode(s)
        for a, b in zip(got[:3], want[:3]):
            assert np.array_equal(a, b)

    def test_sharded_facades(self, small_rgb):
        import jpezy_tpu_torch as J
        from jpezy_tpu_torch.codec import torch_codec as TC
        from jpezy_tpu_torch.parallel import make_mesh

        mesh = make_mesh(1, 1, device="cpu")
        s = J.encode_sharded(mesh, small_rgb[None], precision="exact")
        assert s == [host_codec.encode(*split(small_rgb))]
        px, _ = TC.decode_batch(s, transport="rgb", device="cpu")
        assert np.array_equal(J.decode_sharded(mesh, s), px)


class TestTwoBinaries:
    """main_encode / main_decode: the reference's jpezy_encode and
    jpezy_decode binaries (scripts jpezy-torch-encode/-decode)."""

    def test_encode_then_decode(self, tmp_path, small_rgb, capsys):
        from jpezy_tpu_torch import cli
        from jpezy_tpu_torch.runtime import ppm

        src, jpg, out = (str(tmp_path / n) for n in
                         ("in.ppm", "out.jpg", "out.ppm"))
        ppm.write(src, small_rgb, fmt="P3")
        assert cli.main_encode([src, jpg, "--host"]) == 0
        data = open(jpg, "rb").read()
        assert data == host_codec.encode(*split(small_rgb))
        assert cli.main_decode([jpg, out, "--host"]) == 0
        _, _, _, px = ppm.read(out)
        assert np.array_equal(px, np.stack(host_codec.decode(data)[:3], -1))
        assert "forced by --host" in capsys.readouterr().out

    def test_usage_without_arguments(self, capsys):
        from jpezy_tpu_torch import cli

        assert cli.main_encode([]) != 0
        assert cli.main_decode([]) != 0


def test_port_imports_no_jax_and_no_jpezy_tpu():
    """Every module of jpezy_tpu_torch, imported in a fresh interpreter,
    brings in neither jax nor the JAX package."""
    code = (
        "import pkgutil, sys, importlib, jpezy_tpu_torch as P\n"
        "mods = [m.name for m in pkgutil.walk_packages(P.__path__, "
        "'jpezy_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'jpezy_tpu'))\n"
        "print(len(mods), bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.split(" ", 1)
    assert int(n) > 30 and bad.strip() == "[]", res.stdout
