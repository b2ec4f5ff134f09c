"""The import guard compares top-level names whole."""
import os
import subprocess
import sys
import types

import pytest
from codec_bench.harness import guard
from conftest import ROOT


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib.xla_client",
                                  "flax", "jpezy_tpu", "jpezy_tpu.codec"])
def test_trips_on_a_forbidden_module(name):
    assert guard.forbidden_modules({name: None, "numpy": None}) == [name]


@pytest.mark.parametrize("name", ["jpezy_tpu_torch", "jpezy_tpu_torch.codec",
                                  "jaxtyping", "flaxen", "jpezy"])
def test_passes_a_name_that_only_begins_alike(name):
    assert guard.forbidden_modules({name: None}) == []


@pytest.mark.parametrize("name", ["jpezy_tpu", "jax"])
def test_check_raises_on_a_planted_module(name):
    planted = name not in sys.modules
    sys.modules.setdefault(name, types.ModuleType(name))
    try:
        with pytest.raises(guard.ForbiddenImport, match=name):
            guard.check("test")
    finally:
        if planted:
            del sys.modules[name]


def test_the_harness_and_the_port_load_neither():
    code = ("import codec_bench.harness.main, codec_bench.calibrate, "
            "jpezy_tpu_torch.runtime.pipeline, jpezy_tpu_torch.codec.torch_codec;"
            "from codec_bench.harness import guard, spec;"
            "spec.reference({'reference': 'jfif_baseline'}, spec.BENCH_DIR);"
            "print(guard.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"}).stdout
    assert out.strip() == "[]"
