"""A cell run on the card (marked `cuda`, skipped without one): run
`python -m pytest codec_bench/tests -m cuda` on the machine with the
card."""
import json
import os
import subprocess
import sys

import pytest
from conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(card, workload, trace):
    r = subprocess.run([sys.executable, "codec_bench/run.py", "--workload",
                        workload, "--seed", str(2 ** 31 + 11), "--seconds",
                        "2", "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert result["device"]["busy_s"] > 0
        assert "breakdown" in result


@pytest.mark.cuda
def test_no_result_without_the_port(card, tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "codec_bench"),
                    tmp_path / "codec_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    r = subprocess.run([sys.executable, "codec_bench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert r.returncode != 0
    assert '"correct"' not in r.stdout
