"""Fixtures of the harness's tests: a copy of the benchmark in a temporary
directory with tiny cells added, driven on the CPU."""
import json
import os
import shutil
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"tiny_ri2": ("serve512_ri8", 2), "tiny": ("kodak_768x512", 0)}
# the four cells of the two deployments, added where BENCHMARK.json does
# not carry them, so that the judge is tried at each cell's own size
FULL = {"kodak.decode": "kodak_768x512", "serve512.decode": "serve512_ri8",
        "kodak.encode": "kodak_768x512", "serve512.encode": "serve512_ri8"}


def _add_cell(spec: dict, name: str, config: str, traffic: str) -> None:
    if name in {w["name"] for w in spec["workloads"]}:
        return
    spec["workloads"].append({"name": name, "config": config,
                              "traffic": traffic, "chips": 1,
                              "why": "tests"})
    d = traffic.rsplit("_", 1)[1]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if d in m["name"] and "workloads" in m:
            m["workloads"].append(name)


def add_tiny_cells(root: str) -> None:
    """Tiny configurations (6 images of 96x64), a tiny traffic mix of
    batches of 4 and their cells, as new files and entries; and each
    cell of the two deployments that BENCHMARK.json lacks."""
    bench = os.path.join(root, "codec_bench")
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    configs = {c["name"] for c in spec["configs"]}
    for cfg in sorted(set(FULL.values()) - configs):
        spec["configs"].append({"name": cfg, "source": "tests",
                                "file": f"codec_bench/configs/{cfg}.json",
                                "reduced": [], "why": "tests"})
    for cell, cfg in FULL.items():
        _add_cell(spec, cell, cfg, "bulk_" + cell.split(".")[1])
    for name, (base, ri) in TINY.items():
        with open(os.path.join(bench, "configs", base + ".json")) as f:
            cfg = json.load(f)
        cfg.update(width=96, height=64, images=6, restart_interval=ri)
        with open(os.path.join(bench, "configs", name + ".json"), "w") as f:
            json.dump(cfg, f)
        spec["configs"].append({"name": name, "source": "tests",
                                "file": f"codec_bench/configs/{name}.json",
                                "reduced": [], "why": "tests"})
    for d in ("encode", "decode"):
        with open(os.path.join(bench, "traffic", f"bulk_{d}.json")) as f:
            tr = json.load(f)
        tr.update(batch=4, warmup_batches=2)
        with open(os.path.join(bench, "traffic", f"tiny_{d}.json"), "w") as f:
            json.dump(tr, f)
        for name in TINY:
            _add_cell(spec, f"{name}.{d}", name, f"tiny_{d}")
    with open(spec_path, "w") as f:
        json.dump(spec, f, indent=1)


@pytest.fixture
def checkout(tmp_path):
    """A copy of BENCHMARK.json and codec_bench/ with the tiny cells."""
    shutil.copytree(BENCH, tmp_path / "codec_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    add_tiny_cells(str(tmp_path))
    return str(tmp_path)


def run_cell(root: str, workload: str, seconds: float = 0.6, trace: int = 0,
             seed: int = 3_000_000_019):
    """One run of `workload` in the checkout at `root`, on the CPU."""
    from codec_bench.harness import main as M

    return M.execute(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace)],
                     t_start=time.perf_counter(), device="cpu",
                     require_cuda=False, root=root,
                     bench_dir=os.path.join(root, "codec_bench"))
