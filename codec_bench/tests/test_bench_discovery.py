"""A configuration, a traffic mix and a metric added as new files and new
entries are found by name; no existing file is edited."""
import hashlib
import json
import os

from conftest import run_cell


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "codec_bench")):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[p] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_config_traffic_and_metric_are_found(checkout):
    bench = os.path.join(checkout, "codec_bench")
    before = _digests(checkout)
    with open(os.path.join(bench, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg.update(width=128, height=48, images=5)
    with open(os.path.join(bench, "configs", "wide_new.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "tiny_decode.json")) as f:
        tr = json.load(f)
    tr.update(batch=3, lookahead=1)
    with open(os.path.join(bench, "traffic", "mix_new.json"), "w") as f:
        json.dump(tr, f)
    with open(os.path.join(bench, "metrics", "batches_new.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.window.batches))\n")
    with open(os.path.join(checkout, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "wide_new", "source": "tests",
                            "file": "codec_bench/configs/wide_new.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "wide_new.decode", "config": "wide_new",
                              "traffic": "mix_new", "chips": 1,
                              "why": "tests"})
    spec["end_to_end"].append({"name": "batches_new", "unit": "batches",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["wide_new.decode"]})
    with open(os.path.join(checkout, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    result, _ = run_cell(checkout, "wide_new.decode")
    assert result["correct"] is True
    assert result["metrics"]["batches_new"]["value"] >= 1
    assert result["attempted"] == 3 * result["metrics"]["batches_new"]["value"]
    after = _digests(checkout)
    assert {p: h for p, h in after.items() if p in before} == before
