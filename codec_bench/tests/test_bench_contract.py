"""BENCHMARK.json and the result line keep to the benchmark's contract."""
import json
import os
import re

import pytest
from codec_bench.harness import spec as harness_spec
from conftest import BENCH, ROOT, run_cell

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}\Z")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(spec):
    assert set(spec) == TOP
    assert spec["paths"] == ["codec_bench"]
    assert 1 <= spec["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_entries_have_the_contract_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("codec_bench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}


def test_names_units_and_lines(spec):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in spec[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for x in spec["configs"] + spec["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    for c in spec["configs"]:
        assert 1 <= len(c["source"]) <= 200
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_named_piece_has_its_file(spec):
    e2e = {m["name"] for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness_spec.metric_reader(m["name"], BENCH))
        assert set(m.get("workloads", ())) <= cells, m["name"]
        if "moves" in m:
            assert m["moves"] in e2e
    for w in spec["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
    for c in spec["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert os.path.exists(os.path.join(BENCH, "reference",
                                           cfg["reference"] + ".py"))
        for key in c["reduced"]:
            assert key in cfg


def test_every_cell_reports_what_the_contract_asks(spec):
    for w in spec["workloads"]:
        def mine(pool):
            return [m for m in pool
                    if "workloads" not in m or w["name"] in m["workloads"]]
        e2e = {m["name"] for m in mine(spec["end_to_end"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert mine(spec["per_layer"])
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}


@pytest.mark.parametrize("workload", ["tiny.encode", "tiny_ri2.decode"])
def test_result_line_keys(checkout, workload):
    result, lines = run_cell(checkout, workload)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "batch_latency", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    d = "encode" if workload.endswith("encode") else "decode"
    assert set(result["metrics"]) == {f"{d}_mps", "batch_p95_ms", "setup_s"}
    assert result["batch_latency"]["batches"] >= 1
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    checks = [ln for ln in lines if ln.startswith("check ")]
    assert lines[-len(checks):] == checks
    assert [ln.split()[1] for ln in checks] == list(result["checks"])
    assert checks[0].startswith("check answers_failed 0 limit 0")
    json.dumps(result)
