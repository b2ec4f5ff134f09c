"""The benchmark's specification and the pieces it names.

`BENCHMARK.json` at the root of the checkout lists the cells and metrics.
Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by the name the specification gives:

    configs/<config>.json    sizes, settings and the reference module
    traffic/<mix>.json       the parameters the general generator reads
    metrics/<metric>.py      a reader: read(run) -> float or None; a
                             metric named <quantity>.<part> falls back to
                             metrics/<quantity>.py
    reference/<module>.py    a configuration's plain reference

so a later change adds a cell or a metric by adding files and entries.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys
from types import ModuleType

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")


@dataclasses.dataclass
class Cell:
    """One workload of the specification, with what it names loaded."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    bench_dir: str

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports: its per-layer ones with trace,
        its end-to-end ones without."""
        pool = self.per_layer if trace else self.end_to_end
        return [m for m in pool
                if "workloads" not in m or self.name in m["workloads"]]


def _named(kind: str, name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a valid name")
    return name


def load_cell(workload: str, root: str = ROOT,
              bench_dir: str | None = None) -> Cell:
    """The cell `workload` of root/BENCHMARK.json, its configuration and
    traffic files read from bench_dir (default: this harness's folder)."""
    bench_dir = bench_dir or os.path.join(root, os.path.basename(BENCH_DIR))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {', '.join(sorted(cells))})")
    w = cells[workload]
    cfg_name = _named("config", w["config"])
    entry = {c["name"]: c for c in spec["configs"]}[cfg_name]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    config["name"] = cfg_name
    with open(os.path.join(bench_dir, "traffic",
                           _named("traffic", w["traffic"]) + ".json")) as f:
        traffic = json.load(f)
    traffic["name"] = w["traffic"]
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=spec["end_to_end"],
                per_layer=spec["per_layer"], bench_dir=bench_dir)


def _load_file(path: str, module_name: str) -> ModuleType:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    s = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(s)
    sys.modules[module_name] = mod
    s.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str):
    """metrics/<name>.py's read function; where there is none, that of
    metrics/<name up to its first dot>.py, which serves every part of one
    quantity (`device_idle_pct.encode`, `device_idle_pct.decode`)."""
    folder = os.path.join(bench_dir, "metrics")
    path = os.path.join(folder, _named("metric", name) + ".py")
    if not os.path.exists(path):
        path = os.path.join(folder, name.split(".")[0] + ".py")
    return _load_file(path, "codec_bench_metric_" + re.sub(
        r"\W", "_", os.path.basename(path)[:-3])).read


def reference(config: dict, bench_dir: str) -> ModuleType:
    """The configuration's plain reference, reference/<module>.py."""
    name = _named("reference", config["reference"])
    return _load_file(os.path.join(bench_dir, "reference", name + ".py"),
                      "codec_bench_reference_" + re.sub(r"\W", "_", name))
