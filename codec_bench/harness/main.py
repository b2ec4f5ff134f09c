"""One run of one cell: set-up, the measured window, the judge, one line.

    python3 codec_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

With --trace 0 the line carries the cell's end-to-end metrics; with
--trace 1 its per-layer metrics, read from spans and one profiled window of
the same length.  The last line of standard output is one JSON object:
correct, attempted, failed, metrics, device (and breakdown when traced),
then `checks`, each compared number beside its limit; the same numbers
close standard error.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

from . import guard, judge as J, spec, trace as T, workload as W


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    cell: spec.Cell
    setup_s: float
    window: W.Window
    verdict: J.Verdict
    spans: T.Spans | None
    device: T.DeviceTrace | None

    @property
    def direction(self) -> str:
        return self.cell.traffic["direction"]

    @property
    def pixels_per_image(self) -> int:
        return int(self.cell.config["width"]) * int(self.cell.config["height"])

    @property
    def answered(self) -> int:
        return sum(b.answers for b in self.window.batches)

    def latencies_s(self) -> list[float]:
        return [b.t_yield - b.t_submit for b in self.window.batches]

    def entropy_bytes(self) -> int:
        """Entropy-coded bytes of every answer of the window: of the
        streams that came back (encode), or that went in (decode)."""
        if self.direction == "encode":
            return (sum(b.out_bytes for b in self.window.batches)
                    - self.answered * self.verdict.frame_bytes)
        n = int(self.cell.config["images"])
        b = int(self.cell.traffic["batch"])
        eb = self.verdict.entropy_bytes
        return sum(eb[(k * b + i) % n]
                   for k, bt in enumerate(self.window.batches)
                   for i in range(bt.answers))


def _slices(win: W.Window, pixels: int, k: int = 10) -> list[float]:
    """MP/s over each k-th of the window (by yield time), to tell a rate
    that drifts within a run from one that differs between runs."""
    out = []
    for j in range(k):
        a = win.t0 + j * win.seconds / k
        b = a + win.seconds / k
        n = sum(bt.answers for bt in win.batches if a < bt.t_yield <= b)
        out.append(n * pixels / 1e6 / (b - a))
    return out


def _cpu_seconds() -> float:
    """CPU seconds this process has used, all its threads."""
    t = os.times()
    return t.user + t.system


class RunError(RuntimeError):
    """A run that must print no result."""


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return ""


def _device_ready(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise RunError("torch.cuda.is_available() is False: no card")
    if torch.cuda.device_count() < chips:
        raise RunError(f"{torch.cuda.device_count()} cards, the cell needs "
                       f"{chips}")


def _window(cell, inputs, seconds, device, seed, spans, cuda):
    """The measured window; traced, the profile of it too (taken again
    once where the trace holds no device operation)."""
    if spans is None:
        return W.run_window(cell, inputs, seconds, device, seed), None
    for _ in range(2):
        spans.items.clear()
        spans.on = True
        store = {"spans": spans.items}
        with T.profiled(store, cuda):
            win = W.run_window(cell, inputs, seconds, device, seed)
        spans.on = False
        if store["trace"].events:
            return win, store["trace"]
    raise RunError("the profiled window traced no device operation, twice")


def execute(argv=None, *, t_start: float, device: str = "cuda",
            require_cuda: bool = True, root: str = spec.ROOT,
            bench_dir: str | None = None) -> tuple[dict, list[str]]:
    """Run one cell; returns (result, the lines that close stderr).
    require_cuda=False with device="cpu" drives the rest of a run on the
    CPU (the tests' way in); the device dict then says so."""
    args = _args(argv)
    cell = spec.load_cell(args.workload, root, bench_dir)
    cuda = require_cuda
    marks = [("start", t_start)]
    if require_cuda:
        _device_ready(cell.chips)
    import torch

    if cuda:
        torch.zeros(1, device=device)  # the CUDA context
    marks.append(("torch_and_cuda", time.perf_counter()))
    ref = spec.reference(cell.config, cell.bench_dir)
    from jpezy_tpu_torch.codec import torch_codec
    marks.append(("port_import", time.perf_counter()))

    inputs = W.prepare(cell, args.seed, ref)
    marks.append(("inputs", time.perf_counter()))
    spans = T.Spans() if args.trace else None
    restore = spans.wrap(torch_codec) if spans else (lambda: None)
    try:
        W.warm_up(cell, inputs, device)
        if cuda:
            torch.cuda.synchronize()
        guard.check("after warm-up")
        marks.append(("warm_up", time.perf_counter()))
        cpu0 = _cpu_seconds()
        win, dtrace = _window(cell, inputs, args.seconds, device, args.seed,
                              spans, cuda)
    finally:
        restore()
    marks.append(("window_and_trace", time.perf_counter()))
    cores = (_cpu_seconds() - cpu0) / (marks[-1][1] - marks[-2][1])
    setup_s = win.t0 - t_start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    guard.check("after the window")
    verdict = J.judge(cell, inputs, win, ref)
    marks.append(("judge", time.perf_counter()))
    run = Run(cell=cell, setup_s=setup_s, window=win, verdict=verdict,
              spans=spans, device=dtrace)
    metrics = {}
    for m in cell.metrics(bool(args.trace)):
        value = spec.metric_reader(m["name"], cell.bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count":
           cell.chips if cuda else 0, "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power"] = _power_limit()
    if dtrace is not None:
        dev.update(busy_s=dtrace.busy_s, window_s=dtrace.window_s)
    result = {"correct": verdict.correct, "attempted": verdict.attempted,
              "failed": verdict.failed, "metrics": metrics, "device": dev}
    if dtrace is not None:
        result["breakdown"] = dtrace.breakdown()
    lat = run.latencies_s()
    result["batch_latency"] = {"batches": len(lat), "median_ms":
                               1e3 * statistics.median(lat)}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in verdict.checks.items()}
    lines = ["window tenths MP/s " + " ".join(
        f"{x:.1f}" for x in _slices(win, run.pixels_per_image))]
    lines += [f"batches {len(lat)}, latency median "
              f"{result['batch_latency']['median_ms']:.3f} ms; answers "
              f"judged {verdict.judged} of {run.answered}"]
    lines.append(f"cores this run used over the window: {cores:.2f} of "
                 f"{os.cpu_count()}")
    lines += ["seconds " + " ".join(f"{a}={t1 - t0:.3f}" for (_, t0), (a, t1)
                                   in zip(marks, marks[1:]))]
    lines += [f"check {n} {v!r} limit {lim!r}"
              for n, (v, lim) in verdict.checks.items()]
    return result, lines


def main(argv=None, *, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    try:
        result, lines = execute(argv, t_start=t_start)
        guard.check("at exit")
    except (RunError, guard.ForbiddenImport) as e:
        print(f"codec_bench: {e}", file=sys.stderr)
        return 2
    print(f"device {result['device']['kind']} "
          f"{result['device'].get('power', '')}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
