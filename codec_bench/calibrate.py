"""Readings that the limits of `correct` are set from, on the card.

    python3 codec_bench/calibrate.py --workload kodak.encode \
        --seeds 1,2,...,12 --control-seeds 1,2,3 --fault-seeds 1,2,3 \
        --seconds 3 [--out calibrate.jsonl]

In one process, for each seed: the cell's inputs, a short window of the
port as the benchmark drives it, judged; on the control seeds, the
reference in the program's place at TF32 (the precision below the float32
the configurations state), judged the same way; on the fault seeds, a
window with each fault of harness/faults.py planted under the timed path.
One JSON line a reading, with every compared number.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from codec_bench.harness import faults as F  # noqa: E402
from codec_bench.harness import judge as J  # noqa: E402
from codec_bench.harness import spec  # noqa: E402
from codec_bench.harness import workload as W  # noqa: E402


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, required=True)
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--fault-seeds", type=_seeds, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    ref = spec.reference(cell.config, cell.bench_dir)
    from jpezy_tpu_torch.codec import torch_codec

    out = open(args.out, "a") if args.out else None
    warm = False
    for seed in sorted(set(args.seeds) | set(args.control_seeds)
                       | set(args.fault_seeds)):
        t = time.perf_counter()
        inputs = W.prepare(cell, seed, ref)
        if not warm:
            W.warm_up(cell, inputs, args.device)
            warm = True
        runs = []
        if seed in args.seeds:
            runs.append(("program", lambda: W.run_window(
                cell, inputs, args.seconds, args.device, seed)))
        if seed in args.control_seeds:
            runs.append(("control_tf32", lambda: F.control_window(
                cell, inputs, ref)))
        for fault in F.FAULTS if seed in args.fault_seeds else ():
            def faulty(fault=fault):
                undo = F.plant(torch_codec, cell.traffic["direction"], fault)
                try:
                    return W.run_window(cell, inputs, args.seconds,
                                        args.device, seed)
                finally:
                    undo()
            runs.append((f"fault_{fault}", faulty))
        for kind, make in runs:
            v = J.judge(cell, inputs, make(), ref)
            line = {"workload": cell.name, "seed": seed, "kind": kind,
                    "correct": v.correct, "attempted": v.attempted,
                    "failed": v.failed,
                    "checks": {n: c[0] for n, c in v.checks.items()},
                    "seconds": time.perf_counter() - t}
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
