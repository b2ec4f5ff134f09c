"""Run one cell of the benchmark of jpezy_tpu_torch once.

    python3 codec_bench/run.py --workload kodak.decode --seed 7 \
        --seconds 30 --trace 0

from the root of a checkout; see codec_bench/harness/main.py."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from codec_bench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
