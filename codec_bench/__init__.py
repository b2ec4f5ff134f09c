"""The benchmark of jpezy_tpu_torch (see BENCHMARK.json and run.py)."""
