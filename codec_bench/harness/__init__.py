"""The benchmark harness of jpezy_tpu_torch: one cell, one run, one line."""
