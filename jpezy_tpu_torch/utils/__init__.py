"""Host utilities of the port: timing.py is a verbatim copy of
jpezy_tpu/utils/timing.py (the port imports nothing of jpezy_tpu;
tests/test_torch_host_copies.py holds it byte-identical, change both
together); profiling.py is the port's counterpart of
jpezy_tpu/utils/profiling.py, with a torch.profiler trace.
"""
