"""Runtime of the port: pipeline.py (the stage-threaded round trip) and
native.py, a verbatim copy of jpezy_tpu/runtime/native.py (the ctypes
loader of the C++ host runtime csrc/jpezy_host.cpp), held byte-identical
to it by tests/test_torch_host_copies.py.
"""
