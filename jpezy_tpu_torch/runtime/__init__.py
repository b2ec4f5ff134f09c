"""Runtime of the port: pipeline.py (the stage-threaded round trip),
batch.py (mixed-size lists), and verbatim copies of jpezy_tpu's
runtime/native.py (the ctypes loader of the C++ host runtime
csrc/jpezy_host.cpp) and runtime/ppm.py (PPM reader and writer), held
byte-identical to them by tests/test_torch_host_copies.py.
"""
