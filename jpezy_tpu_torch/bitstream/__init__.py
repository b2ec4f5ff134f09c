"""Verbatim copy of jpezy_tpu/bitstream/ (reader.py, writer.py, splice.py,
differ.py).

The port imports nothing of jpezy_tpu, so it carries its own copy of this
jax-free host code.  tests/test_torch_host_copies.py holds every file
byte-identical to its original; change both together.
"""
