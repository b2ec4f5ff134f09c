"""Codec pipelines of the port: torch_codec (batched encode/decode),
host_glue (host helpers copied from jpezy_tpu.codec.jax_codec), and the
jax-free host modules oracle and host_codec, verbatim copies of
jpezy_tpu/codec/oracle.py and host_codec.py held byte-identical to them by
tests/test_torch_host_copies.py.

Lazy, like jpezy_tpu.codec: attributes import their module on first use.
"""
import importlib


def __getattr__(name):
    if name in ("decode_batch", "encode_batch", "decode", "encode"):
        return getattr(importlib.import_module(".torch_codec", __name__), name)
    if name in ("torch_codec", "host_glue", "oracle", "host_codec"):
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
