"""jpezy_tpu_torch: the PyTorch/CUDA port of jpezy_tpu for NVIDIA Hopper.

A second package beside jpezy_tpu, which stays the reference it is tested
against.  It imports nothing of jpezy_tpu and nothing of jax: the jax-free
host code (core/, bitstream/, runtime/native.py, runtime/ppm.py,
codec/oracle.py, codec/host_codec.py, utils/timing.py) is a verbatim copy, held
byte-identical to jpezy_tpu's by tests/test_torch_host_copies.py, and the
C++ host runtime csrc/jpezy_host.cpp is shared.  Device code is torch; the
entropy encode of blocks and the symbol counts of optimize
(ops/pack_cuda.py) and the Huffman decode of restart segments
(ops/scan_cuda.py) run as hand-written CUDA kernels on CUDA tensors.
parallel/ shards the codec over a ('data', 'tile') mesh of ranks on
torch.distributed.

Public API (every entry point takes device=, default "cuda", which raises
when no card is present; pass device="cpu" for the CPU path):

    from jpezy_tpu_torch import encode_batch, decode_batch, roundtrip_batches
    streams = encode_batch(rgbs)                  # [N, H, W, 3] uint8
    pixels, props = decode_batch(streams)
    streams = encode_batch(rgbs, restart_interval=8)   # DRI + RSTn
    pixels, props = decode_batch(streams)         # Huffman decode on device
    streams = encode_batch(rgbs, optimize=True)   # per-image Huffman tables
    jpeg = encode(r, g, b)                        # one image, any size
    r, g, b, props = decode(jpeg, precision="exact")
    streams = encode_mixed(images)                # list of [H, W, 3]
    jpeg = encode_host(r, g, b)                   # host C++ codec, no card

    from jpezy_tpu_torch.parallel import make_mesh
    mesh = make_mesh(data, tile)                  # one rank per shard
    streams = encode_sharded(mesh, rgbs)          # this rank's data row
    pixels = decode_sharded(mesh, streams)

Command line: python -m jpezy_tpu_torch.cli encode in.ppm out.jpg [--gpu]
(jpezy_tpu_torch/cli.py; scripts jpezy-torch, jpezy-torch-encode and
jpezy-torch-decode).

Lazy: importing this package imports neither torch's CUDA kernels nor the
codec modules until an entry point is called.
"""
from __future__ import annotations

__version__ = "0.1.0"


def encode_batch(*args, **kwargs):
    from .codec.torch_codec import encode_batch as _f

    return _f(*args, **kwargs)


def decode_batch(*args, **kwargs):
    from .codec.torch_codec import decode_batch as _f

    return _f(*args, **kwargs)


def encode(*args, **kwargs):
    from .codec.torch_codec import encode as _f

    return _f(*args, **kwargs)


def decode(*args, **kwargs):
    from .codec.torch_codec import decode as _f

    return _f(*args, **kwargs)


def encode_mixed(*args, **kwargs):
    from .runtime.batch import encode_mixed as _f

    return _f(*args, **kwargs)


def decode_mixed(*args, **kwargs):
    from .runtime.batch import decode_mixed as _f

    return _f(*args, **kwargs)


def roundtrip_batches(*args, **kwargs):
    from .runtime.pipeline import roundtrip_batches as _f

    return _f(*args, **kwargs)


def encode_host(*args, **kwargs):
    """Complete host C++ codec path (no card, no torch kernels): the
    reference's streams.  See codec/host_codec.py."""
    from .codec.host_codec import encode as _f

    return _f(*args, **kwargs)


def decode_host(*args, **kwargs):
    from .codec.host_codec import decode as _f

    return _f(*args, **kwargs)


def encode_sharded(*args, **kwargs):
    from .parallel.api import encode_sharded as _f

    return _f(*args, **kwargs)


def decode_sharded(*args, **kwargs):
    from .parallel.api import decode_sharded as _f

    return _f(*args, **kwargs)
