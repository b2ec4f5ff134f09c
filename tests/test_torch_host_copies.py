"""The port's copies of jpezy_tpu's jax-free host modules.

jpezy_tpu_torch imports nothing of jpezy_tpu, so it carries verbatim copies
of the host code both packages run: Annex K tables, geometry and props, the
marker writer/reader, splice and differ, the ctypes loader of the C++ host
runtime, the oracle, the host C++ codec, the section timer and the PPM
reader and writer.  Each copy must stay byte-identical to its original,
and the copied host codec must give the original's streams.  The host
helpers that codec/host_glue.py copies out of jpezy_tpu.codec.jax_codec
(which imports jax) must keep their original's code: same arguments, same
statements, only the docstring may differ.
"""
import ast
import inspect
import os
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = [
    "core/tables.py", "core/geometry.py", "core/props.py",
    "bitstream/reader.py", "bitstream/writer.py", "bitstream/splice.py",
    "runtime/native.py", "codec/oracle.py", "codec/host_codec.py",
    "utils/timing.py", "runtime/ppm.py", "bitstream/differ.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_identical(rel):
    with open(os.path.join(REPO, "jpezy_tpu", rel), "rb") as f:
        original = f.read()
    with open(os.path.join(REPO, "jpezy_tpu_torch", rel), "rb") as f:
        copy = f.read()
    assert copy == original, f"jpezy_tpu_torch/{rel} drifted from jpezy_tpu/{rel}"


def build_host_runtime() -> None:
    """Build the shared C++ host runtime (build/libjpezy_host.so) once,
    free of races between test workers.

    native.py (both packages' copies) compiles to one fixed temporary
    file, so workers that start on an empty build/ and compile together
    can break each other's build.  Here the compile goes to a file named
    after this process and is renamed into place, which is atomic; the
    loaders then find the library up to date and build nothing."""
    from jpezy_tpu_torch.runtime import native

    so = native._SO
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(native._SRC):
        return
    own = f"{so}.{os.getpid()}"
    native._SO = own          # _build() compiles to own + ".tmp", renames to own
    try:
        native._build()
    finally:
        native._SO = so
    os.replace(own, so)


@pytest.fixture(scope="module", autouse=True)
def host_runtime():
    """Autouse in every port test module that reaches the C++ runtime."""
    build_host_runtime()


@pytest.mark.parametrize("seed", [0, 1])
def test_copied_host_codec_matches_original(seed):
    from imagegen import make_test_image
    from jpezy_tpu.codec import host_codec as ref
    from jpezy_tpu_torch.codec import host_codec as port

    im = make_test_image(48, 64, seed=seed)
    planes = (im[..., 0], im[..., 1], im[..., 2])
    s = port.encode(*planes)
    assert s == ref.encode(*planes)
    for a, b in zip(port.decode(s)[:3], ref.decode(s)[:3]):
        assert np.array_equal(a, b)


# host_glue functions that are verbatim copies of jax_codec functions
# (_device_host_frontend and _device_luts differ on purpose; their outputs
# are held equal in tests/test_torch_device_decode.py)
GLUE_COPIES = [
    "host_rgb_to_ycc420", "_stream_to_bytes", "_words_comp_to_mcu",
    "decode_entropy_host", "_decode_entropy_batch", "_ycc420_host_frontend", "_check_uniform_quant",
    "_decode_batch_ycc420_finish", "_splice_restart_raw",
    "_assemble_restart_segments", "_quant_arr", "_decode_batch_device_finish",
]


def _code_of(fn):
    """A function's arguments and statements without its docstring."""
    node = ast.parse(textwrap.dedent(inspect.getsource(fn))).body[0]
    body = node.body
    if (isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)):
        body = body[1:]
    return ast.dump(node.args), [ast.dump(stmt) for stmt in body]


@pytest.mark.parametrize("name", GLUE_COPIES)
def test_host_glue_copy_has_not_drifted(name):
    from jpezy_tpu.codec import jax_codec
    from jpezy_tpu_torch.codec import host_glue

    assert _code_of(getattr(host_glue, name)) == _code_of(
        getattr(jax_codec, name)), (
        f"host_glue.{name} drifted from jax_codec.{name}")
