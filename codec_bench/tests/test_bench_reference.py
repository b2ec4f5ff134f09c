"""The plain reference: its streams, its decoder and its precisions."""
import io

import numpy as np
import pytest
from codec_bench.harness import images as I
from codec_bench.reference import jfif_baseline as R


@pytest.fixture(scope="module")
def image():
    return I.image_set(1, 64, 96, 12_345_678_901, 100, 100)[0]


@pytest.mark.parametrize("ri", [0, 1, 3, 8, 100])
def test_streams_decode_to_their_coefficients(image, ri):
    coefs = R.quantised_blocks(image)
    stream = R.encode(coefs, 96, 64, ri)
    got = R.decode_coefficients(stream, 96, 64, ri, None)
    assert all(np.array_equal(a, b) for a, b in zip(got, coefs))


def test_an_independent_decoder_reads_the_streams(image):
    Image = pytest.importorskip("PIL.Image")
    coefs = R.quantised_blocks(image)
    for ri in (0, 2):
        px = np.asarray(Image.open(io.BytesIO(R.encode(coefs, 96, 64, ri)))
                        .convert("RGB")).astype(int)
        assert px.shape == (64, 96, 3)
        # PIL's integer IDCT and smooth upsampling differ from the
        # reference's; a wrong stream would differ by far more
        assert np.abs(px - R.pixels(coefs, 64, 96).astype(int)).mean() < 4


@pytest.mark.parametrize("cut", ["header", "data", "marker"])
def test_broken_streams_are_refused(image, cut):
    stream = R.encode(R.quantised_blocks(image), 96, 64, 2)
    if cut == "header":
        stream = stream.replace(b"\xff\xdd\x00\x04\x00\x02",
                                b"\xff\xdd\x00\x04\x00\x03")
    elif cut == "data":
        stream = stream[:len(stream) // 2] + stream[-2:]
    else:
        i = stream.index(b"\xff\xd1")
        stream = stream[:i] + b"\xff\xd3" + stream[i + 2:]
    with pytest.raises(R.StreamError):
        R.decode_coefficients(stream, 96, 64, 2, None)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = np.array([1 + 2 ** -10, 1 + 2 ** -11, 1 + 2 ** -12, -3.0],
                 np.float32)
    assert R.tf32(x).tolist() == [1 + 2 ** -10, 1 + 2 ** -10, 1.0, -3.0]


def test_the_basis_is_exact_where_the_sums_are_rational():
    # frequencies 0 and 4 have basis entries +-1/8 (x) +-1/8: the sums of
    # integer samples are exact multiples of 1/64 and must truncate so
    flat = np.full((1, 64), -37)
    assert R.fdct_quantize(flat, np.ones(64, np.int64))[0, 0] == -37 * 8


def test_image_sets_repeat_by_seed_and_share_their_detail():
    a = I.image_set(4, 32, 48, 2 ** 40 + 3, 40, 220)
    assert np.array_equal(a, I.image_set(4, 32, 48, 2 ** 40 + 3, 40, 220))
    assert not np.array_equal(a, I.image_set(4, 32, 48, 2 ** 40 + 4, 40, 220))
