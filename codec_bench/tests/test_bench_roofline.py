"""The roofline's byte counts, the trace reader and the per-layer readers
on numbers worked out by hand."""
import pytest
from codec_bench.harness import peaks, spec, trace as T
from conftest import BENCH


def test_least_bytes_of_a_tiny_batch():
    # 2 images of 16x16: 4:2:0 samples 1.5 bytes a pixel, plus 100 and 60
    # entropy-coded bytes
    assert peaks.least_bytes(2 * 16 * 16, 160) == 2 * 256 * 1.5 + 160
    assert peaks.least_seconds(2 * 16 * 16, 160) == pytest.approx(
        928 / 3.35e12)


def _trace():
    # window 0..1000 us; a kernel 100..150, a copy 140..200 (overlapping),
    # a memset 900..910, an event outside the window, a CPU op ignored
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": T.WINDOW, "ts": 0,
         "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 100, "dur": 50},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 140,
         "dur": 60},
        {"ph": "X", "cat": "gpu_memset", "name": "set", "ts": 900, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 2000, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 10,
         "dur": 500},
    ]
    # host spans on the host's clock; the window began at host time 5.0
    spans = [("decode_batch_dispatch", 5.0 + 300e-6, 5.0 + 800e-6)]
    return T.read_trace({"traceEvents": ev}, spans, 5.0)


def test_read_trace():
    t = _trace()
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(110e-6)  # 100..200 and 900..910
    assert t.kernel_s == pytest.approx(50e-6)
    assert t.events == 3
    assert t.ops[0] == ["copy", pytest.approx(60e-6)]
    assert t.gaps[0] == ["decode_batch_dispatch", pytest.approx(700e-6)]
    assert t.gaps[1] == ["no wrapped call", pytest.approx(100e-6)]
    assert len(t.breakdown()["idle_gaps"]) == 3


class _Run:
    direction = "decode"
    pixels_per_image = 16 * 16
    answered = 2

    class window:
        batches = [object()]

    def entropy_bytes(self):
        return 160


def test_device_readers():
    run = _Run()
    run.device = _trace()
    read = lambda n: spec.metric_reader(n, BENCH)(run)  # noqa: E731
    assert read("decode_roofline_pct") == pytest.approx(
        100 * (928 / 3.35e12) / 50e-6)
    assert read("decode_device_ms") == pytest.approx(50e-3)
    assert read("device_idle_pct.decode") == pytest.approx(89.0)
    assert read("encode_roofline_pct") is None
    # one reader, metrics/device_idle_pct.py, serves both parts
    assert read("device_idle_pct.encode") == pytest.approx(89.0)
    run.device = None
    assert read("decode_roofline_pct") is None
    assert read("device_idle_pct.decode") is None


@pytest.mark.parametrize("direction", ["encode", "decode"])
def test_batch_p95_is_the_nearest_rank(direction):
    class R:
        def latencies_s(self):
            return [i / 1000 for i in range(1, 101)]  # 1..100 ms
    R.direction = direction
    read = lambda n: spec.metric_reader(n, BENCH)(R())  # noqa: E731
    assert read("batch_p95_ms") == pytest.approx(95.0)
