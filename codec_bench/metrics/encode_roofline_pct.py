"""The encode device program's share of its roofline: its least time (the
4:2:0 samples at 1.5 bytes a pixel and the entropy-coded bytes, each once,
at the card's peak bandwidth) over its kernel time, for the window."""
from codec_bench.harness import peaks


def read(run):
    if run.device is None or run.direction != "encode" or not run.device.kernel_s:
        return None
    least = peaks.least_seconds(run.answered * run.pixels_per_image,
                                run.entropy_bytes())
    return 100.0 * least / run.device.kernel_s
