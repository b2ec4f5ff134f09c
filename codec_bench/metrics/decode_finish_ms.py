"""Mean host time of torch_codec.decode_batch_finish a batch of the
window (wrapped spans of the traced run)."""


def read(run):
    if run.spans is None or run.direction != "decode":
        return None
    d = run.spans.durations("decode_batch_finish")
    return 1e3 * sum(d) / len(d) if d else None
