"""Mean host time of torch_codec.encode_batch_dispatch a batch of the
window (wrapped spans of the traced run)."""


def read(run):
    if run.spans is None or run.direction != "encode":
        return None
    d = run.spans.durations("encode_batch_dispatch")
    return 1e3 * sum(d) / len(d) if d else None
