"""Whether what the timed path produced is correct, by the plain reference.

The answers of the batches the window kept for the judge (a sample drawn
from the seed) are judged once the window has closed; every batch of the
window is counted, and an answer that never came fails.

- encode: each distinct stream is parsed and Huffman-decoded by the
  reference; its header must state the configuration's size, 4:2:0, tables
  and restart interval.  The reference codes the stream's own coefficients
  again, and everything from the end of the SOS header to EOI (entropy
  segments, padding, RSTn markers, EOI) must equal that byte for byte:
  entropy coding is lossless, so any fault there shows.  The coefficients
  are then compared with the reference's own from the image, which leaves
  the tolerance to the forward DCT alone: the share of them that differ,
  and for each that differs, how far the reference's DCT value lies from
  the values that quantise to the program's (a float32 transform differs
  from the float64 reference only where that value lies within its
  rounding error of a step of the quantiser).
- decode: the pixels are compared with the reference's decode of the same
  coefficients the input streams carry: the share of samples that differ,
  and the largest difference of a sample.  A float32 transform differs
  from the float64 reference only at ties of a rounding, by one in each of
  Y, Cb and Cr, which moves an RGB sample by at most 1 + 1.772 before its
  own rounding: 3.  A sample further off was decoded wrongly.

An answer fails where it never came, where the reference refuses it or it
has the wrong shape, where its entropy-coded data differs from the
reference's, or where a number passes the configuration's limit (`limits`
in configs/<config>.json, set from readings of sound runs and of the
control, `calibrate.py`).  The run prints `answers_failed` (limit 0) and
the worst answer's numbers beside their limits.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# per direction: the numbers compared with a limit of the configuration
LIMITED = {"encode": ("worst_coef_mismatch_share", "worst_coef_offset"),
           "decode": ("worst_pixel_mismatch_share", "worst_pixel_abs_diff")}
SHARE = {d: names[0] for d, names in LIMITED.items()}


@dataclasses.dataclass
class Verdict:
    attempted: int
    failed: int
    judged: int
    # name -> (value, limit); a check passes while value <= limit
    checks: dict
    entropy_bytes: dict  # decode: image index -> entropy bytes of its stream
    frame_bytes: int = 0  # encode: bytes of a stream outside its entropy data

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())


def _coef_numbers(got, dct, want, qs, ref):
    """The share of coefficients that differ from the reference's, and the
    largest distance of the reference's DCT value from the interval of
    values that quantise to the program's coefficient (0 where they
    agree)."""
    differ, offset = 0, 0.0
    for c, v, w, q in zip(got, dct, want, qs):
        bad = c != w
        differ += int(np.count_nonzero(bad))
        if bad.any():
            qq = np.broadcast_to(q, c.shape)[bad]
            lo, hi = ref.quantised_interval(c[bad], qq)
            x = v[bad]
            offset = max(offset, float(np.max(np.maximum(lo - x, x - hi))))
    return differ / sum(c.size for c in got), max(offset, 0.0)


def _judge_streams(cell, inputs, kept, ref, limits):
    """Encode: per judged answer, whether it fails; the worst numbers."""
    cfg = cell.config
    h, w = int(cfg["height"]), int(cfg["width"])
    n, b = int(cfg["images"]), int(cell.traffic["batch"])
    ri, q = int(cfg.get("restart_interval", 0)), cfg.get("quality")
    qs = ref.quant_tables(q)
    qs = (qs[0], qs[1], qs[1])
    truth, seen, fails = {}, {}, []
    worst = {"worst_coef_mismatch_share": 0.0, "worst_coef_offset": 0.0,
             "entropy_data_mismatches": 0}
    frame = 0
    for k, outs in kept:
        for i, stream in enumerate(outs[:b]):
            idx = (k * b + i) % n
            key = (idx, bytes(stream))
            if key in seen:
                fails.append(seen[key])
                continue
            if idx not in truth:
                v = ref.dct_blocks(inputs.rgb[idx])
                truth[idx] = (v, [ref.quantise(x, t) for x, t in zip(v, qs)])
            try:
                got = ref.decode_coefficients(stream, w, h, ri, q)
                data = ref.parse(stream)["data"]
                again = ref.encode(got, w, h, ri, q)
                same = stream[data:] == again[ref.parse(again)["data"]:]
            except Exception:  # noqa: BLE001 - any refusal fails the answer
                seen[key] = True
                fails.append(True)
                continue
            frame = frame or data + 2
            share, offset = _coef_numbers(got, *truth[idx], qs, ref)
            worst["worst_coef_mismatch_share"] = max(
                worst["worst_coef_mismatch_share"], share)
            worst["worst_coef_offset"] = max(worst["worst_coef_offset"],
                                             offset)
            worst["entropy_data_mismatches"] += int(not same)
            seen[key] = (not same
                         or share > limits["worst_coef_mismatch_share"]
                         or offset > limits["worst_coef_offset"])
            fails.append(seen[key])
    return fails, worst, frame


def _judge_pixels(cell, inputs, kept, ref, limits):
    """Decode: per judged answer, whether it fails; the worst numbers."""
    cfg = cell.config
    h, w = int(cfg["height"]), int(cfg["width"])
    n, b = int(cfg["images"]), int(cell.traffic["batch"])
    truth, fails = {}, []
    worst = {"worst_pixel_mismatch_share": 0.0,
             "worst_pixel_abs_diff": 0}
    for k, outs in kept:
        for i, px in enumerate(outs[:b]):
            idx = (k * b + i) % n
            px = np.asarray(px)
            if px.shape != (h, w, 3) or px.dtype != np.uint8:
                fails.append(True)
                continue
            if idx not in truth:
                truth[idx] = ref.pixels(inputs.coefs[idx], h, w,
                                        cfg.get("quality"))
            d = np.abs(px.astype(np.int16) - truth[idx].astype(np.int16))
            share = int(np.count_nonzero(d)) / d.size
            gap = int(d.max())
            worst["worst_pixel_mismatch_share"] = max(
                worst["worst_pixel_mismatch_share"], share)
            worst["worst_pixel_abs_diff"] = max(
                worst["worst_pixel_abs_diff"], gap)
            fails.append(share > limits["worst_pixel_mismatch_share"]
                         or gap > limits["worst_pixel_abs_diff"])
    return fails, worst, 0


def judge(cell, inputs, window, ref) -> Verdict:
    """Judge the kept answers of `window`; limits from the configuration."""
    direction = cell.traffic["direction"]
    limits = {name: float(cell.config["limits"][name])
              for name in LIMITED[direction]}
    judge_kept = _judge_streams if direction == "encode" else _judge_pixels
    fails, worst, frame = judge_kept(cell, inputs, window.kept, ref, limits)
    b = int(cell.traffic["batch"])
    attempted = b * len(window.batches)
    failed = attempted - sum(bt.answers for bt in window.batches) + sum(fails)
    checks = {"answers_failed": (failed, 0)}
    for name, limit in limits.items():
        checks[name] = (worst[name], limit)
    if direction == "encode":
        checks["entropy_data_mismatches"] = (
            worst["entropy_data_mismatches"], 0)
    ebytes = (dict(enumerate(inputs.entropy_bytes))
              if direction == "decode" else {})
    return Verdict(attempted=attempted, failed=failed, judged=len(fails),
                   checks=checks, entropy_bytes=ebytes, frame_bytes=frame)
