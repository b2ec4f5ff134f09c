"""The judge itself: a run with the timed path broken underneath comes out
not correct, once for each fault a one-chip codec cell can have; the
control (the reference at TF32 in the program's place) comes out not
correct at the cell's own size."""
import os

import numpy as np
import pytest
from codec_bench.harness import faults as F
from codec_bench.harness import judge as J
from codec_bench.harness import spec, workload as W
from conftest import BENCH, run_cell


@pytest.mark.parametrize("fault", F.FAULTS)
@pytest.mark.parametrize("workload", ["tiny.encode", "tiny_ri2.encode",
                                      "tiny.decode", "tiny_ri2.decode"])
def test_a_broken_timed_path_is_not_correct(checkout, workload, fault):
    from jpezy_tpu_torch.codec import torch_codec

    undo = F.plant(torch_codec, workload.split(".")[1], fault)
    try:
        result, lines = run_cell(checkout, workload, seconds=0.3)
    finally:
        undo()
    assert result["correct"] is False, lines


@pytest.mark.parametrize("workload", ["tiny.encode", "tiny_ri2.decode"])
def test_a_sound_run_is_correct(checkout, workload):
    result, lines = run_cell(checkout, workload, seconds=0.3)
    assert result["correct"] is True, lines


@pytest.mark.parametrize("workload", ["kodak.encode", "serve512.encode",
                                      "kodak.decode", "serve512.decode"])
def test_the_control_is_not_correct(checkout, workload):
    cell = spec.load_cell(workload, checkout, os.path.join(checkout,
                                                           "codec_bench"))
    cell.config["images"] = 6  # of the cell's own size; fewer of them
    ref = spec.reference(cell.config, BENCH)
    inputs = W.prepare(cell, 5_100_000_001, ref)
    v = J.judge(cell, inputs, F.control_window(cell, inputs, ref), ref)
    assert not v.correct
    worst, limit = v.checks[J.SHARE[cell.traffic["direction"]]]
    assert worst > limit
    sound = J.judge(cell, inputs, F.control_window(cell, inputs, ref,
                                                    "float64"), ref)
    assert sound.correct and sound.checks[
        J.SHARE[cell.traffic["direction"]]][0] == 0.0


@pytest.mark.parametrize("workload", ["serve512.encode", "kodak.decode"])
def test_one_small_fault_is_not_correct(checkout, workload):
    """One answer a little wrong among sound ones: an encode stream with
    one coefficient off by 2 (one of 393,216), or a decode answer with one
    wrongly decoded block (a few hundred samples)."""
    cell = spec.load_cell(workload, checkout, os.path.join(checkout,
                                                           "codec_bench"))
    cell.config["images"] = 6
    ref = spec.reference(cell.config, BENCH)
    inputs = W.prepare(cell, 5_100_000_002, ref)
    win = F.control_window(cell, inputs, ref, "float64")
    k, outs = win.kept[0]
    if cell.traffic["direction"] == "encode":
        # one AC coefficient of one block coded 2 higher: a valid stream
        # whose entropy data the reference codes the same way again
        cfg = cell.config
        idx = (k * int(cell.traffic["batch"])) % int(cfg["images"])
        coefs = [c.copy() for c in ref.quantised_blocks(inputs.rgb[idx])]
        coefs[0][100, 9] += 2
        outs = [ref.encode(coefs, int(cfg["width"]), int(cfg["height"]),
                           int(cfg["restart_interval"]))] + list(outs[1:])
    else:
        outs = outs.copy()
        outs[0, 64:72, 64:72] = np.clip(outs[0, 64:72, 64:72].astype(int)
                                        + 9, 0, 255)
    win.kept[0] = (k, outs)
    v = J.judge(cell, inputs, win, ref)
    assert not v.correct and v.failed >= 1, v.checks
