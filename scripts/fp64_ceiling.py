"""The float64 rate an H100 sustains outside the tensor cores as separate
DMUL/DADD, read at a chosen occupancy and operand form
(scripts/fp64_ceiling.cu: FORMS), with the SM clock nvidia-smi reports
while it runs.  chip_smoke.py phase 6 prints
it beside the data sheet's 16.75e12 a second, the rate of the exact
kernels' bound; and the float32 rate of separate FMUL/FADD (FORMS32,
rate(..., fp32=True)), beside 33.5e12 a second, the rate of the fast rgb
IDCT's bound.
Raises without a card."""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time

import torch

from jpezy_tpu_torch.ops.cuda_build import KernelLibrary


# the chains' forms, in jz_fp64_chains' order
FORMS = ("x m + c, one register operand each",
         "x m + y, the add's two operands in registers",
         "x y + y, both operations two register operands")
# the float32 chains' forms, in jz_fp32_chains' order
FORMS32 = ("float32 x m + y",
           "float32 one product into four adds (the rgb IDCT's step)")


def _bind(lib) -> None:
    lib.jz_fp64_chains.restype = ctypes.c_int
    for fn in (lib.jz_fp64_chains, lib.jz_fp32_chains):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


LIB = KernelLibrary("fp64_ceiling.cu", _bind,
                    directory=os.path.dirname(os.path.abspath(__file__)))


def sm_clock_mhz() -> str:
    """clocks.sm as nvidia-smi reports it now (e.g. '1980 MHz')."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def clock_while(enqueue, seconds: float) -> str:
    """The SM clock read halfway through `seconds` of work that
    enqueue(seconds) puts on the current stream (read from another thread:
    the enqueue may block on a full launch queue); waits for the work."""
    got = {}

    def read():
        time.sleep(seconds / 2)
        got["clock"] = sm_clock_mhz()

    reader = threading.Thread(target=read)
    reader.start()
    try:
        enqueue(seconds)
        torch.cuda.synchronize()
    finally:
        reader.join()
    return got["clock"]


def rate(blocks_per_sm: int, form: int = 0, seconds: float = 1.0,
         fp32: bool = False) -> tuple[float, str]:
    """(float64 operations a second, SM clock during the run) of the chains
    of FORMS[form] (with fp32, float32 operations of FORMS32[form]) at
    blocks_per_sm thread blocks of 256 threads an SM, over about `seconds`
    of launches timed with CUDA events."""
    lib = LIB.get()
    out = torch.zeros(1, dtype=torch.float64, device="cuda")
    ops = ctypes.c_longlong(0)
    stream = torch.cuda.current_stream().cuda_stream
    chains = lib.jz_fp32_chains if fp32 else lib.jz_fp64_chains

    def launch(iters: int) -> int:
        LIB.raise_on("fp_chains", chains(
            form, blocks_per_sm, iters, out.data_ptr(), ctypes.byref(ops),
            stream))
        return ops.value

    # size a launch to about 50 ms from a short one
    launch(1000)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    launch(20000)
    end.record()
    torch.cuda.synchronize()
    iters = max(1000, int(20000 * 50 / max(start.elapsed_time(end), 1e-3)))
    total = [0]

    def enqueue(secs):
        start.record()
        for _ in range(max(1, int(secs / 0.05))):
            total[0] += launch(iters)
        end.record()

    clock = clock_while(enqueue, seconds)
    return total[0] / (start.elapsed_time(end) / 1e3), clock
