"""Kernel time of the encode device program a batch: the kernels' summed
time in the profiled window over the batches of the window."""


def read(run):
    if run.device is None or run.direction != "encode" or not run.device.kernel_s:
        return None
    return 1e3 * run.device.kernel_s / len(run.window.batches)
