"""Share of the profiled window in which no kernel, copy or memset ran on
the card; one reader for `device_idle_pct.encode` and `.decode`, which
each cell of that direction reports."""


def read(run):
    if run.device is None or not run.device.events:
        return None
    return 100.0 * (1.0 - run.device.busy_s / run.device.window_s)
