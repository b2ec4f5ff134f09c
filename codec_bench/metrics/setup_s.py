"""Process start to the first batch of the window, host clock."""


def read(run):
    return run.setup_s
