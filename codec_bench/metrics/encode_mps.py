"""Megapixels whose complete JFIF streams came back in the window, over
the window (first batch handed in to last result yielded)."""


def read(run):
    if run.direction != "encode":
        return None
    return run.answered * run.pixels_per_image / 1e6 / run.window.seconds
