"""Megapixels whose RGB pixels came back decoded in the window, over
the window (first batch handed in to last result yielded)."""


def read(run):
    if run.direction != "decode":
        return None
    return run.answered * run.pixels_per_image / 1e6 / run.window.seconds
