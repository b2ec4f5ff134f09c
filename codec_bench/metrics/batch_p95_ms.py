"""95th percentile (nearest rank) over every batch of the window of the
time from handing the batch to the pipeline to its result's yield: the
stall a loader or transcoder that consumes the pipeline sees.  The run
prints the count of batches and their median beside it."""
import math


def read(run):
    lat = sorted(run.latencies_s())
    if not lat:
        return None
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1]
