"""Dispatcher (its ring and in-flight window): the 99th percentile over
every plan of the window of the time from the hand-over of its oldest
row's batch (a derived alert's source row counts) to the plan's arrival
at the sink, by the host's clock.  A per-layer metric with no bound: the
cells are closed loops at saturation, where a tail swings with the
queue's depth.  There the loop keeps a bounded number of plans
outstanding, so events/s is that number of rows over the mean latency:
a plan's time through the pipeline moves the throughput."""

import numpy as np


def read(ctx):
    lat = ctx["latency_s"]
    return float(np.percentile(lat, 99)) * 1e3 if len(lat) else None
