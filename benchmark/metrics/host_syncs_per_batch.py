"""Ring: blocking device-to-host waits per step over the window, from the
program's counter ``pipeline.host_syncs`` (1/K when every ring forms)."""


def read(ctx):
    start, end = ctx["program"]["start"], ctx["program"]["end"]
    steps = end["steps"] - start["steps"]
    syncs = (end["counters"]["pipeline.host_syncs"]
             - start["counters"]["pipeline.host_syncs"])
    return syncs / steps if steps > 0 else None
