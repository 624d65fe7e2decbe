"""Dispatcher (``runtime/dispatcher.py``: staging, host-to-device copies,
launches): host ms a step, from the program's timers
``pipeline.stage_h2d_s``, ``pipeline.stage_dispatch_s`` and
``pipeline.stage_ring_dispatch_s`` over the window's steps."""

TIMERS = ("pipeline.stage_h2d_s", "pipeline.stage_dispatch_s",
          "pipeline.stage_ring_dispatch_s")


def read(ctx):
    start, end = ctx["program"]["start"], ctx["program"]["end"]
    steps = end["steps"] - start["steps"]
    total = sum(end["timers"][t][0] - start["timers"][t][0] for t in TIMERS)
    return total / steps * 1e3 if steps > 0 else None
