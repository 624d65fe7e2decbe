"""Egress (the dispatcher's egress of a plan, on its worker or inline,
with the re-injection of derived alerts): host ms a plan's egress takes,
from the program's timer ``pipeline.stage_egress_s`` over the window."""


def read(ctx):
    (t0, c0) = ctx["program"]["start"]["timers"]["pipeline.stage_egress_s"]
    (t1, c1) = ctx["program"]["end"]["timers"]["pipeline.stage_egress_s"]
    return (t1 - t0) / (c1 - c0) * 1e3 if c1 > c0 else None
