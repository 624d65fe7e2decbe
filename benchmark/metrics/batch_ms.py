"""Batcher (``ingest/batcher.py``): host ms the batcher's intake takes a
plan, from the program's timer ``pipeline.stage_batch_s`` over the window."""


def read(ctx):
    (t0, c0) = ctx["program"]["start"]["timers"]["pipeline.stage_batch_s"]
    (t1, c1) = ctx["program"]["end"]["timers"]["pipeline.stage_batch_s"]
    return (t1 - t0) / (c1 - c0) * 1e3 if c1 > c0 else None
