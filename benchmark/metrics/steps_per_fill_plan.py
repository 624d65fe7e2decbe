"""Ring (``runtime/ring.py``, the dispatcher's ring): packed steps the
card ran per full-width batch handed in over the window (one fill plan a
batch; the derived alerts' partial plans add the rest)."""


def read(ctx):
    steps = ctx["program"]["end"]["steps"] - ctx["program"]["start"]["steps"]
    return steps / ctx["batches"] if ctx["batches"] else None
