"""Packed step (``pipeline/packed.py``, ``pipeline/step.py``,
``ops/scatter.py``): the card's kernel and copy time per step, from the
profiler's trace of the traced sub-window, over the steps launched in it."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["steps"] <= 0:
        return None
    return (tr["kernel_s"] + tr["copy_s"]) / tr["steps"] * 1e3
