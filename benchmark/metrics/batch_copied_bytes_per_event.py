"""Batcher: bytes the batcher copies per row handed in over the window
(the program's ``Batcher.copied_bytes``: intake copies and emission)."""


def read(ctx):
    d = (ctx["program"]["end"]["copied_bytes"]
         - ctx["program"]["start"]["copied_bytes"])
    return d / ctx["rows"] if ctx["rows"] else None
