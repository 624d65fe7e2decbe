"""Hot-path markers.

``@hot_path`` declares a function to be on the per-batch critical path
(dispatch, egress).  The marker is inert at runtime (one attribute write
at import); it names the functions where per-batch allocations matter,
as the reference package's static-analysis pass reads it.

This module stays dependency-free (stdlib only): the hottest modules of
the package import it.
"""

from __future__ import annotations

HOT_PATH_ATTR = "__sw_hot_path__"


def hot_path(fn):
    """Mark ``fn`` as per-batch hot-path code (see module docstring)."""
    setattr(fn, HOT_PATH_ATTR, True)
    return fn


def is_hot_path(fn) -> bool:
    return bool(getattr(fn, HOT_PATH_ATTR, False))


__all__ = ["hot_path", "is_hot_path", "HOT_PATH_ATTR"]
