"""The ``analytics`` checkpoint section's payload, readable by both packages.

The reference pickles its query specs (``WindowQuery``, ``SessionQuery``,
``PatternQuery`` and ``PatternStep``) under their module names in
``sitewhere_tpu.analytics``.  The port's spec classes name those same
globals in ``_PICKLE_AS``, and :mod:`sitewhere_tpu_torch.runtime.refpickle`
writes and reads them under those names (the checkpoint's ``stores``
section goes through the same pickler).
"""

from __future__ import annotations

from sitewhere_tpu_torch.analytics.cep import PatternStep
from sitewhere_tpu_torch.analytics.query import (
    PatternQuery,
    SessionQuery,
    WindowQuery,
)
from sitewhere_tpu_torch.runtime import refpickle

#: the reference's (module, name) -> the port's class
REFERENCE_NAMES = refpickle.reference_names(
    (WindowQuery, SessionQuery, PatternQuery, PatternStep))


def dumps(obj) -> bytes:
    return refpickle.dumps(obj, REFERENCE_NAMES)


def loads(payload: bytes):
    return refpickle.loads(payload, REFERENCE_NAMES)


__all__ = ["REFERENCE_NAMES", "dumps", "loads"]
