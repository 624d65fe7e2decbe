"""The ``analytics`` checkpoint section's payload, readable by both packages.

The reference pickles its query specs (``WindowQuery``, ``SessionQuery``,
``PatternQuery`` and ``PatternStep``) under their module names in
``sitewhere_tpu.analytics``.  The port's spec classes name those same
globals in a ``_PICKLE_AS`` class attribute:

- :func:`dumps` writes each such class under the reference's module and
  class name, without importing the reference, so the reference's
  ``restore_state`` unpickles a port section into its own classes;
- :func:`loads` maps exactly those reference names onto the port's
  classes and refuses every other ``sitewhere_tpu`` global, so restoring
  a reference section imports nothing of the reference (or of JAX).
"""

from __future__ import annotations

import io
import pickle

from sitewhere_tpu_torch.analytics.cep import PatternStep
from sitewhere_tpu_torch.analytics.query import (
    PatternQuery,
    SessionQuery,
    WindowQuery,
)

_CLASSES = (WindowQuery, SessionQuery, PatternQuery, PatternStep)
#: the reference's (module, name) -> the port's class
REFERENCE_NAMES = {cls._PICKLE_AS: cls for cls in _CLASSES}


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, whose ``save_global`` can be overridden
    (the C pickler imports a global's module to check it)."""

    def save_global(self, obj, name=None):
        ref = getattr(obj, "_PICKLE_AS", None) if isinstance(obj, type) \
            else None
        if ref is None or REFERENCE_NAMES.get(ref) is not obj:
            return super().save_global(obj, name)
        module, qualname = ref
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "sitewhere_tpu" or module.startswith("sitewhere_tpu."):
            cls = REFERENCE_NAMES.get((module, name))
            if cls is None:
                raise pickle.UnpicklingError(
                    f"refusing the reference global {module}.{name}")
            return cls
        return super().find_class(module, name)


def dumps(obj) -> bytes:
    buf = io.BytesIO()
    _Pickler(buf, protocol=4).dump(obj)
    return buf.getvalue()


def loads(payload: bytes):
    return _Unpickler(io.BytesIO(payload)).load()


__all__ = ["REFERENCE_NAMES", "dumps", "loads"]
