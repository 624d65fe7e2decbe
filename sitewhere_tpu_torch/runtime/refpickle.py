"""Pickles that read the same in the port and in the reference.

The checkpoint's pickled sections (``stores``, ``analytics``) hold host
records: rule, entity and query-spec dataclasses and the enums they
carry.  The reference pickles them under its own module names in
``sitewhere_tpu``.  Each port class that such a section holds names the
reference's ``(module, qualname)`` in a ``_PICKLE_AS`` class attribute,
and the caller passes the classes of its section:

- :func:`dumps` writes each such class under the reference's name,
  without importing the reference, so the reference unpickles a port
  section into its own classes (the C pickler, started from a memo that
  holds those classes);
- :func:`loads` maps exactly those reference names onto the port's
  classes and refuses every other ``sitewhere_tpu`` global, so restoring
  a reference section imports nothing of the reference (or of JAX).
"""

from __future__ import annotations

import io
import pickle
from typing import Dict, Iterable, Tuple

Names = Dict[Tuple[str, str], type]
PROTOCOL = 4


def reference_names(classes: Iterable[type]) -> Names:
    """The reference's ``(module, qualname)`` -> the port's class."""
    return {cls._PICKLE_AS: cls for cls in classes}


class _Unpickler(pickle.Unpickler):
    def __init__(self, file, names: Names):
        super().__init__(file)
        self._names = names

    def find_class(self, module, name):
        if module == "sitewhere_tpu" or module.startswith("sitewhere_tpu."):
            cls = self._names.get((module, name))
            if cls is None:
                raise pickle.UnpicklingError(
                    f"refusing the reference global {module}.{name}")
            return cls
        return super().find_class(module, name)


def dumps(obj, names: Names) -> bytes:
    """Pickle ``obj`` with the C pickler.  The stream opens by loading
    every class of ``names`` under its reference name (a ``GLOBAL``, kept
    in the memo and popped); the pickler starts from that memo, so each
    instance refers to its class by memo index and the pickler never
    looks the class up by its own module."""
    buf = io.BytesIO()
    buf.write(pickle.PROTO + bytes([PROTOCOL]))
    memo = {}
    for index, ((module, qualname), cls) in enumerate(names.items()):
        buf.write(pickle.GLOBAL + f"{module}\n{qualname}\n".encode())
        buf.write(pickle.LONG_BINPUT + index.to_bytes(4, "little"))
        buf.write(pickle.POP)
        memo[id(cls)] = (index, cls)
    pickler = pickle.Pickler(buf, protocol=PROTOCOL)
    pickler.memo = memo
    pickler.dump(obj)
    return buf.getvalue()


def loads(payload: bytes, names: Names):
    return _Unpickler(io.BytesIO(payload), names).load()


__all__ = ["Names", "dumps", "loads", "reference_names"]
