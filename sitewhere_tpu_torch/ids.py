"""Host-edge identity: string tokens -> dense int32 handles.

Counterpart of ``sitewhere_tpu/ids.py``, carried as far as the state
manager, the batcher and the columnar decode need it: the ``NULL_ID``
sentinel, :class:`HandleSpace` (mint / lookup / bulk lookup / reverse
lookup) and :class:`IdentityMap`.  Freeing handles, the native
wire-scanner mirror and checkpoint serialization wait for the slices
that port the services, the native wire tier and checkpoints.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional

NULL_ID = -1


class HandleSpace:
    """Mints dense int32 handles for one namespace of string tokens."""

    def __init__(self, name: str, capacity: int = 1 << 22):
        self.name = name
        self.capacity = capacity
        self._lock = threading.Lock()
        self._token_to_id: Dict[str, int] = {}
        self._id_to_token: List[Optional[str]] = []

    def lookup(self, token: str) -> int:
        """The handle for ``token``, or ``NULL_ID`` if unknown."""
        return self._token_to_id.get(token, NULL_ID)

    def lookup_many(self, tokens: Iterable[str]) -> List[int]:
        """:meth:`lookup` over many tokens in one comprehension."""
        get = self._token_to_id.get
        return [get(t, NULL_ID) for t in tokens]

    def mint(self, token: str) -> int:
        """The handle for ``token``, minting a new one if needed."""
        with self._lock:
            hid = self._token_to_id.get(token, NULL_ID)
            if hid != NULL_ID:
                return hid
            hid = len(self._id_to_token)
            if hid >= self.capacity:
                raise RuntimeError(
                    f"HandleSpace '{self.name}' exhausted at {self.capacity}")
            self._id_to_token.append(token)
            self._token_to_id[token] = hid
            return hid

    def token_of(self, hid: int) -> Optional[str]:
        """Reverse lookup (host side only)."""
        if 0 <= hid < len(self._id_to_token):
            return self._id_to_token[hid]
        return None


class IdentityMap:
    """The handle namespaces, one per id column of :mod:`.schema`."""

    SPACES = (
        "device", "assignment", "device_type", "area", "customer", "asset",
        "tenant", "mtype", "alert_type", "command", "invocation", "zone",
        "user", "area_type", "customer_type", "device_group", "schedule",
        "batch_operation",
    )

    def __init__(self, capacity: int = 1 << 22):
        self.spaces: Dict[str, HandleSpace] = {
            name: HandleSpace(name, capacity) for name in self.SPACES
        }

    def __getattr__(self, name: str) -> HandleSpace:
        try:
            return self.__dict__["spaces"][name]
        except KeyError:
            raise AttributeError(name) from None
