"""Host-edge identity: string tokens -> dense int32 handles.

Counterpart of ``sitewhere_tpu/ids.py``, carried as far as the state
manager, the batcher and the wire decode need it: the ``NULL_ID``
sentinel, :class:`HandleSpace` (mint / free / lookup / bulk lookup /
reverse lookup / in-place restore, and the ``TokenTable`` mirror the
native resolved scanners read) and :class:`IdentityMap` with its
checkpoint serialization (:meth:`IdentityMap.save` /
:meth:`IdentityMap.load_into`), which writes the reference's JSON.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Iterable, List, Optional

NULL_ID = -1


def _tt_set(table, token: str, hid: int) -> None:
    """Mirror one mapping into a C ``TokenTable``, skipping tokens that
    are not UTF-8-encodable (lone surrogates): the C scanner only accepts
    strict UTF-8 payload bytes, so such a token can never match there."""
    try:
        table.set(token, hid)
    except UnicodeEncodeError:
        pass


def _tt_discard(table, token: str) -> None:
    try:
        table.discard(token)
    except UnicodeEncodeError:
        pass


class HandleSpace:
    """Mints dense int32 handles for one namespace of string tokens.

    Thread-safe: mutators hold ``_lock``; lookups read the dict."""

    def __init__(self, name: str, capacity: int = 1 << 22):
        self.name = name
        self.capacity = capacity
        self._lock = threading.Lock()
        self._token_to_id: Dict[str, int] = {}
        self._id_to_token: List[Optional[str]] = []
        self._free: List[int] = []
        # C-side mirror for the resolved wire scanners (built lazily by
        # native_table(); every mutator keeps it in sync under _lock)
        self._native = None

    def __len__(self) -> int:
        return len(self._token_to_id)

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
            return self._mint_locked(token)

    def _mint_locked(self, token: str) -> int:
        if self._free:
            hid = self._free.pop()
            self._id_to_token[hid] = token
        else:
            hid = len(self._id_to_token)
            if hid >= self.capacity:
                raise RuntimeError(
                    f"HandleSpace '{self.name}' exhausted at {self.capacity}")
            self._id_to_token.append(token)
        self._token_to_id[token] = hid
        if self._native is not None:
            _tt_set(self._native, token, hid)
        return hid

    def free(self, token: str) -> None:
        """Release a handle for reuse (e.g. device deleted)."""
        with self._lock:
            hid = self._token_to_id.pop(token, NULL_ID)
            if hid != NULL_ID:
                self._id_to_token[hid] = None
                self._free.append(hid)
                if self._native is not None:
                    _tt_discard(self._native, token)

    def native_table(self):
        """The C-side token -> handle mirror the resolved wire scanners
        read, built on first use from the current map; after that every
        mint, free and restore keeps it in sync, so the scanners' lookups
        match :meth:`lookup` exactly.  Raises if the scanner library
        cannot be built."""
        if self._native is not None:
            return self._native
        from sitewhere_tpu_torch.native import load_swwire

        mod = load_swwire()
        with self._lock:
            if self._native is None:
                self._native = self._filled_table(mod)
        return self._native

    def _filled_table(self, mod):
        table = mod.TokenTable()
        for token, hid in self._token_to_id.items():
            _tt_set(table, token, hid)
        return table

    def token_of(self, hid: int) -> Optional[str]:
        """Reverse lookup (host side only)."""
        if 0 <= hid < len(self._id_to_token):
            return self._id_to_token[hid]
        return None

    def tokens(self) -> List[str]:
        return list(self._token_to_id)

    # -- serialization (checkpoint / restore) -------------------------------

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "capacity": self.capacity,
                "id_to_token": list(self._id_to_token),
            }

    @classmethod
    def from_dict(cls, data: dict) -> "HandleSpace":
        space = cls(data["name"], data["capacity"])
        space.load_state(data["id_to_token"])
        return space

    def load_state(self, id_to_token) -> None:
        """Restore IN PLACE from a handle-ordered token list (``None`` =
        a freed handle): components hold bound ``lookup``/``mint`` methods,
        so a restore mutates this space, never swaps the object.  A built
        mirror is replaced by a fully populated new table, so a concurrent
        resolved decode sees the complete old or the complete new map."""
        with self._lock:
            self._id_to_token = list(id_to_token)
            self._token_to_id = {
                t: hid for hid, t in enumerate(self._id_to_token)
                if t is not None
            }
            self._free = [hid for hid, t in enumerate(self._id_to_token)
                          if t is None]
            if self._native is not None:
                from sitewhere_tpu_torch.native import load_swwire

                self._native = self._filled_table(load_swwire())


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

    def save(self, path: str) -> None:
        """Write every space as JSON, durably and atomically: fsync'd
        before the rename, so a checkpoint manifest written after it
        never points at identity data still in the page cache."""
        payload = {name: space.to_dict() for name, space in self.spaces.items()}
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def load_into(self, path: str) -> None:
        """Restore every space IN PLACE (see :meth:`HandleSpace.load_state`):
        components hold the spaces' bound methods."""
        with open(path) as f:
            payload = json.load(f)
        for name, data in payload.items():
            space = self.spaces.get(name)
            if space is None:
                self.spaces[name] = HandleSpace.from_dict(data)
            else:
                space.capacity = data["capacity"]
                space.load_state(data["id_to_token"])
