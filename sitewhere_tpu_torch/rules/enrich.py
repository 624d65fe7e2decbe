"""Metadata-join enrichment tables: device and asset attributes on the card.

Counterpart of ``sitewhere_tpu/rules/enrich.py`` on one card.  Rule
programs join against operational metadata (firmware generation, site
class, maintenance flag, asset criticality) that lives outside the event
stream.  The attributes live in dense int32 tables, row-indexed by the
same dense ids the pipeline enriches with.

Columns are minted by name (``resolve()`` is the DSL's attribute-column
resolver) and bounded: the per-row gather cost in the prepare pass is
O(columns), so the ceiling is a schema decision, not a config knob.
Mutations are host-side writes to numpy columns under a lock;
:meth:`publish` snapshots them into an immutable :class:`AttrEpoch` of
device tensors the eval thread reads, uploading only a table whose
columns changed since the last publish.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.ids import NULL_ID
from sitewhere_tpu_torch.rules.dsl import RuleProgramError
from sitewhere_tpu_torch.schema import pow2_at_least

MAX_ATTR_COLUMNS = 8


@dataclass(frozen=True)
class AttrEpoch:
    """Published, immutable device tensors: ``[N, A]`` int32 each."""

    epoch: int
    device: torch.Tensor
    asset: torch.Tensor


class AttributeStore:
    """Named int32 attribute columns for devices and assets."""

    def __init__(self, device_capacity: int, asset_capacity: int = 1024,
                 max_columns: int = MAX_ATTR_COLUMNS,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.max_columns = int(max_columns)
        self._lock = threading.RLock()
        self._cols: Dict[str, Dict[str, int]] = {"device": {}, "asset": {}}
        self._host = {
            "device": np.full((pow2_at_least(device_capacity, 8),
                               self.max_columns), NULL_ID, np.int32),
            "asset": np.full((pow2_at_least(asset_capacity, 8),
                              self.max_columns), NULL_ID, np.int32),
        }
        self._dirty = {"device": True, "asset": True}
        self._epoch: Optional[AttrEpoch] = None
        self._epoch_id = 0

    def _table(self, table: str) -> np.ndarray:
        if table not in self._host:
            raise RuleProgramError(f"attr table must be one of "
                                   f"{sorted(self._host)}")
        return self._host[table]

    def resolve(self, table: str, name: str) -> int:
        """Mint (or look up) a column index: the DSL's attribute resolver,
        so registering a program defines its columns."""
        with self._lock:
            self._table(table)
            cols = self._cols[table]
            idx = cols.get(name)
            if idx is None:
                if len(cols) >= self.max_columns:
                    raise RuleProgramError(
                        f"{table} attribute column limit "
                        f"{self.max_columns} reached (columns: "
                        f"{sorted(cols)})")
                idx = len(cols)
                cols[name] = idx
            return idx

    def columns(self, table: str) -> Dict[str, int]:
        with self._lock:
            return dict(self._cols[table])

    def set(self, table: str, entity_id: int, column: str,
            value: int) -> None:
        """Set one attribute (NULL_ID clears: an unset attribute never
        matches a join predicate)."""
        with self._lock:
            host = self._table(table)
            eid = int(entity_id)
            if not (0 <= eid < host.shape[0]):
                raise RuleProgramError(
                    f"{table} id {eid} outside capacity {host.shape[0]}")
            host[eid, self.resolve(table, column)] = np.int32(value)
            self._dirty[table] = True

    def set_many(self, table: str, entity_ids, column: str,
                 values) -> None:
        with self._lock:
            host = self._table(table)
            col = self.resolve(table, column)
            ids = np.asarray(entity_ids, np.int64)
            if ids.size and (ids.min() < 0
                             or ids.max() >= host.shape[0]):
                raise RuleProgramError(
                    f"{table} ids outside capacity {host.shape[0]}")
            host[ids, col] = np.asarray(values, np.int32)
            self._dirty[table] = True

    def _upload(self, table: str) -> torch.Tensor:
        # a copy on the CPU too: the epoch never aliases the host columns
        return torch.from_numpy(self._host[table]).to(self.device, copy=True)

    def publish(self) -> AttrEpoch:
        """A fresh immutable epoch when a column changed, else the current
        one.  Only a changed table is uploaded; the other is shared with
        the previous epoch (readers of the outgoing epoch are unaffected)."""
        with self._lock:
            prev = self._epoch
            if prev is None or any(self._dirty.values()):
                tensors = {t: (self._upload(t)
                               if prev is None or self._dirty[t]
                               else getattr(prev, t))
                           for t in ("device", "asset")}
                self._epoch_id += 1
                self._epoch = AttrEpoch(epoch=self._epoch_id, **tensors)
                self._dirty = {t: False for t in self._dirty}
            return self._epoch

    # -- checkpoint plane ----------------------------------------------------

    def snapshot_payload(self) -> Tuple[dict, Dict[str, np.ndarray]]:
        """(column maps, host arrays), folded into the engine's checkpoint
        section beside the program registry."""
        with self._lock:
            return ({t: dict(c) for t, c in self._cols.items()},
                    {t: a.copy() for t, a in self._host.items()})

    def restore_payload(self, cols: dict, arrays: Dict[str, np.ndarray]
                        ) -> None:
        with self._lock:
            for table in self._host:
                self._cols[table] = {str(k): int(v) for k, v in
                                     (cols.get(table) or {}).items()}
                arr = arrays.get(table)
                if arr is not None:
                    host = self._host[table]
                    n = min(host.shape[0], arr.shape[0])
                    a = min(host.shape[1], arr.shape[1])
                    host.fill(NULL_ID)
                    host[:n, :a] = np.asarray(arr, np.int32)[:n, :a]
                self._dirty[table] = True


__all__ = ["AttributeStore", "AttrEpoch", "MAX_ATTR_COLUMNS"]
