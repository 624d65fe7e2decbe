"""DeviceStateManager: owner of the DeviceState epoch and its packed twin.

Counterpart of the epoch plumbing of ``sitewhere_tpu/state/manager.py``:
``current`` / ``current_packed``, the lease and commit of the packed
carry that the K-deep ring threads through its steps, the presence
reconciliation on commit (``_merge_presence`` :198), the presence sweep
with its tenant lookup, the single-device and summary queries, and the
checkpoint's host snapshot of the epoch (:meth:`snapshot_host`), and
the per-tenant partition views (:class:`TenantPartitions`, the
reference's :53, attached through :meth:`attach_partitions`).  The
migration import/export waits for the multi-host slice.

On a mesh (``mesh=``) the packed epoch is sharded by capacity: each
plane is a :class:`~sitewhere_tpu_torch.parallel.mesh.Sharded` with one
block per shard, and its shard count is the mesh's.  The step paths read
and commit it as is; the readers gather it (:attr:`current`, the tenant
views and the checkpoint's host snapshot) or loop over its shards (the
presence sweep, the single-device, missing, seen-since and summary
queries).  In the reference GSPMD does this implicitly.

Epochs are immutable: a commit or a sweep replaces the held tensors and
never writes into them, so a snapshot taken under the lock stays valid
after the lock is released.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.ids import NULL_ID, IdentityMap
from sitewhere_tpu_torch.parallel.mesh import SHARD_AXIS, P, Placement, Sharded
from sitewhere_tpu_torch.pipeline.packed import (
    PRESENCE_ROW,
    PackedState,
    pack_state,
    packed_presence_sweep,
    unpack_state,
)
from sitewhere_tpu_torch.schema import DeviceState, EventBatch
from sitewhere_tpu_torch.services.common import EntityNotFound, require
from sitewhere_tpu_torch.state.presence import presence_sweep, state_changes_for


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _take(a, idx: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(a)
    return t.index_select(0, idx.to(t.device))


@functools.lru_cache(maxsize=64)
def _partition_gather(rung: int):
    """The padded gather of one partition rung, shared by every tenant on
    that rung (padding rows gather device 0; the caller's ``valid``
    masks them).  The reference jits one gather per pow2 rung; here it is
    one ``index_select`` per field of a :class:`DeviceState` or a dict of
    columns."""
    del rung  # the cache key, as in the reference

    def gather(state, idx: torch.Tensor, valid: torch.Tensor):
        if isinstance(state, dict):
            rows = {k: _take(v, idx) for k, v in state.items()}
        else:
            rows = DeviceState(**{
                f.name: _take(getattr(state, f.name), idx)
                for f in dataclasses.fields(state)})
        return rows, valid

    return gather


class TenantPartitions:
    """Per-tenant pow2 capacity ladders over the shared state tensors.

    The global :class:`DeviceState` epoch is one fixed-capacity tensor
    set; tenant isolation at this layer means each tenant's query surface
    runs through its own padded partition view: a gather of the tenant's
    device rows padded to a pow2 rung.  Rungs ride a sticky ladder (grow
    to the next pow2 when the tenant's device count exceeds the rung,
    shrink only once the count falls to a quarter of it), so
    registration churn inside one tenant moves only THAT tenant's rung.
    ``compile_count`` counts a tenant's rung transitions, as the
    reference counts its per-rung compiles: churn in a noisy tenant
    leaves it flat for every other tenant.
    """

    def __init__(self, tenant_column_provider,
                 min_capacity: int = 64, metrics=None):
        self._provider = tenant_column_provider
        self.min_capacity = _next_pow2(max(1, int(min_capacity)))
        self._lock = threading.Lock()
        # tenant_id -> {"count", "rung", "compile_count"}
        self._parts: Dict[int, Dict[str, int]] = {}
        self._column: Optional[np.ndarray] = None
        self._m_tracked = None
        self._m_compiles = None
        self._m_resizes = None
        if metrics is not None:
            self.bind_metrics(metrics)

    def bind_metrics(self, metrics) -> None:
        self._m_tracked = metrics.gauge("tenant.partition.tracked")
        self._m_compiles = metrics.counter("tenant.partition.compiles")
        self._m_resizes = metrics.counter("tenant.partition.resizes")

    def refresh(self) -> None:
        """Re-derive per-tenant device counts from the registry mirror's
        tenant column and walk each tenant's rung ladder (an O(capacity)
        bincount, off the step path)."""
        col = np.asarray(self._provider())
        owned = col[col >= 0]
        counts = (np.bincount(owned) if owned.size
                  else np.zeros(0, np.int64))
        tenants = np.nonzero(counts)[0]
        with self._lock:
            self._column = col
            for t in tenants.tolist():
                count = int(counts[t])
                part = self._parts.get(t)
                if part is None:
                    self._parts[t] = {
                        "count": count,
                        "rung": max(self.min_capacity, _next_pow2(count)),
                        "compile_count": 1,
                    }
                    if self._m_compiles is not None:
                        self._m_compiles.inc()
                    continue
                part["count"] = count
                rung = part["rung"]
                if count > rung:
                    part["rung"] = _next_pow2(count)
                elif (count <= rung // 4
                      and rung > self.min_capacity):
                    # shrink-at-quarter hysteresis: a tenant oscillating
                    # around a rung boundary never flaps its view
                    part["rung"] = max(self.min_capacity,
                                       _next_pow2(count))
                if part["rung"] != rung:
                    part["compile_count"] += 1
                    if self._m_compiles is not None:
                        self._m_compiles.inc()
                    if self._m_resizes is not None:
                        self._m_resizes.inc()
            if self._m_tracked is not None:
                self._m_tracked.set(len(self._parts))

    def tenants(self) -> List[int]:
        with self._lock:
            return sorted(self._parts)

    def compile_count(self, tenant_id: int) -> int:
        with self._lock:
            part = self._parts.get(int(tenant_id))
            return 0 if part is None else part["compile_count"]

    def partition_of(self, tenant_id: int) -> Optional[Dict[str, int]]:
        with self._lock:
            part = self._parts.get(int(tenant_id))
            return None if part is None else dict(part)

    def indices_of(self, tenant_id: int):
        """``(idx, valid)`` for one tenant's partition view: the tenant's
        device ids padded to its rung (padding gathers row 0, masked out
        by ``valid``).  None if the tenant owns nothing."""
        with self._lock:
            part = self._parts.get(int(tenant_id))
            col = self._column
        if part is None or col is None:
            return None
        ids = np.nonzero(col == int(tenant_id))[0].astype(np.int32)
        rung = part["rung"]
        idx = np.zeros(rung, np.int32)
        valid = np.zeros(rung, bool)
        n = min(len(ids), rung)
        idx[:n] = ids[:n]
        valid[:n] = True
        return idx, valid

    def view(self, state: DeviceState, tenant_id: int):
        """Padded per-tenant gather of ``state``: ``(rows, valid)`` on
        the state's device."""
        iv = self.indices_of(tenant_id)
        if iv is None:
            return None
        idx, valid = iv
        first = (next(iter(state.values())) if isinstance(state, dict)
                 else state.last_event_type)
        dev = torch.as_tensor(first).device
        gather = _partition_gather(len(idx))
        return gather(state, torch.from_numpy(idx.astype(np.int64)).to(dev),
                      torch.from_numpy(valid).to(dev))

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "tenants": len(self._parts),
                "min_capacity": self.min_capacity,
                "partitions": {str(t): dict(p)
                               for t, p in sorted(self._parts.items())},
            }


def _merge_presence(new_si, cur_si, present_now):
    """Packed-form presence reconciliation: a concurrent sweep's missing
    flags survive unless the step merged an event for the device (shard
    by shard on a mesh)."""
    if isinstance(new_si, Sharded):
        return Sharded([_merge_presence(n, c, p) for n, c, p in zip(
            new_si.shards, cur_si.shards, present_now.shards)],
            new_si.placement)
    merged = (new_si[PRESENCE_ROW] != 0) | (
        (cur_si[PRESENCE_ROW] != 0) & ~present_now)
    out = new_si.clone()
    out[PRESENCE_ROW] = merged.to(new_si.dtype)
    return out


def _shards_of(ps: PackedState) -> List[PackedState]:
    """A mesh-placed packed epoch as one PackedState per shard."""
    return [ps.replace(si=si, sf=sf)
            for si, sf in zip(ps.si.shards, ps.sf.shards)]


def _gathered(ps: PackedState) -> PackedState:
    """A mesh-placed packed epoch gathered whole on shard 0's device."""
    return ps.replace(si=ps.si.gather(), sf=ps.sf.gather())


def _host_fields(packed: PackedState, si: torch.Tensor,
                 sf: torch.Tensor) -> Dict[str, np.ndarray]:
    """Split host copies of a packed carry into DeviceState fields."""
    host = unpack_state(packed.replace(si=si, sf=sf))
    return {f.name: np.ascontiguousarray(getattr(host, f.name).numpy())
            for f in dataclasses.fields(host)}


class DeviceStateManager:
    """Holds the authoritative :class:`DeviceState` epoch.

    Exactly one of the unpacked epoch and its packed twin may be stale
    (None); each is rebuilt from the other on demand.
    ``tenant_id_of_device`` maps device ids (an int32 numpy array) to
    their tenants for the presence STATE_CHANGE rows; the registry
    mirror's tenant column is the source of truth.  Without it those
    rows carry tenant 0.
    """

    def __init__(self, capacity: int, identity: Optional[IdentityMap] = None,
                 num_mtype_slots: int = 8,
                 tenant_id_of_device: Optional[
                     Callable[[np.ndarray], np.ndarray]] = None,
                 num_ewma_scales: int = 3,
                 device: DeviceLike = None, mesh=None):
        # on a mesh the epoch lies on its shards' devices; ``device`` is
        # shard 0's, where gathered readers and restores land
        self.mesh = mesh
        if mesh is not None and device is None:
            device = mesh.shard_devices[0]
        self.device = resolve_device(device)
        self.identity = identity if identity is not None else IdentityMap()
        self._tenant_id_of_device = tenant_id_of_device
        self._lock = threading.RLock()
        self._state: Optional[DeviceState] = DeviceState.empty(
            capacity, num_mtype_slots, num_ewma_scales, device=self.device)
        self._packed: Optional[PackedState] = None
        # the CUDA stream the held epoch was made or committed from (None
        # on the CPU): a host snapshot, a scan and a presence sweep run on
        # it, ordered after the work that produced the epoch
        self._stream = None
        self._note_stream()
        # count of lease_packed() calls: a failed chain is recovered by
        # leasing AGAIN from the still-held epoch, so "re-leased without
        # restart" is this count advancing on one live manager
        self.lease_generation = 0
        # tenant-partitioned query views (attach_partitions)
        self.partitions: Optional[TenantPartitions] = None

    def attach_partitions(self, tenant_column_provider,
                          min_capacity: int = 64,
                          metrics=None) -> TenantPartitions:
        """Wire the tenant-partition ladder (the instance passes the
        registry mirror's tenant column provider)."""
        self.partitions = TenantPartitions(
            tenant_column_provider, min_capacity=min_capacity,
            metrics=metrics)
        return self.partitions

    def tenant_state_summary(self, tenant_id: int) -> Dict[str, object]:
        """Per-tenant state summary through the tenant's partition view:
        the partitioned analog of :meth:`summary`."""
        require(self.partitions is not None,
                EntityNotFound("tenant partitions are not attached"))
        self.partitions.refresh()
        part = self.partitions.partition_of(tenant_id)
        if part is None:
            return {"devices": 0, "capacity": 0, "compile_count": 0,
                    "devices_with_state": 0, "devices_missing": 0}
        with self._lock:
            s = self.current
        # the gather and the counts run on the stream the epoch was
        # committed from, never on the calling thread's own
        with self._on_stream():
            view = self.partitions.view(s, tenant_id)
            if view is None:   # raced a refresh that dropped the column
                return {"devices": part["count"], "capacity": part["rung"],
                        "compile_count": part["compile_count"],
                        "devices_with_state": 0, "devices_missing": 0}
            rows, valid = view
            has = int(((rows.last_event_type != NULL_ID) & valid).sum())
            missing = int((rows.presence_missing & valid).sum())
        return {
            "devices": part["count"],
            "capacity": part["rung"],
            "compile_count": part["compile_count"],
            "devices_with_state": has,
            "devices_missing": missing,
        }

    def _on_stream(self):
        """The stream the epoch was made or committed from, as a context
        (a no-op on the CPU, where none is recorded)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _note_stream(self) -> None:
        if self.device.type == "cuda":
            self._stream = torch.cuda.current_stream(self.device)

    # -- epoch plumbing ----------------------------------------------------

    @property
    def current(self) -> DeviceState:
        """The unpacked epoch (on a mesh: gathered whole on shard 0's
        device, for the readers)."""
        with self._lock:
            if self._state is None:
                packed = self._packed
                if isinstance(packed.si, Sharded):
                    packed = _gathered(packed)
                self._state = unpack_state(packed)
            return self._state

    @property
    def current_packed(self) -> PackedState:
        """The packed epoch (packed lazily after an unpacked commit; on a
        mesh, placed by capacity over the shards)."""
        with self._lock:
            if self._packed is None:
                self._packed = self._placed(pack_state(self.current))
            return self._packed

    def _placed(self, packed: PackedState) -> PackedState:
        if self.mesh is None:
            return packed
        from sitewhere_tpu_torch.pipeline.sharded import place_packed_state

        placed = place_packed_state(self.mesh, packed)
        if placed.si.n_shards != self.mesh.n_shards:
            raise ValueError(
                f"state of {placed.si.n_shards} shards on a mesh of "
                f"{self.mesh.n_shards}")
        return placed

    def lease_packed(self) -> Tuple[PackedState, DeviceState]:
        """Hand the packed epoch to a chain: ``(packed, lease_token)``.

        The unpacked twin is materialized first (views of the packed
        buffers, which no step writes into), so readers arriving during
        the chain see the pre-chain epoch.  Pass the token to
        :meth:`commit_packed`; it tells whether anything (a presence
        sweep, a commit) replaced the epoch during the chain.  If the
        chain fails before its commit, the manager still holds the
        pre-chain epoch.
        """
        with self._lock:
            packed = self.current_packed
            self.lease_generation += 1
            if self.mesh is not None:
                # the sharded epoch stays held (no step writes into it);
                # readers gather it, so the lease materializes nothing and
                # the token is the epoch itself
                return packed, packed
            if self._state is None:
                self._state = unpack_state(packed)
            self._packed = None
            return packed, self._state

    def commit_packed(self, new_packed: PackedState,
                      present_now: torch.Tensor,
                      read_epoch: Optional[PackedState] = None,
                      lease_token: Optional[DeviceState] = None) -> None:
        """Adopt a packed step's (or chain's) output carry, re-applying the
        ``presence_missing`` flags a concurrent sweep set for devices the
        step did not merge (``present_now``: its presence map, OR'd over
        a chain).

        Pass ``read_epoch`` (the packed epoch a single step read, from
        :attr:`current_packed`) or ``lease_token`` (from
        :meth:`lease_packed`, for a chain): when the epoch is still the one
        the step started from, nothing intervened and the merge is
        skipped."""
        with self._lock:
            new_packed = self._placed(new_packed)
            unchanged = (
                (read_epoch is not None and self._packed is read_epoch)
                or (lease_token is not None
                    and (self._state is lease_token
                         or self._packed is lease_token)))
            if not unchanged:
                cur = self.current_packed
                new_packed = new_packed.replace(
                    si=_merge_presence(new_packed.si, cur.si, present_now))
            self._packed = new_packed
            self._state = None
            self._note_stream()

    def commit(self, new_state: DeviceState,
               batch: Optional[EventBatch] = None,
               accepted: Optional[torch.Tensor] = None,
               present_now: Optional[torch.Tensor] = None) -> None:
        """Adopt an unpacked step's output state, keeping a concurrent
        sweep's missing flags for devices the step did not merge: pass the
        step's ``present_now`` (``bool[capacity]``), or the ``batch`` it
        consumed plus its ``accepted`` mask to re-derive it; with neither,
        no merge.  On a mesh ``new_state`` may be the sharded step's (one
        block per shard in each field) or a whole one (a restore): either
        is committed as the mesh-placed packed epoch."""
        if self.mesh is not None:
            self._commit_on_mesh(new_state, batch, accepted, present_now)
            return
        with self._lock:
            current = self.current
            if current is not new_state and (
                    present_now is not None or batch is not None):
                cap = new_state.capacity
                if present_now is not None:
                    touched = present_now
                else:
                    # the step's merge mask: rejected and update_state=False
                    # rows never cleared presence in the step
                    merged_rows = (batch.valid & (batch.device_id >= 0)
                                   & batch.update_state)
                    if accepted is not None:
                        merged_rows = merged_rows & accepted
                    ids = torch.where(merged_rows & (batch.device_id < cap),
                                      batch.device_id, cap)
                    touched = torch.zeros(cap + 1, dtype=torch.bool,
                                          device=ids.device)
                    touched[ids.to(torch.int64)] = True
                    touched = touched[:cap]
                merged = new_state.presence_missing | (
                    current.presence_missing & ~touched)
                new_state = new_state.replace(presence_missing=merged)
            self._state = new_state
            self._packed = None
            self._note_stream()

    def _commit_on_mesh(self, new_state, batch, accepted,
                        present_now) -> None:
        if isinstance(new_state.last_event_ts_s, Sharded):
            n = new_state.last_event_ts_s.n_shards
            blocks = [pack_state(dataclasses.replace(new_state, **{
                f.name: getattr(new_state, f.name).shards[k]
                for f in dataclasses.fields(new_state)}))
                for k in range(n)]
            placement = Placement(self.mesh, P(None, SHARD_AXIS))
            packed = blocks[0].replace(
                si=Sharded([b.si for b in blocks], placement),
                sf=Sharded([b.sf for b in blocks], placement))
        else:
            if present_now is None and batch is not None:
                raise ValueError(
                    "a mesh commit re-applies presence from present_now")
            packed = pack_state(new_state)
        if present_now is not None and not isinstance(present_now, Sharded):
            present_now = Placement(self.mesh, P(SHARD_AXIS)).place(
                present_now)
        with self._lock:
            packed = self._placed(packed)
            if present_now is not None:
                cur = self.current_packed
                packed = packed.replace(
                    si=_merge_presence(packed.si, cur.si, present_now))
            self._packed = packed
            self._state = None
            self._note_stream()

    def snapshot_host(self) -> Dict[str, np.ndarray]:
        """The held epoch as host arrays, one per :class:`DeviceState`
        field (the checkpoint's ``state`` section).

        The epoch reference is taken under the lock; the copy runs
        outside it.  The two packed carry buffers (packed here first when
        only the unpacked twin is held) are copied once each into pinned
        memory on the stream the epoch was committed from, waited for with
        one event, and split into fields on the host.  The local reference
        keeps the epoch's blocks allocated until the copy is done."""
        with self._lock:
            packed, state, stream = self._packed, self._state, self._stream
        if packed is not None and isinstance(packed.si, Sharded):
            # block by block off each shard's device, joined on the host
            from sitewhere_tpu_torch.pipeline.packed import HostCopy

            with self._on_stream():
                si, sf = HostCopy(packed.si, packed.sf).fetch()
            return _host_fields(packed.replace(
                si=packed.si.shards[0], sf=packed.sf.shards[0]),
                torch.from_numpy(si), torch.from_numpy(sf))
        if self.device.type != "cuda":
            if packed is None:
                packed = pack_state(state)
            return _host_fields(packed, packed.si, packed.sf)
        with torch.cuda.stream(stream or torch.cuda.current_stream(
                self.device)):
            if packed is None:
                packed = pack_state(state)
            si = torch.empty(packed.si.shape, dtype=packed.si.dtype,
                             pin_memory=True)
            sf = torch.empty(packed.sf.shape, dtype=packed.sf.dtype,
                             pin_memory=True)
            si.copy_(packed.si, non_blocking=True)
            sf.copy_(packed.sf, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        done.synchronize()
        return _host_fields(packed, si, sf)

    # -- presence ----------------------------------------------------------

    def apply_presence_sweep(self, now_s: int,
                             missing_after_s: int) -> Optional[EventBatch]:
        """Run the sweep, adopt the flagged state, and build the
        STATE_CHANGE batch for newly-missing devices (None if none), each
        row carrying its device's tenant.

        The sweep launches on the stream the epoch was committed from
        (the caller is the presence thread, whose current stream is its
        own default); the flagged ids come back to the host after the
        lock is released."""
        with self._on_stream():
            with self._lock:
                packed = self._packed
                if packed is not None and isinstance(packed.si, Sharded):
                    idx = self._sweep_shards(packed, now_s, missing_after_s)
                else:
                    new_state, newly_missing = presence_sweep(
                        self.current, now_s, missing_after_s)
                    self._state = new_state
                    self._packed = None
                    idx = None
            if idx is None:
                idx = torch.nonzero(newly_missing).flatten().cpu().numpy()
            else:
                idx = torch.cat(idx).cpu().numpy()
        if idx.size == 0:
            return None
        idx = idx.astype(np.int32)
        if self._tenant_id_of_device is not None:
            tenant_ids = np.asarray(self._tenant_id_of_device(idx), np.int32)
        else:
            tenant_ids = np.zeros(idx.size, np.int32)
        return state_changes_for(idx, tenant_ids, now_s, device=self.device)

    def _sweep_shards(self, packed: PackedState, now_s: int,
                      missing_after_s: int) -> List[torch.Tensor]:
        """The sweep shard by shard over a mesh-placed epoch (under the
        lock): adopts the flagged epoch and returns each shard's newly
        missing GLOBAL ids, still on its device."""
        rows = packed.si.shards[0].shape[-1]
        new_si, new_sf, ids = [], [], []
        for k, ps in enumerate(_shards_of(packed)):
            swept, newly = packed_presence_sweep(ps, now_s, missing_after_s)
            new_si.append(swept.si)
            new_sf.append(swept.sf)
            ids.append(torch.nonzero(newly).flatten() + k * rows)
        self._packed = packed.replace(
            si=Sharded(new_si, packed.si.placement),
            sf=Sharded(new_sf, packed.sf.placement))
        self._state = None
        return ids

    def _epoch_blocks(self) -> List[Tuple[int, DeviceState]]:
        """``(first global id, unpacked block)`` per shard of the held
        epoch, or one whole block off a mesh (snapshot under the lock)."""
        with self._lock:
            packed = self._packed
            if packed is None or not isinstance(packed.si, Sharded):
                return [(0, self.current)]
        rows = packed.si.shards[0].shape[-1]
        return [(k * rows, unpack_state(ps))
                for k, ps in enumerate(_shards_of(packed))]

    # -- queries -----------------------------------------------------------

    def get_device_state(self, device_token: str) -> Dict[str, object]:
        device_id = self.identity.device.lookup(device_token)
        require(device_id != NULL_ID,
                EntityNotFound(f"no device {device_token!r}"))
        return self.get_device_state_by_id(int(device_id))

    def get_device_state_by_id(self, device_id: int) -> Dict[str, object]:
        """Last-known state for one device, as a host dict (on a mesh,
        read from the shard that owns the device's row)."""
        blocks = self._epoch_blocks()
        rows = blocks[0][1].capacity
        require(0 <= device_id < rows * len(blocks),
                EntityNotFound(f"bad device id {device_id}"))
        base, s = blocks[device_id // rows]
        local = device_id - base
        # a REST handler's thread reads on the stream the epoch was
        # committed from, never on its own
        with self._on_stream():
            r = {f: getattr(s, f)[local].cpu().numpy()
                 for f in s.__dataclass_fields__}
        row = {
            "device_id": device_id,
            "last_event_ts_s": int(r["last_event_ts_s"]),
            "last_event_type": int(r["last_event_type"]),
            "presence_missing": bool(r["presence_missing"]),
            "last_location": {
                "lat": float(r["last_lat"]),
                "lon": float(r["last_lon"]),
                "elevation": float(r["last_elevation"]),
                "ts_s": int(r["last_location_ts_s"]),
            },
            "last_alert": {
                "code": int(r["last_alert_code"]),
                "ts_s": int(r["last_alert_ts_s"]),
            },
            "last_values": r["last_values"].tolist(),
            "last_value_ts_s": r["last_value_ts_s"].tolist(),
        }
        if row["last_event_type"] == NULL_ID:
            row["last_event_type"] = None
        return row

    def missing_device_ids(self) -> List[int]:
        """Devices currently flagged missing.

        The lock covers only the epoch snapshot; the device-to-host copy
        runs outside it (epochs are immutable: a commit replaces, never
        mutates).  A scan must never hold the lock through a copy off the
        card: ``commit_packed`` takes it on every batch."""
        out: List[int] = []
        with self._on_stream():
            for base, s in self._epoch_blocks():
                out += (torch.nonzero(s.presence_missing).flatten()
                        + base).tolist()
        return out

    def missing_device_tokens(self) -> List[str]:
        """Missing devices as tokens, the cross-host form (dense ids mean
        something only inside their minting host's identity map)."""
        return [t for t in (self.identity.device.token_of(i)
                            for i in self.missing_device_ids())
                if t is not None]

    def seen_since_tokens(self, since_s: int) -> List[str]:
        """Token form of :meth:`seen_since`."""
        return [t for t in (self.identity.device.token_of(i)
                            for i in self.seen_since(since_s))
                if t is not None]

    def seen_since(self, since_s: int) -> List[int]:
        """Devices with any event at or after ``since_s``: snapshot under
        the lock, mask and copy outside it (see
        :meth:`missing_device_ids`)."""
        out: List[int] = []
        with self._on_stream():
            for base, s in self._epoch_blocks():
                mask = ((s.last_event_type != NULL_ID)
                        & (s.last_event_ts_s >= since_s))
                out += (torch.nonzero(mask).flatten() + base).tolist()
        return out

    def summary(self) -> Dict[str, int]:
        with_state = missing = 0
        with self._on_stream():
            for _, s in self._epoch_blocks():
                with_state += int((s.last_event_type != NULL_ID).sum())
                missing += int(s.presence_missing.sum())
        return {"devices_with_state": with_state,
                "devices_missing": missing}
