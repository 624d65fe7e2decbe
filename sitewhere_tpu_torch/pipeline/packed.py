"""Packed form of the fused step, the K-deep chain and the ring's fetch.

Counterpart of ``sitewhere_tpu/pipeline/packed.py``.  The step's
interface is packed into a few buffers, column-major ``[C, B]`` so every
column is a contiguous row:

  inputs:  PackedTables (6 buffers) + PackedState (2: the carry)
           + batch ints [12, B] + batch floats [4, B]
  outputs: PackedState' + out ints [10, B] + metrics [n] + present [D]

The column orders, flag bits and metrics layout are the reference's,
byte for byte, so a packed buffer means the same in both packages.  The
packed step calls :func:`~.step.pipeline_step` inside; it is an
interface transform only.

On the host: :func:`pack_batch_host` packs decoded numpy columns,
:func:`stage_packed_batch` copies them to the card from pinned buffers
without blocking, :func:`start_host_copy` starts a step's device-to-host
copy at dispatch (a :class:`HostCopy`, waited for once, on its own CUDA
event), :class:`PackedView` reads one step's outputs from it,
:class:`RingFetch` is the one copy a K-step ring shares, and
:class:`RingStepView` reads one slot from that shared copy.

The ring depth the reference chooses with ``jax.default_backend()``
follows its non-TPU branch on the card until an H100 measurement
chooses: :func:`ring_depth_default` is 0 (``SW_TPU_RING_DEPTH``
overrides).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.pipeline.step import (
    NUM_EVENT_TYPES,
    GeofenceFn,
    PipelineOutputs,
    StepMetrics,
    pipeline_step,
)
from sitewhere_tpu_torch.ops.geo_cuda import points_in_polygons_auto
from sitewhere_tpu_torch.schema import (
    DeviceState,
    EventBatch,
    EventType,
    Registry,
    RuleTable,
    ZoneTable,
)

logger = logging.getLogger("sitewhere_tpu_torch.packed")

# -- column orders (load-bearing: pack and unpack must agree) ---------------

REG_I = ("active", "tenant_id", "assignment_status", "device_type_id",
         "assignment_id", "area_id", "customer_id", "asset_id")
RULE_I = ("active", "tenant_id", "mtype_id", "op", "alert_code",
          "alert_level", "kind", "window_idx")
ZONE_I = ("active", "tenant_id", "area_id", "nvert", "condition",
          "alert_code", "alert_level")
BATCH_I = ("valid", "device_id", "tenant_id", "event_type", "ts_s", "ts_ns",
           "mtype_id", "alert_code", "alert_level", "command_id",
           "payload_ref", "update_state")
BATCH_F = ("value", "lat", "lon", "elevation")
STATE_I = ("last_event_ts_s", "last_event_ts_ns", "last_event_type",
           "last_location_ts_s", "last_location_ts_ns", "last_alert_code",
           "last_alert_ts_s", "last_alert_ts_ns", "presence_missing",
           "nonfinite_count")
STATE_F = ("last_lat", "last_lon", "last_elevation")
OUT_I = ("flags", "device_type_id", "assignment_id", "area_id",
         "customer_id", "asset_id", "rule_id", "zone_id",
         "derived_code", "derived_level")
METRIC_SCALARS = ("processed", "accepted", "unregistered", "unassigned",
                  "threshold_alerts", "zone_alerts")
# On-device occupancy telemetry, after the step metrics in the same vector.
TELEMETRY_SCALARS = ("rows_invalid", "state_writes", "presence_merges",
                     "rows_nonfinite")
# Per-tenant block after the telemetry: rows bucketed by
# ``tenant_id % TENANT_METER_SLOTS`` (floor-mod: NULL_ID lands in the last
# bucket), three masked counts per bucket, counter-major.
TENANT_METER_COUNTERS = ("rows", "state_writes", "rows_nonfinite")
TENANT_METER_SLOTS = 16
TENANT_METER_BLOCK = len(TENANT_METER_COUNTERS) * TENANT_METER_SLOTS

PRESENCE_ROW = STATE_I.index("presence_missing")

# flag bits in OUT_I row 0
F_ACCEPTED = 1
F_UNREGISTERED = 2
F_UNASSIGNED = 4
F_DERIVED = 8


@dataclasses.dataclass(frozen=True)
class PackedTables:
    """Registry, rules and zones packed to six buffers."""

    reg_i: torch.Tensor    # int32[8, D]
    rules_i: torch.Tensor  # int32[8, R]
    rules_f: torch.Tensor  # float32[R] — threshold
    taus: torch.Tensor     # float32[K]
    zones_i: torch.Tensor  # int32[7, Z]
    zones_v: torch.Tensor  # float32[Z, V, 2]


@dataclasses.dataclass(frozen=True)
class PackedState:
    """DeviceState packed to two buffers (the step carry)."""

    si: torch.Tensor  # int32[10 + 2M, D]
    sf: torch.Tensor  # float32[3 + M + M*K, D]
    num_mtype_slots: int = 8
    num_ewma_scales: int = 3

    @property
    def capacity(self) -> int:
        return self.si.shape[-1]

    def replace(self, **changes) -> "PackedState":
        return dataclasses.replace(self, **changes)


def _stack_i32(obj, names: Sequence[str]) -> torch.Tensor:
    return torch.stack([getattr(obj, f).to(torch.int32) for f in names])


def _rows(buf: torch.Tensor, names: Sequence[str]) -> Dict[str, torch.Tensor]:
    cols = {f: buf[i] for i, f in enumerate(names)}
    for f in ("active", "valid", "update_state", "presence_missing"):
        if f in cols:
            cols[f] = cols[f] != 0
    return cols


def pack_tables(registry: Registry, rules: RuleTable,
                zones: ZoneTable) -> PackedTables:
    return PackedTables(
        reg_i=_stack_i32(registry, REG_I),
        rules_i=_stack_i32(rules, RULE_I),
        rules_f=rules.threshold,
        taus=rules.ewma_tau_s,
        zones_i=_stack_i32(zones, ZONE_I),
        zones_v=zones.verts,
    )


def unpack_tables(t: PackedTables) -> Tuple[Registry, RuleTable, ZoneTable]:
    registry = Registry(epoch=t.reg_i.new_zeros(()), **_rows(t.reg_i, REG_I))
    rules = RuleTable(threshold=t.rules_f, ewma_tau_s=t.taus,
                      **_rows(t.rules_i, RULE_I))
    zones = ZoneTable(verts=t.zones_v, **_rows(t.zones_i, ZONE_I))
    return registry, rules, zones


def pack_state(state: DeviceState) -> PackedState:
    m, k = state.num_mtype_slots, state.num_ewma_scales
    si = torch.cat([
        _stack_i32(state, STATE_I),
        state.last_value_ts_s.T,
        state.last_value_ts_ns.T,
    ])
    sf = torch.cat([
        torch.stack([getattr(state, f) for f in STATE_F]),
        state.last_values.T,
        state.ewma_values.reshape(-1, m * k).T,
    ])
    return PackedState(si=si, sf=sf, num_mtype_slots=m, num_ewma_scales=k)


def unpack_state(ps: PackedState) -> DeviceState:
    """Views into the packed buffers (no copy)."""
    m, k = ps.num_mtype_slots, ps.num_ewma_scales
    d = ps.capacity
    n, nf = len(STATE_I), len(STATE_F)
    return DeviceState(
        last_values=ps.sf[nf:nf + m].T,
        last_value_ts_s=ps.si[n:n + m].T,
        last_value_ts_ns=ps.si[n + m:n + 2 * m].T,
        ewma_values=ps.sf[nf + m:].T.reshape(d, m, k),
        **_rows(ps.si, STATE_I),
        **{f: ps.sf[i] for i, f in enumerate(STATE_F)},
    )


def unpack_batch(bi: torch.Tensor, bf: torch.Tensor) -> EventBatch:
    return EventBatch(**_rows(bi, BATCH_I),
                      **{f: bf[i] for i, f in enumerate(BATCH_F)})


def packed_metric_entries() -> int:
    """Length of the packed metrics vector."""
    return (len(METRIC_SCALARS) + NUM_EVENT_TYPES + len(TELEMETRY_SCALARS)
            + TENANT_METER_BLOCK)


def pack_outputs(out: PipelineOutputs, batch: EventBatch
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PipelineOutputs of ``batch`` -> ``(oi int32[10, B], metrics
    int32[n], present bool[D])``."""
    derived = out.derived_alerts
    i32 = torch.int32
    flags = (out.accepted.to(i32) * F_ACCEPTED
             + out.unregistered.to(i32) * F_UNREGISTERED
             + out.unassigned.to(i32) * F_UNASSIGNED
             + derived.valid.to(i32) * F_DERIVED)
    oi = torch.stack([
        flags, out.device_type_id, out.assignment_id, out.area_id,
        out.customer_id, out.asset_id, out.rule_id, out.zone_id,
        derived.alert_code, derived.alert_level,
    ])
    m = out.metrics
    width = out.accepted.shape[0]
    writes = out.accepted & batch.update_state
    telemetry = torch.stack([
        width - m.processed,                  # rows_invalid
        writes.sum(dtype=i32),                # state_writes
        out.present_now.sum(dtype=i32),       # presence_merges
        out.nonfinite.sum(dtype=i32),         # rows_nonfinite
    ])
    bucket = (batch.tenant_id % TENANT_METER_SLOTS).to(torch.int64)
    counts = torch.stack([out.accepted, writes, out.nonfinite],
                         dim=-1).to(i32)  # [B, 3]
    per_tenant = counts.new_zeros((TENANT_METER_SLOTS, 3)).index_add(
        0, bucket, counts)
    tenant_block = per_tenant.T.reshape(-1)  # counter-major
    metrics = torch.cat([
        torch.stack([getattr(m, f) for f in METRIC_SCALARS]), m.by_type,
        telemetry, tenant_block])
    return oi, metrics, out.present_now


def packed_pipeline_step(
    tables: PackedTables, ps: PackedState, bi: torch.Tensor, bf: torch.Tensor,
    geofence: GeofenceFn = points_in_polygons_auto,
) -> Tuple[PackedState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused step over the packed interface (semantics identical to
    :func:`pipeline_step`)."""
    registry, rules, zones = unpack_tables(tables)
    state = unpack_state(ps)
    batch = unpack_batch(bi, bf)
    new_state, out = pipeline_step(registry, state, rules, zones, batch,
                                   geofence)
    return pack_state(new_state), *pack_outputs(out, batch)


def chain_over_slots(step, k: int, tables: PackedTables, ps: PackedState,
                     slots: Sequence[torch.Tensor]):
    """Cycle the K pre-staged ``(bi, bf)`` slots through ``step``,
    threading the carry on the device: ``(ps', ois [K, 10, B],
    metrics [K, n], present [D])`` with ``present`` the OR of the steps'
    presence maps.  ``slots`` is K ``bi`` tensors then K ``bf`` tensors."""
    if len(slots) != 2 * k:
        raise ValueError(f"expected {2 * k} slot tensors, got {len(slots)}")
    ois, mets = [], []
    present = torch.zeros(ps.capacity, dtype=torch.bool, device=ps.si.device)
    for i in range(k):
        ps, oi, met, pres = step(tables, ps, slots[i], slots[k + i])
        ois.append(oi)
        mets.append(met)
        present = present | pres
    return ps, torch.stack(ois), torch.stack(mets), present


def build_packed_chain(k: int,
                       geofence: GeofenceFn = points_in_polygons_auto
                       ) -> Callable:
    """K packed steps chained on the device: the returned callable takes
    ``(tables, ps, *slots)`` (K ``bi`` then K ``bf``) and returns
    ``(ps', ois [K, 10, B], metrics [K, n], present [D])``.  The host
    launches the K steps back to back and waits for none of them."""

    def step(tables, ps, bi, bf):
        return packed_pipeline_step(tables, ps, bi, bf, geofence)

    def chain(tables, ps, *slots):
        return chain_over_slots(step, k, tables, ps, slots)

    return chain


def ring_depth_default() -> int:
    """Ring depth of the dispatcher when none is configured.

    The reference chains 8 steps per dispatch on a TPU and none
    elsewhere; the port takes the non-TPU branch, 0, until an H100
    measurement of the ring on and off chooses.  ``SW_TPU_RING_DEPTH``
    overrides the default (an explicit ``ring_depth`` still wins).
    """
    env = os.environ.get("SW_TPU_RING_DEPTH")
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            logger.warning("ignoring non-integer SW_TPU_RING_DEPTH=%r", env)
    return 0


def packed_env_override() -> Optional[bool]:
    """``SW_TPU_PACKED_STEP`` as a tristate (None = unset): the one parser
    for every consumer, so the dispatcher default and the pure-step
    choice never disagree on what the variable means."""
    env = os.environ.get("SW_TPU_PACKED_STEP")
    if env is None:
        return None
    return env.strip().lower() not in ("0", "false", "")


def packed_step_default() -> bool:
    """Interface choice for the PURE step (microbenchmarks).

    The reference packs on a TPU and not elsewhere; the port takes the
    non-TPU branch, unpacked, until an H100 measurement chooses.  The
    dispatcher packs on every backend regardless
    (``Instance._packed_step_enabled``).  ``SW_TPU_PACKED_STEP=0/1``
    overrides both."""
    env = packed_env_override()
    return False if env is None else env


def packed_presence_sweep(ps: PackedState, now_s, missing_after_s
                          ) -> Tuple[PackedState, torch.Tensor]:
    """Presence sweep over the packed carry (one unpack -> sweep -> pack):
    ``(ps', newly_missing bool[D])``."""
    from sitewhere_tpu_torch.state.presence import presence_sweep

    state, newly = presence_sweep(unpack_state(ps), now_s, missing_after_s)
    return pack_state(state), newly


# -- host side --------------------------------------------------------------


def pack_batch_host(cols: Dict[str, np.ndarray],
                    width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy columns -> ``([12, B] int32, [4, B] float32)``."""
    bi = np.empty((len(BATCH_I), width), np.int32)
    bf = np.empty((len(BATCH_F), width), np.float32)
    for i, f in enumerate(BATCH_I):
        bi[i] = cols[f]
    for i, f in enumerate(BATCH_F):
        bf[i] = cols[f]
    return bi, bf


def stage_packed_batch(bi: np.ndarray, bf: np.ndarray,
                       device: DeviceLike = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Start the host-to-device copy of one packed batch ahead of its
    step.  On a card the columns go through pinned host buffers with
    ``non_blocking=True`` copies, so the call returns before the copy
    ends; the caching host allocator keeps each pinned buffer until its
    copy has run."""
    device = resolve_device(device)
    hi = torch.from_numpy(np.ascontiguousarray(bi, np.int32))
    hf = torch.from_numpy(np.ascontiguousarray(bf, np.float32))
    if device.type != "cuda":
        return hi.to(device, copy=True), hf.to(device, copy=True)
    return (hi.pin_memory().to(device, non_blocking=True),
            hf.pin_memory().to(device, non_blocking=True))


class HostCopy:
    """Device-to-host copy of some tensors, started at construction and
    waited for once.

    On a card each tensor is copied into a pinned host buffer with
    ``non_blocking=True`` on its device's current stream, and a CUDA
    event is recorded after the copies; :meth:`fetch` waits on that event
    alone, never on the whole card (``torch.cuda.synchronize`` would also
    wait for the steps dispatched after this one).  On the CPU the
    tensors are their own host copy.  A mesh-placed
    :class:`~sitewhere_tpu_torch.parallel.mesh.Sharded` tensor copies
    block by block (one event per device) and is joined on the host at
    fetch; a replicated one copies shard 0's block.  ``on_fetch`` is
    called once, at the first :meth:`fetch` (the dispatcher counts its
    host syncs there).
    """

    def __init__(self, *tensors, on_fetch=None):
        from sitewhere_tpu_torch.parallel.mesh import Sharded

        self._on_fetch = on_fetch
        self._host: Optional[Tuple[np.ndarray, ...]] = None
        # per tensor: (blocks, dim); dim None = a single block
        self._parts = []
        for t in tensors:
            if isinstance(t, Sharded):
                if t.dim is None:
                    self._parts.append(((t.shards[0],), None))
                else:
                    self._parts.append((t.shards, t.dim))
            else:
                self._parts.append(((t,), None))
        self._done = []
        devices = {}
        for blocks, _ in self._parts:
            for b in blocks:
                if b.is_cuda:
                    devices[b.device] = True
        if devices:
            self._parts = [
                (tuple(self._pinned(b) for b in blocks), dim)
                for blocks, dim in self._parts]
            for dev in devices:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
                self._done.append(done)

    @staticmethod
    def _pinned(t: torch.Tensor) -> torch.Tensor:
        if not t.is_cuda:
            return t
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        return buf

    def fetch(self) -> Tuple[np.ndarray, ...]:
        if self._host is None:
            if self._on_fetch is not None:
                self._on_fetch()
            for done in self._done:
                done.synchronize()
            self._host = tuple(
                blocks[0].numpy() if dim is None
                else np.concatenate([b.numpy() for b in blocks], axis=dim)
                for blocks, dim in self._parts)
            self._parts = ()
        return self._host


def start_host_copy(*tensors: torch.Tensor, on_fetch=None) -> HostCopy:
    """Start the device-to-host copy of a dispatched step's outputs, so
    that by the time egress reads them the bytes are on the host."""
    return HostCopy(*tensors, on_fetch=on_fetch)


class PackedView:
    """Host view of one packed step's outputs.

    The ``[10, B]`` block and the metrics vector are copied to the host
    once (a :class:`HostCopy` started at construction, waited for at
    first use) and columns are numpy rows of that copy.  ``present_now``
    stays on the device: it feeds the commit, never the host.
    """

    def __init__(self, oi, metrics, present_now, on_fetch=None,
                 copy=None):
        self.present_now = present_now
        # ``copy``: a copy of (oi, metrics) the caller already started
        self._copy = copy if copy is not None else (
            HostCopy(oi, metrics, on_fetch=on_fetch)
            if oi is not None else None)
        self._oi: Optional[np.ndarray] = None
        self._metrics_host: Optional[np.ndarray] = None
        self._metrics: Optional[StepMetrics] = None
        self._accepted: Optional[np.ndarray] = None

    def _fetch(self) -> None:
        self._oi, self._metrics_host = self._copy.fetch()

    def fetch(self) -> None:
        """Wait for the step's outputs and take them to the host, once:
        every read after it is host work."""
        if self._oi is None:
            self._fetch()

    @property
    def oi(self) -> np.ndarray:
        if self._oi is None:
            self._fetch()
        return self._oi

    @property
    def metrics_vector(self) -> np.ndarray:
        if self._metrics_host is None:
            self._fetch()
        return self._metrics_host

    def _row(self, name: str) -> np.ndarray:
        return self.oi[OUT_I.index(name)]

    def _flag(self, bit: int) -> np.ndarray:
        return (self._row("flags") & bit) != 0

    @property
    def accepted(self) -> np.ndarray:
        # memoized: egress consults the mask several times per plan
        if self._accepted is None:
            self._accepted = self._flag(F_ACCEPTED)
        return self._accepted

    @property
    def unregistered(self) -> np.ndarray:
        return self._flag(F_UNREGISTERED)

    @property
    def unassigned(self) -> np.ndarray:
        return self._flag(F_UNASSIGNED)

    @property
    def derived_valid(self) -> np.ndarray:
        return self._flag(F_DERIVED)

    def __getattr__(self, name):
        if name in OUT_I:
            return self._row(name)
        raise AttributeError(name)

    @property
    def metrics(self) -> StepMetrics:
        """The step counters as numpy scalars."""
        if self._metrics is None:
            v = self.metrics_vector
            n = len(METRIC_SCALARS)
            self._metrics = StepMetrics(
                by_type=v[n:n + NUM_EVENT_TYPES],
                **{f: v[i] for i, f in enumerate(METRIC_SCALARS)})
        return self._metrics

    @property
    def telemetry(self) -> Dict[str, int]:
        v = self.metrics_vector
        base = len(METRIC_SCALARS) + NUM_EVENT_TYPES
        return {f: int(v[base + i]) for i, f in enumerate(TELEMETRY_SCALARS)}

    @property
    def tenant_meter(self) -> np.ndarray:
        """``[len(TENANT_METER_COUNTERS), TENANT_METER_SLOTS]`` counts."""
        v = self.metrics_vector
        base = len(METRIC_SCALARS) + NUM_EVENT_TYPES + len(TELEMETRY_SCALARS)
        return v[base:base + TENANT_METER_BLOCK].reshape(
            len(TENANT_METER_COUNTERS), TENANT_METER_SLOTS)

    def derived_cols(self, host_cols: Dict[str, np.ndarray],
                     rows: np.ndarray) -> Dict[str, np.ndarray]:
        """The derived-alert event columns for ``rows``, rebuilt from the
        host's own columns and the packed outputs."""
        n = rows.size
        return dict(
            device_id=host_cols["device_id"][rows],
            tenant_id=host_cols["tenant_id"][rows],
            event_type=np.full(n, int(EventType.ALERT), np.int32),
            ts_s=host_cols["ts_s"][rows],
            ts_ns=host_cols["ts_ns"][rows],
            alert_code=self._row("derived_code")[rows],
            alert_level=self._row("derived_level")[rows],
            payload_ref=host_cols["payload_ref"][rows],
            update_state=np.zeros(n, bool),
        )


class RingFetch(HostCopy):
    """The one device-to-host copy every step view of a K-step chain
    shares: the stacked ``ois [K, 10, B]`` and ``metrics [K, n]`` copy at
    construction and the first :meth:`fetch` waits for them once; every
    slot reads its slice from the same host copy: K steps, one host
    sync.  Construct it as ``RingFetch(ois, metrics, on_fetch=...)``."""


class RingStepView(PackedView):
    """Slot ``slot``'s :class:`PackedView`, read from the ring's shared
    fetch.  ``present_now`` is None: presence commits once per chain."""

    def __init__(self, ring: RingFetch, slot: int):
        super().__init__(None, None, None)
        self._ring_fetch = ring
        self.slot = slot

    def _fetch(self) -> None:
        ois, mets = self._ring_fetch.fetch()
        self._oi = ois[self.slot]
        self._metrics_host = mets[self.slot]
