"""Deadline-driven batcher: decoded requests -> fixed-shape batches.

Counterpart of ``sitewhere_tpu/ingest/batcher.py``: the seam between the
variable-rate host world and the fixed-width step.

- intake is COLUMNAR: rows live in queues of numpy column chunks,
  written once at intake (vectorized ``add_arrays`` takes one slice per
  field; the scalar ``add`` appends into a growable staging chunk)
  and copied exactly once more at emission, by slice, into the
  fixed-shape batch;
- events are ROUTED to the shard owning their device's registry row
  (:func:`~sitewhere_tpu_torch.parallel.mesh.shard_for_device`), so shard
  ``k`` owns batch rows ``[k*seg, (k+1)*seg)`` with ``seg = width /
  n_shards``; rows of unknown devices go round-robin;
- a batch is emitted when ANY shard's segment fills or when the oldest
  pending event exceeds the deadline;
- rows that don't fit carry over to the next batch (no drops);
- unknown devices are rewritten to ``NULL_ID`` and flagged unregistered
  on the device.

With ``emit_packed`` a plan carries the packed ``[12, B]`` / ``[4, B]``
host buffers the packed step takes (``pipeline/packed.py``); otherwise
:meth:`BatchPlan.materialize_batch` builds the torch
:class:`~sitewhere_tpu_torch.schema.EventBatch` on the dispatcher's
device.  :meth:`Batcher.reserve` hands the fill-direct wire scanner a
:class:`Reservation`: packed rows it writes in place, adopted as the
plan's packed buffers when they fill a batch alone; a sharded batcher
commits a segment-ordered reservation as per-shard views of its buffers,
so a full-width one is adopted with no copy too.

Instants (a chunk's arrival, a plan's ``created_at`` and ``received_at``)
are on the batcher's ``clock``, by default the span clock of
``runtime/tracing.py``, so a plan's wait lies on the same axis as its
spans.  Each chunk carries its rows' origin (``stream``, or the
re-injection that produced them, with the seq of the plan whose egress
did), and a plan carries its oldest row's.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from sitewhere_tpu_torch.analysis.markers import hot_path
from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.ids import NULL_ID
from sitewhere_tpu_torch.ingest.decoders import DecodedRequest, RequestKind
from sitewhere_tpu_torch.parallel.mesh import shard_for_device
from sitewhere_tpu_torch.pipeline.packed import BATCH_F, BATCH_I
from sitewhere_tpu_torch.runtime.tracing import _NOOP_TRACE, span_clock
from sitewhere_tpu_torch.schema import EventBatch

_FIELDS = (
    ("valid", np.bool_, False),
    ("device_id", np.int32, NULL_ID),
    ("tenant_id", np.int32, NULL_ID),
    ("event_type", np.int32, 0),
    ("ts_s", np.int32, 0),
    ("ts_ns", np.int32, 0),
    ("mtype_id", np.int32, NULL_ID),
    ("value", np.float32, 0.0),
    ("lat", np.float32, 0.0),
    ("lon", np.float32, 0.0),
    ("elevation", np.float32, 0.0),
    ("alert_code", np.int32, NULL_ID),
    ("alert_level", np.int32, 0),
    ("command_id", np.int32, NULL_ID),
    ("payload_ref", np.int32, NULL_ID),
    ("update_state", np.bool_, True),
)

# Data columns (everything but the emission-owned `valid` flag).
_COL_FIELDS = tuple(name for name, _, _ in _FIELDS[1:])
_DTYPE = {name: dt for name, dt, _ in _FIELDS}
_FILL = {name: fill for name, _, fill in _FIELDS}
# 0-d fill templates: `np.broadcast_to(_FILL_0D[f], n)` is a zero-copy
# 0-stride view of any length; emission copies by slice regardless, and
# nothing writes into a queued chunk's columns.
_FILL_0D = {name: np.full((), fill, dt) for name, dt, fill in _FIELDS}
# Bytes one emitted row occupies across every batch column (the unit of
# the pipeline.bytes_copied.batch accounting).
_ROW_BYTES = sum(np.dtype(dt).itemsize for _, dt, _ in _FIELDS)
# Row of each column in the packed buffers
_BI = {f: i for i, f in enumerate(BATCH_I)}
_BF = {f: i for i, f in enumerate(BATCH_F)}
# The columns the fill-direct scanner writes (mtype_id through its
# name-index scratch)
_SCANNED_I = ("device_id", "mtype_id", "ts_s", "ts_ns", "update_state")


@dataclasses.dataclass
class _Chunk:
    """A columnar run of pending rows.

    ``start`` = rows already emitted; ``length`` = rows written.  A chunk
    whose backing arrays are longer than ``length`` is a *staging* chunk:
    the scalar ``add`` appends into it in place; vectorized chunks
    arrive full (``length == capacity``).  A chunk with a ``reserved``
    back-reference was filled in place by the fill-direct scanner; when
    it is the sole content of a full-width packed emission, ``_emit``
    adopts its buffers as the batch instead of copying.
    """

    cols: Dict[str, np.ndarray]
    length: int
    arrival: float
    start: int = 0
    # when the rows' payload was received, before its decode (latency
    # only; the deadline counts from ``arrival``); None = ``arrival``
    received: Optional[float] = None
    reserved: Optional["Reservation"] = None
    # Row offset of this chunk inside its reservation's buffers (sharded
    # commits enqueue per-shard VIEWS of one buffer; adoption needs each
    # view to sit exactly at its shard's segment).
    res_off: int = 0
    # where the rows came from ("stream", "derived", "quarantine",
    # "replay", ...) and, for a re-injection, the seq of the plan whose
    # egress re-injected them (-1 otherwise)
    origin: str = "stream"
    origin_seq: int = -1

    @property
    def capacity(self) -> int:
        return len(self.cols["device_id"])


class Reservation:
    """A writable, packed-layout column segment for the fill-direct scan.

    :meth:`Batcher.reserve` hands the C scanner
    (``decode_measurement_lines_resolved_into``) int32/float32 views into
    a fresh packed buffer pair, the same ``[C, B]`` rows the emitted plan
    ships to the card.

    - The buffers are private to this reservation until :meth:`commit`
      enqueues them under the dispatcher's intake lock; a mid-payload
      bail never commits, so it leaves no torn rows (:meth:`abort` only
      drops it).
    - The scanner writes ``device_id``, ``mtype_id`` (through the
      ``name_idx`` scratch and one remap), ``value``, ``ts_s``, ``ts_ns``
      and ``update_state``; every other column is a 0-stride fill template
      or a per-payload constant (:meth:`set_const`).
    - A full-width reservation that is the sole pending content when the
      batch emits is ADOPTED: its buffers become the packed plan and the
      batch-assembly copy disappears.  Adopted ``host_cols`` expose
      ``valid`` and ``update_state`` as int32 rows (not bool).
    """

    __slots__ = ("_batcher", "ibuf", "fbuf", "name_idx", "cap", "n",
                 "tenant_id", "payload_ref", "_open")

    def __init__(self, batcher: "Batcher", cap: int):
        self._batcher = batcher
        self.cap = cap
        self.n = 0
        self.tenant_id = 0
        self.payload_ref = NULL_ID
        self._open = True
        self.ibuf = np.empty((len(BATCH_I), cap), np.int32)
        self.fbuf = np.empty((len(BATCH_F), cap), np.float32)
        self.name_idx = np.empty(cap, np.int32)
        if cap == batcher.width:
            # adoption candidate: fill the columns the scanner never
            # writes here, off the intake lock, so commit stays O(1)
            for f in ("event_type", "alert_code", "alert_level",
                      "command_id"):
                self.ibuf[_BI[f]].fill(_FILL[f])
            for f in ("lat", "lon", "elevation"):
                self.fbuf[_BF[f]].fill(_FILL[f])

    # -- scanner-facing views (full capacity, contiguous) -------------------

    @property
    def device_id(self) -> np.ndarray:
        return self.ibuf[_BI["device_id"]]

    @property
    def mtype_id(self) -> np.ndarray:
        return self.ibuf[_BI["mtype_id"]]

    @property
    def ts_s(self) -> np.ndarray:
        return self.ibuf[_BI["ts_s"]]

    @property
    def ts_ns(self) -> np.ndarray:
        return self.ibuf[_BI["ts_ns"]]

    @property
    def update_state(self) -> np.ndarray:
        return self.ibuf[_BI["update_state"]]

    @property
    def value(self) -> np.ndarray:
        return self.fbuf[_BF["value"]]

    def set_const(self, *, tenant_id: int, payload_ref: int) -> None:
        """Per-payload constants, applied as 0-stride broadcasts at commit
        (and written into their rows only on adoption)."""
        self.tenant_id = int(tenant_id)
        self.payload_ref = int(payload_ref)

    def abort(self) -> None:
        """Discard: nothing was shared, so nothing needs undoing."""
        self._open = False

    def commit(self, received_at: Optional[float] = None) -> List[BatchPlan]:
        """Enqueue the ``self.n`` scanned rows (call under the intake
        lock, i.e. through the dispatcher's ``_take``); ``received_at`` as
        in :meth:`Batcher.add_arrays`.  Returns every plan that became
        ready."""
        b = self._batcher
        if not self._open:
            raise RuntimeError("reservation already committed/aborted")
        self._open = False
        n = self.n
        if n <= 0:
            return []
        # in-place NULL_ID rewrite (the add_arrays contract): the table
        # can hold ids at or past the registry capacity; the buffers are
        # ours, so no defensive copy
        d = self.device_id[:n]
        bad = (d < 0) | (d >= b.capacity)
        if b.n_shards > 1:
            # the scanner wrote RESOLVED ids, so the routing is known
            # here: segment-ordered payloads enqueue views of this
            # buffer, anything else takes the add_arrays gather lane
            return self._commit_sharded(b, n, bad, received_at)
        if bad.any():
            d[bad] = NULL_ID
        now = b.clock()
        b._pending[0].append(_Chunk(
            cols=self._cols(0, n), length=n, arrival=now,
            received=received_at, reserved=self))
        b._counts[0] += n
        if b._oldest is None:
            b._oldest = now
        plans: List[BatchPlan] = []
        while max(b._counts) >= b.seg:
            plans.append(b._emit())
        return plans

    def _cols(self, lo: int, hi: int) -> Dict[str, np.ndarray]:
        """Column views of scanned rows ``[lo, hi)``; the constants and
        the fills as 0-stride broadcasts."""
        n = hi - lo
        cols: Dict[str, np.ndarray] = {
            f: self.ibuf[_BI[f]][lo:hi] for f in _SCANNED_I}
        cols["value"] = self.value[lo:hi]
        cols["tenant_id"] = np.broadcast_to(np.int32(self.tenant_id), n)
        cols["payload_ref"] = np.broadcast_to(np.int32(self.payload_ref), n)
        for f in _COL_FIELDS:
            if f not in cols:
                cols[f] = np.broadcast_to(_FILL_0D[f], n)
        return cols

    def _commit_sharded(self, b: "Batcher", n: int, bad: np.ndarray,
                        received_at: Optional[float]) -> List[BatchPlan]:
        """Sharded enqueue of the scanned rows.  The zero-copy lane needs
        every id in range and the shard sequence non-decreasing: then
        shard ``s``'s rows are one contiguous run, and the chunk is a
        VIEW (``res_off`` records its buffer position, so a full-width
        segment-aligned reservation is adopted outright by ``_emit``)."""
        d = self.device_id[:n]
        segmented = not bad.any()
        if segmented:
            shard = d // b.rows_per_shard
            if n > 1:
                segmented = bool((shard[:-1] <= shard[1:]).all())
        if not segmented:
            # the gather lane: same routing and copy contract as columnar
            # intake (bad ids rewritten and round-robined there); the
            # buffers are ours and never touched again
            cols = self._cols(0, n)
            return b.add_arrays(
                _copy=False, received_at=received_at,
                **{f: cols[f] for f in _SCANNED_I + (
                    "value", "tenant_id", "payload_ref")})
        now = b.clock()
        bounds = np.searchsorted(shard, np.arange(b.n_shards + 1))
        for s in range(b.n_shards):
            lo, hi = int(bounds[s]), int(bounds[s + 1])
            if lo == hi:
                continue
            b._pending[s].append(_Chunk(
                cols=self._cols(lo, hi), length=hi - lo, arrival=now,
                received=received_at, reserved=self, res_off=lo))
            b._counts[s] += hi - lo
        if b._oldest is None:
            b._oldest = now
        plans: List[BatchPlan] = []
        while max(b._counts) >= b.seg:
            plans.append(b._emit())
        return plans

    def finalize_adopted(self, n: int) -> Dict[str, np.ndarray]:
        """Emission-time completion of an adopted buffer: write validity,
        the per-payload constants and the padding fills into their rows,
        and return the host-column views."""
        ibuf, fbuf = self.ibuf, self.fbuf
        valid = ibuf[_BI["valid"]]
        valid[:n] = 1
        valid[n:] = 0
        ibuf[_BI["tenant_id"]][:n] = self.tenant_id
        ibuf[_BI["payload_ref"]][:n] = self.payload_ref
        if n < self.cap:
            for f in ("tenant_id", "payload_ref") + _SCANNED_I:
                ibuf[_BI[f]][n:] = _FILL[f]
            fbuf[_BF["value"]][n:] = _FILL["value"]
        host_cols = {f: ibuf[i] for i, f in enumerate(BATCH_I)}
        host_cols.update({f: fbuf[i] for i, f in enumerate(BATCH_F)})
        return host_cols


class BatchPlan:
    """A ready-to-dispatch batch plus its host-side bookkeeping.

    ``host_cols`` keeps the numpy columns the device batch was built from
    so egress never fetches the input batch back off the device: only
    step *outputs* cross to the host after dispatch.  The device
    :class:`EventBatch` of an unpacked plan is materialized lazily, off
    the intake lock (:meth:`materialize_batch`).
    """

    __slots__ = ("_batch", "n_events", "width", "created_at", "max_wait_s",
                 "host_cols", "packed_i", "packed_f", "staged", "seq",
                 "reason", "received_at", "dispatch_s", "origin",
                 "origin_seq", "trace", "windowed_at", "stage_marks")

    def __init__(
        self,
        batch: Optional[EventBatch] = None,
        n_events: int = 0,
        width: int = 1,
        created_at: float = 0.0,
        max_wait_s: float = 0.0,  # how long the oldest row waited
        host_cols: Optional[Dict[str, np.ndarray]] = None,
        # Packed form ([12, B] int32 / [4, B] float32) when the batcher
        # was built with ``emit_packed``; then ``batch`` stays None.
        packed_i: Optional[np.ndarray] = None,
        packed_f: Optional[np.ndarray] = None,
        # The (bi, bf) tensors staged on the device ahead of the step
        # (pipeline/packed.py stage_packed_batch); None = not staged yet.
        staged: Optional[tuple] = None,
        # ``seq``: the batcher's monotonic emission number; ``reason``:
        # the emit trigger ("fill" | "deadline" | "flush").  Only
        # full-width fill emissions ride the dispatcher's ring.
        seq: int = -1,
        reason: str = "fill",
        # When the payload of the plan's oldest row was received, before
        # its decode (the start of the plan's end-to-end latency); None =
        # when that row entered the batcher.
        received_at: Optional[float] = None,
        # the oldest row's origin and source plan (see ``_Chunk``)
        origin: str = "stream",
        origin_seq: int = -1,
    ):
        self._batch = batch
        self.n_events = n_events
        self.width = width
        self.created_at = created_at
        self.max_wait_s = max_wait_s
        self.host_cols = host_cols if host_cols is not None else {}
        self.packed_i = packed_i
        self.packed_f = packed_f
        self.staged = staged
        self.seq = seq
        self.reason = reason
        self.received_at = (created_at - max_wait_s if received_at is None
                            else received_at)
        # host seconds of the plan's dispatch (the flight recorder's
        # stage attribution; a ring slot gets its share of the chain)
        self.dispatch_s = 0.0
        self.origin = origin
        self.origin_seq = origin_seq
        # the dispatcher's bookkeeping for the plan's trace: the trace
        # (a no-op one until the dispatcher takes the plan), when it
        # entered the in-flight window, and its step's device-stage marks
        # (sampled steps only)
        self.trace = _NOOP_TRACE
        self.windowed_at = 0.0
        self.stage_marks = None

    def materialize_batch(self, device: DeviceLike = None
                          ) -> Optional[EventBatch]:
        """Build (and cache) the :class:`EventBatch` of ``host_cols`` on
        ``device`` (``None`` = the card); packed plans return None (they
        ship ``packed_i``/``packed_f`` instead).  Call off the intake and
        step locks: this is the plan's host-to-device copy."""
        if self._batch is None and self.packed_i is None and self.host_cols:
            device = resolve_device(device)
            # torch.tensor copies, so the host columns stay the plan's own
            self._batch = EventBatch(**{
                k: torch.tensor(v, device=device)
                for k, v in self.host_cols.items()})
        return self._batch

    @property
    def batch(self) -> Optional[EventBatch]:
        """The materialized batch (None until :meth:`materialize_batch`)."""
        return self._batch

    @property
    def fill(self) -> float:
        return self.n_events / self.width


class AdaptiveBatchController:
    """Load-adaptive emission window (the deadline the batcher emits on).

    The batch WIDTH is fixed for the step; the adaptive knob is the time
    window a partial batch may coalesce before the deadline forces it out:

    - a deadline emit at low fill with nothing left pending -> the stream
      is idle; SHRINK the window toward ``min_s``;
    - a segment-fill emit, or a full batch still pending after an emit ->
      the stream is backlogged; GROW the window toward ``max_s``.

    Deterministic: driven entirely by the batcher's emits.  Decisions are
    exported through the metrics registry (``ingest.adaptive_window_s``
    gauge, ``ingest.adaptive_grow`` / ``ingest.adaptive_shrink``
    counters).
    """

    def __init__(
        self,
        deadline_ms: float = 5.0,
        min_ms: Optional[float] = None,
        max_ms: Optional[float] = None,
        low_fill: float = 0.25,
        grow: float = 1.5,
        shrink: float = 0.75,
        metrics=None,
    ):
        if grow <= 1.0 or not 0.0 < shrink < 1.0:
            raise ValueError("need grow > 1 and 0 < shrink < 1")
        self.window_s = deadline_ms / 1e3
        self.min_s = (min_ms if min_ms is not None else deadline_ms / 4) / 1e3
        self.max_s = (max_ms if max_ms is not None else deadline_ms * 8) / 1e3
        if not self.min_s <= self.window_s <= self.max_s:
            raise ValueError(
                f"deadline {self.window_s}s outside [{self.min_s}, {self.max_s}]")
        self.low_fill = low_fill
        self.grow = grow
        self.shrink = shrink
        self.grows = 0
        self.shrinks = 0
        if metrics is not None:
            self._m_window = metrics.gauge("ingest.adaptive_window_s")
            self._m_window.set(self.window_s)
            self._m_grow = metrics.counter("ingest.adaptive_grow")
            self._m_shrink = metrics.counter("ingest.adaptive_shrink")
        else:
            self._m_window = self._m_grow = self._m_shrink = None

    @property
    def deadline_s(self) -> float:
        return self.window_s

    def on_emit(self, n_events: int, width: int, pending: int,
                reason: str) -> None:
        """Observe one emission (``reason``: "fill" | "deadline" |
        "flush") and adjust the window.  Flush emits never adapt."""
        if reason == "flush":
            return
        if reason == "fill" or pending >= width:
            new = min(self.window_s * self.grow, self.max_s)
            if new != self.window_s:
                self.window_s = new
                self.grows += 1
                if self._m_grow is not None:
                    self._m_grow.inc()
                    self._m_window.set(new)
        elif reason == "deadline" and pending == 0 \
                and n_events <= self.low_fill * width:
            new = max(self.window_s * self.shrink, self.min_s)
            if new != self.window_s:
                self.window_s = new
                self.shrinks += 1
                if self._m_shrink is not None:
                    self._m_shrink.inc()
                    self._m_window.set(new)


class Batcher:
    """Assembles fixed-shape event batches (see module docstring).

    ``resolve_device(token) -> int`` / ``resolve_mtype(name) -> int`` /
    ``resolve_alert(name) -> int`` map edge strings to dense handles.
    """

    def __init__(
        self,
        width: int,
        n_shards: int,
        registry_capacity: int,
        resolve_device: Callable[[str], int],
        resolve_mtype: Callable[[str], int],
        resolve_alert: Callable[[str], int],
        invocations=None,  # HandleSpace-like (mint/lookup) for
                           # invocation-token correlation
        deadline_ms: float = 5.0,
        clock: Callable[[], float] = span_clock,
        emit_packed: bool = False,
        metrics=None,
        controller: Optional[AdaptiveBatchController] = None,
    ):
        if width % n_shards != 0:
            raise ValueError(
                f"width={width} not divisible by n_shards={n_shards}")
        # the routing invariant, checked at construction
        shard_for_device(0, registry_capacity, n_shards)
        self.width = width
        self.n_shards = n_shards
        self.seg = width // n_shards
        self.capacity = registry_capacity
        self.rows_per_shard = registry_capacity // n_shards
        self.resolve_device = resolve_device
        self.resolve_mtype = resolve_mtype
        self.resolve_alert = resolve_alert
        self.invocations = invocations
        self._deadline_s = deadline_ms / 1e3
        # Optional adaptive window: when set, the controller owns the
        # deadline and the static value above is only the fallback.
        self.controller = controller
        self.clock = clock
        self.emit_packed = emit_packed
        self._pending: List[Deque[_Chunk]] = [
            collections.deque() for _ in range(n_shards)]
        self._counts = [0] * n_shards
        self._oldest: Optional[float] = None
        self._rr = 0  # round-robin shard for unknown devices
        self.emitted_batches = 0
        self.emitted_events = 0
        # Bytes memcpy'd during batch assembly (intake copies + emission
        # slice copies).
        self.copied_bytes = 0
        self.metrics = metrics
        if metrics is not None:
            self._m_batches = metrics.counter("ingest.batches_emitted")
            self._m_rows = metrics.counter("ingest.rows_emitted")
            self._m_fill = metrics.gauge("ingest.batch_fill")
            self._m_wait = metrics.histogram("ingest.batch_wait_s")
            self._m_copied = metrics.counter("pipeline.bytes_copied.batch")
        else:
            self._m_copied = None

    @property
    def deadline_s(self) -> float:
        if self.controller is not None:
            return self.controller.deadline_s
        return self._deadline_s

    @deadline_s.setter
    def deadline_s(self, value: float) -> None:
        self._deadline_s = float(value)
        if self.controller is not None:
            # write-through: an explicit set re-anchors the adaptive
            # window (still clamped to its [min_s, max_s])
            c = self.controller
            c.window_s = min(max(float(value), c.min_s), c.max_s)
            if c._m_window is not None:
                c._m_window.set(c.window_s)

    # -- intake: scalar paths ------------------------------------------------

    def add(self, req: DecodedRequest, tenant_id: int,
            payload_ref: int, origin: str = "stream",
            origin_seq: int = -1) -> Optional[BatchPlan]:
        """Queue one decoded event; returns a plan if the segment filled.
        ``origin``/``origin_seq`` as in :meth:`add_arrays`."""
        et = req.event_type
        if et is None:
            raise ValueError(
                f"{req.kind.name} is a host-plane request, not a pipeline event"
            )
        return self._enqueue_row(
            origin, origin_seq,
            device_id=self.resolve_device(req.device_token),
            tenant_id=tenant_id,
            event_type=int(et),
            ts_s=req.ts_s,
            ts_ns=req.ts_ns,
            mtype_id=self.resolve_mtype(req.mtype) if req.mtype else NULL_ID,
            value=req.value,
            lat=req.lat,
            lon=req.lon,
            elevation=req.elevation,
            alert_code=(self.resolve_alert(req.alert_type)
                        if req.alert_type else NULL_ID),
            alert_level=int(req.alert_level),
            # responses/invocations correlate through the invocation token
            command_id=self._invocation_id(req),
            payload_ref=payload_ref,
            update_state=bool(req.update_state),
        )

    def _enqueue_row(self, origin: str, origin_seq: int,
                     **values) -> Optional[BatchPlan]:
        """Routing/append/deadline/emit tail of the scalar path."""
        device_id = values["device_id"]
        if 0 <= device_id < self.capacity:
            shard = device_id // self.rows_per_shard
        else:
            values["device_id"] = NULL_ID
            shard = self._rr = (self._rr + 1) % self.n_shards
        now = self.clock()
        q = self._pending[shard]
        tail = q[-1] if q else None
        if (tail is None or tail.length >= tail.capacity
                or tail.origin != origin or tail.origin_seq != origin_seq):
            tail = _Chunk(
                cols={f: np.empty(self.seg, _DTYPE[f]) for f in _COL_FIELDS},
                length=0,
                arrival=now,
                origin=origin,
                origin_seq=origin_seq,
            )
            q.append(tail)
        i = tail.length
        for f in _COL_FIELDS:
            tail.cols[f][i] = values[f]
        tail.length = i + 1
        self._counts[shard] += 1
        if self._oldest is None:
            self._oldest = now
        if self._counts[shard] >= self.seg:
            return self._emit()
        return None

    # -- intake: vectorized paths -------------------------------------------

    def add_arrays(self, _copy: bool = True,
                   received_at: Optional[float] = None,
                   origin: str = "stream", origin_seq: int = -1,
                   **columns) -> List[BatchPlan]:
        """Columnar intake: queue N pre-resolved rows from 1-D arrays.

        ``device_id`` is required; any other batch column
        (:data:`_COL_FIELDS`) may be supplied as an array of the same
        length or omitted to take its fill value.  Returns every plan that
        became ready (several when N spans several widths).

        ``received_at`` (on :attr:`clock`) is when the rows' payload was
        received, before its decode; a plan's ``received_at`` is its
        oldest row's.  Omitted, it is the time of this call.

        ``origin`` names where the rows come from (``stream``, or the
        re-injection that made them) and ``origin_seq`` the seq of the
        plan whose egress re-injected them.

        ``_copy=False`` is for internal callers that hand over freshly
        built arrays they will never touch again; external callers keep
        the default so refilling their buffers cannot corrupt queued rows.
        """
        device_id = np.asarray(columns["device_id"], np.int32)
        n = len(device_id)
        if n == 0:
            return []
        cols: Dict[str, np.ndarray] = {}
        filled: set = set()
        for f in _COL_FIELDS:
            v = columns.get(f)
            if f == "device_id":
                cols[f] = device_id
            elif v is None:
                # zero-alloc fill: a 0-stride read-only broadcast
                cols[f] = np.broadcast_to(_FILL_0D[f], n)
                filled.add(f)
            else:
                if not (type(v) is np.ndarray and v.dtype == _DTYPE[f]
                        and v.ndim == 1):
                    v = np.asarray(v, _DTYPE[f])
                cols[f] = v
                if len(v) != n:
                    raise ValueError(
                        f"column {f!r} length {len(v)} != {n}")
        unknown_keys = set(columns) - set(_COL_FIELDS)
        if unknown_keys:
            raise ValueError(f"unknown columns {sorted(unknown_keys)}")

        in_range = (device_id >= 0) & (device_id < self.capacity)
        if self.n_shards == 1:
            shard = None  # everything lands on shard 0
            if not in_range.all():
                cols["device_id"] = np.where(in_range, device_id, NULL_ID)
        else:
            shard = device_id // self.rows_per_shard
            bad = ~in_range
            if bad.any():
                k = int(bad.sum())
                shard[bad] = (self._rr + np.arange(k)) % self.n_shards
                self._rr = (self._rr + k) % self.n_shards
                cols["device_id"] = np.where(bad, NULL_ID, device_id)

        now = self.clock()
        if self.n_shards == 1:
            # Copy caller-backed columns: rows can sit queued past this
            # call (up to the deadline), and a caller refilling its
            # buffers must not corrupt queued events.  (The sharded path
            # copies through its mask gathers.)
            if _copy:
                copied = {
                    f for f, c in cols.items()
                    if f not in filled
                    and (c is columns.get(f) or c.base is not None)
                }
                self._count_copied(sum(cols[f].nbytes for f in copied))
                cols = {
                    f: (np.array(c, copy=True) if f in copied else c)
                    for f, c in cols.items()
                }
            self._pending[0].append(_Chunk(
                cols=cols, length=n, arrival=now, received=received_at,
                origin=origin, origin_seq=origin_seq))
            self._counts[0] += n
        else:
            for s in range(self.n_shards):
                m = shard == s
                c = int(m.sum())
                if c == 0:
                    continue
                self._pending[s].append(_Chunk(
                    cols={f: cols[f][m] for f in _COL_FIELDS},
                    length=c, arrival=now, received=received_at,
                    origin=origin, origin_seq=origin_seq))
                self._count_copied(c * (_ROW_BYTES - 1))  # mask gathers
                self._counts[s] += c
        if self._oldest is None:
            self._oldest = now

        plans: List[BatchPlan] = []
        while max(self._counts) >= self.seg:
            plans.append(self._emit())
        return plans

    def reserve(self, cap: int) -> Optional[Reservation]:
        """A :class:`Reservation` of up to ``cap`` rows for the fill-direct
        scanner, or None when ``cap`` is out of range (a payload wider than
        one batch cannot land in one emission).  The buffers are private
        until ``commit``: reserve is safe from any thread."""
        if not 0 < cap <= self.width:
            return None
        return Reservation(self, cap)

    def _count_copied(self, nbytes: int) -> None:
        if nbytes:
            self.copied_bytes += nbytes
            if self._m_copied is not None:
                self._m_copied.inc(nbytes)

    def _invocation_id(self, req: DecodedRequest) -> int:
        """Invocation rows MINT their token; responses only LOOK UP, so a
        device sending garbage originatingEventId values cannot allocate
        handles."""
        inv = self.invocations
        if inv is None or not req.originating_event:
            return NULL_ID
        if req.kind == RequestKind.COMMAND_INVOCATION:
            return inv.mint(req.originating_event)
        return inv.lookup(req.originating_event)

    def add_requests(
        self,
        reqs: Sequence[DecodedRequest],
        tenant_ids: Sequence[int],
        payload_refs: Sequence[int],
    ) -> List[BatchPlan]:
        """Batch intake of decoded requests: one token-resolution pass
        builds the column arrays, then :meth:`add_arrays`."""
        n = len(reqs)
        if n == 0:
            return []
        out = {f: np.empty(n, _DTYPE[f]) for f in _COL_FIELDS}
        rd, rm, ra = self.resolve_device, self.resolve_mtype, self.resolve_alert
        for i, req in enumerate(reqs):
            et = req.event_type
            if et is None:
                raise ValueError(
                    f"{req.kind.name} is a host-plane request, not a pipeline event"
                )
            out["device_id"][i] = rd(req.device_token)
            out["event_type"][i] = int(et)
            out["ts_s"][i] = req.ts_s
            out["ts_ns"][i] = req.ts_ns
            out["mtype_id"][i] = rm(req.mtype) if req.mtype else NULL_ID
            out["value"][i] = req.value
            out["lat"][i] = req.lat
            out["lon"][i] = req.lon
            out["elevation"][i] = req.elevation
            out["alert_code"][i] = ra(req.alert_type) if req.alert_type else NULL_ID
            out["alert_level"][i] = int(req.alert_level)
            out["update_state"][i] = bool(req.update_state)
            out["command_id"][i] = self._invocation_id(req)
        out["tenant_id"][:] = np.asarray(tenant_ids, np.int32)
        out["payload_ref"][:] = np.asarray(payload_refs, np.int32)
        return self.add_arrays(_copy=False, **out)  # freshly built here

    # -- deadline/flush ------------------------------------------------------

    def poll(self) -> Optional[BatchPlan]:
        """Emit on deadline: call periodically from the dispatch loop."""
        if self._oldest is None:
            return None
        if self.clock() - self._oldest >= self.deadline_s:
            return self._emit(reason="deadline")
        return None

    def flush(self) -> Optional[BatchPlan]:
        """Emit whatever is pending (shutdown/drain)."""
        if self._oldest is None:
            return None
        return self._emit(reason="flush")

    @property
    def pending(self) -> int:
        return sum(self._counts)

    # -- emission -----------------------------------------------------------

    def _emit_tail(self, n: int, reason: str):
        """Shared emission bookkeeping: wait accounting, counters,
        adaptive-controller feedback.  Returns ``(now, wait)``."""
        now = self.clock()
        wait = now - self._oldest if self._oldest is not None else 0.0
        # carried-over rows keep their chunk arrival time for the deadline
        oldest = None
        for q in self._pending:
            if q and (oldest is None or q[0].arrival < oldest):
                oldest = q[0].arrival
        self._oldest = oldest
        self.emitted_batches += 1
        self.emitted_events += n
        if self.metrics is not None:
            self._m_batches.inc()
            self._m_rows.inc(n)
            self._m_fill.set(n / self.width)
            self._m_wait.observe(wait)
        if self.controller is not None:
            self.controller.on_emit(n, self.width, self.pending, reason)
        return now, wait

    def _assemble_buffers(self):
        """Batch-assembly buffers.  Packed mode builds the host columns
        directly as rows of the packed buffers, so the fill loop writes
        through the ``out`` views; bool columns keep their own arrays
        (host_cols consumers expect bool) and land in their int rows at
        the end."""
        if not self.emit_packed:
            return None, None, {
                name: np.full(self.width, fill, dtype=dt)
                for name, dt, fill in _FIELDS
            }
        ibuf = np.empty((len(BATCH_I), self.width), np.int32)
        fbuf = np.empty((len(BATCH_F), self.width), np.float32)
        out = {}
        for i, f in enumerate(BATCH_I):
            if f in ("valid", "update_state"):
                out[f] = np.full(self.width, _FILL[f], np.bool_)
            else:
                ibuf[i].fill(_FILL[f])
                out[f] = ibuf[i]
        for i, f in enumerate(BATCH_F):
            fbuf[i].fill(_FILL[f])
            out[f] = fbuf[i]
        out["valid"][:] = False
        return ibuf, fbuf, out

    def _adoptable_sharded(self) -> bool:
        """True when every shard's sole pending chunk is the matching
        segment of ONE full-width reservation: ``_commit_sharded`` left
        segment-aligned views, so the reserved buffers already ARE the
        batch."""
        res = None
        for s in range(self.n_shards):
            q = self._pending[s]
            if len(q) != 1:
                return False
            ch = q[0]
            if ch.reserved is None or ch.start != 0 \
                    or ch.length != self.seg \
                    or ch.res_off != s * self.seg:
                return False
            if res is None:
                res = ch.reserved
            elif ch.reserved is not res:
                return False
        return res is not None and res.cap == self.width

    @hot_path
    def _emit_adopted(self, reason: str) -> BatchPlan:
        """Zero-copy emission: the pending chunk(s) are a full-width
        reserved segment, and its packed buffers become the batch.  Only
        validity, the per-payload constants and any padding are written;
        no row data moves.  (Sharded: one view-chunk per shard, all of
        the same reservation, popped together.)"""
        res = None
        n = 0
        received = None
        oldest = None
        for s in range(self.n_shards):
            ch = self._pending[s].popleft()
            res = ch.reserved
            n += ch.length
            self._counts[s] -= ch.length
            got = ch.arrival if ch.received is None else ch.received
            received = got if received is None else min(received, got)
            if oldest is None or ch.arrival < oldest.arrival:
                oldest = ch
        host_cols = res.finalize_adopted(n)
        now, wait = self._emit_tail(n, reason)
        return BatchPlan(
            batch=None, n_events=n, width=self.width, created_at=now,
            max_wait_s=wait, host_cols=host_cols,
            packed_i=res.ibuf, packed_f=res.fbuf,
            seq=self.emitted_batches - 1, reason=reason,
            received_at=received, origin=oldest.origin,
            origin_seq=oldest.origin_seq,
        )

    @hot_path
    def _emit(self, reason: str = "fill") -> BatchPlan:
        if self.emit_packed:
            q = self._pending[0]
            if self.n_shards == 1:
                if len(q) == 1 and q[0].reserved is not None \
                        and q[0].start == 0 \
                        and q[0].reserved.cap == self.width:
                    return self._emit_adopted(reason)
            elif q and q[0].reserved is not None \
                    and self._adoptable_sharded():
                return self._emit_adopted(reason)
        ibuf, fbuf, out = self._assemble_buffers()
        n = 0
        received = None
        oldest = None
        for s in range(self.n_shards):
            base = s * self.seg
            filled = 0
            q = self._pending[s]
            while filled < self.seg and q:
                ch = q[0]
                got = ch.arrival if ch.received is None else ch.received
                received = got if received is None else min(received, got)
                if oldest is None or ch.arrival < oldest.arrival:
                    oldest = ch
                take = min(ch.length - ch.start, self.seg - filled)
                lo, hi = base + filled, base + filled + take
                for f in _COL_FIELDS:
                    out[f][lo:hi] = ch.cols[f][ch.start:ch.start + take]
                out["valid"][lo:hi] = True
                ch.start += take
                filled += take
                if ch.start >= ch.length:
                    # fully drained (staging chunks included: dropping
                    # them keeps a later append from resurrecting
                    # emitted rows)
                    q.popleft()
            self._counts[s] -= filled
            n += filled
        self._count_copied(n * _ROW_BYTES)

        now, wait = self._emit_tail(n, reason)
        origin, origin_seq = ((oldest.origin, oldest.origin_seq)
                              if oldest is not None else ("stream", -1))
        if self.emit_packed:
            ibuf[BATCH_I.index("valid")] = out["valid"]
            ibuf[BATCH_I.index("update_state")] = out["update_state"]
            self._count_copied(2 * 4 * self.width)  # bool->int32 rows
            return BatchPlan(
                batch=None, n_events=n, width=self.width, created_at=now,
                max_wait_s=wait, host_cols=out, packed_i=ibuf, packed_f=fbuf,
                seq=self.emitted_batches - 1, reason=reason,
                received_at=received, origin=origin, origin_seq=origin_seq,
            )
        # No device work here: _emit runs under the dispatcher's intake
        # lock, so the EventBatch is materialized later, off the lock.
        return BatchPlan(
            batch=None, n_events=n, width=self.width, created_at=now,
            max_wait_s=wait, host_cols=out,
            seq=self.emitted_batches - 1, reason=reason,
            received_at=received, origin=origin, origin_seq=origin_seq,
        )
