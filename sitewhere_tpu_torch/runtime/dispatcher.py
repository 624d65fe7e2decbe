"""Pipeline dispatcher: the host loop driving the fused step on one card.

Counterpart of ``sitewhere_tpu/runtime/dispatcher.py`` for one chip.
One host thread cycles

    wire bytes -> journal -> decode -> batcher -> step (device) -> egress

where egress covers accepted rows to the event store, accepted command
invocations to command delivery, unregistered rows to the registration
manager (and replay), derived alerts re-injected as
first-class events, and the new state committed to the
:class:`~sitewhere_tpu_torch.state.manager.DeviceStateManager`.

- DECODE runs the C scanners of the native wire tier
  (:meth:`decode_wire_lines`): a homogeneous measurement payload scans
  straight into a batcher :class:`~..ingest.batcher.Reservation`
  (fill-direct), which a full-width payload's plan adopts as its packed
  buffers; other payloads take the C event-family scanners, and shapes
  no scanner takes the pure-Python lane.  ``start()`` builds the scanner
  library (and raises if it cannot).
- H2D: a plan's packed buffers go to the card through pinned buffers
  without blocking (``_stage_plan``), so a plan's copy overlaps the
  previous step.
- The STEP runs on the K-deep ring when ``ring_depth >= 2``: full-width
  fill plans collect in ``_ring`` and one K-step chain steps them all,
  with one shared device-to-host copy (:class:`RingFetch`) and so one
  host sync per K steps.  Deadline/flush partials, re-injected plans and
  replay take the single-step path (:meth:`_dispatch_plan`), draining
  ring-held predecessors in order first.
- EGRESS runs on a supervised offload worker (:meth:`_egress_worker`)
  when the dispatcher runs on a card (the reference's rule: off on the
  CPU); it reads each step's outputs from a copy started at dispatch and
  waits on that copy's CUDA event only.  Egress appends the accepted rows
  to the event store, the segment store
  (:class:`~sitewhere_tpu_torch.store.segmented.SegmentStore`) in an
  ``Instance``.  The journal offset commits only past plans whose egress
  completed, and only after the store's ``flush()`` has sealed every
  buffered row to disk (:meth:`_maybe_commit_offset`).  After the
  store, egress offers the accepted rows, with the committed journal
  offset, to the streaming analytics runner (``analytics``,
  :class:`~sitewhere_tpu_torch.analytics.runner.QueryRunner`), then to
  the tenant rule engine (``rules_engine``,
  :class:`~sitewhere_tpu_torch.rules.engine.RuleEngineRunner`), whose
  fired programs come back through :meth:`inject_rule_alerts` as ALERT
  events.
- RECOVERY: :meth:`replay_journal` re-ingests journal records from the
  committed offset, or from a checkpoint's replay floor below it; rows
  below the committed offset re-run their state effects but are not
  stored twice (``store_dedup_floor``).

A device fault propagates: the plan stays outstanding, the commit gate
stays closed, and journal replay recovers the plan.  There is no CPU
level and no containment here (bisection, breaker and watchdog come with
the device-guard slice).  Backend switches follow the reference's
non-TPU branch until an H100 measurement chooses: ``inflight_depth`` 1,
ring depth :func:`~sitewhere_tpu_torch.pipeline.packed.ring_depth_default`
(0 unless ``SW_TPU_RING_DEPTH`` is set), egress offload on off the CPU.
"""

from __future__ import annotations

import collections
import collections.abc
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from sitewhere_tpu_torch import native
from sitewhere_tpu_torch.analysis.markers import hot_path
from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.ids import NULL_ID
from sitewhere_tpu_torch.ingest.batcher import (
    _COL_FIELDS,
    Batcher,
    BatchPlan,
    Reservation,
)
from sitewhere_tpu_torch.ingest.columnar import (
    CopyTally,
    RecordEvents,
    _native_decode_resolved,
    decode_fill_direct,
    decode_json_lines,
    fill_direct_ready,
    n_rows,
    resolve_columns,
    space_of,
)
from sitewhere_tpu_torch.ingest.decoders import (
    DecodedRequest,
    DecodeError,
    JsonLinesDecoder,
    RequestKind,
)
from sitewhere_tpu_torch.ingest.journal import Journal, JournalReader
from sitewhere_tpu_torch.pipeline.packed import (
    BATCH_F,
    BATCH_I,
    PackedView,
    RingFetch,
    RingStepView,
    build_packed_chain,
    pack_outputs,
    pack_tables,
    packed_pipeline_step,
    ring_depth_default,
    stage_packed_batch,
)
from sitewhere_tpu_torch.pipeline.step import pipeline_step
from sitewhere_tpu_torch.runtime import faults
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry
from sitewhere_tpu_torch.runtime.resilience import (
    RetryPolicy,
    Supervisor,
    dead_letter,
)
from sitewhere_tpu_torch.runtime.tracing import _NOOP_TRACE, Tracer
from sitewhere_tpu_torch.schema import EventBatch, EventType
from sitewhere_tpu_torch.state.presence import (
    STATE_CHANGE_QUARANTINED,
    state_changes_for,
)
from sitewhere_tpu_torch.store import segment as _segment_schema

logger = logging.getLogger("sitewhere_tpu_torch.dispatcher")

# Journal records whose re-decoded events registration keeps: a plan
# touches at most two records of a full-width payload stream, the next
# plan one of the same two
_REDECODED_RECORDS = 2

# egress-view split of the stored row schema: the 5 step-output
# enrichment columns, and everything else (minus the store-stamped
# receive time) resolving straight out of plan.host_cols.
_EGRESS_ENRICHMENT = ("device_type_id", "assignment_id", "area_id",
                      "customer_id", "asset_id")
_EGRESS_HOST = tuple(
    n for n in _segment_schema.COLUMN_NAMES
    if n not in _EGRESS_ENRICHMENT and n != "received_s"
)


class EgressColumns(collections.abc.Mapping):
    """Zero-copy egress column view over one plan's host columns plus
    the step's enrichment outputs.

    Host columns resolve straight out of ``plan.host_cols``; the
    enrichment columns (``device_type_id`` ... ``asset_id``) are read from
    the step's output view on first access and memoized, after which the
    view is dropped, so a view a consumer keeps never pins the step's
    buffers."""

    ENRICHMENT_COLUMNS = _EGRESS_ENRICHMENT
    _ENRICH_SET = frozenset(_EGRESS_ENRICHMENT)
    HOST_COLUMNS = _EGRESS_HOST
    _HOST_SET = frozenset(_EGRESS_HOST)

    __slots__ = ("_host", "_out", "_fetched", "_fetch_lock")

    def __init__(self, host_cols: Dict[str, np.ndarray], out):
        self._host = host_cols
        self._out = out
        self._fetched: Optional[Dict[str, np.ndarray]] = None
        # a consumer may read the view from its own thread: the
        # enrichment read must be thread-safe
        self._fetch_lock = threading.Lock()

    def _enrichment(self) -> Dict[str, np.ndarray]:
        fetched = self._fetched
        if fetched is None:
            with self._fetch_lock:
                fetched = self._fetched
                if fetched is None:
                    out = self._out
                    fetched = {
                        n: np.asarray(getattr(out, n))
                        for n in self.ENRICHMENT_COLUMNS
                    }
                    self._fetched = fetched
                    self._out = None
        return fetched

    def __getitem__(self, name: str) -> np.ndarray:
        if name in self._ENRICH_SET:
            return self._enrichment()[name]
        if name in self._HOST_SET and name in self._host:
            return self._host[name]
        raise KeyError(name)

    def __contains__(self, name) -> bool:
        return (name in self._ENRICH_SET
                or (name in self._HOST_SET and name in self._host))

    def __iter__(self):
        for name in self.HOST_COLUMNS:
            if name in self._host:
                yield name
        yield from self.ENRICHMENT_COLUMNS

    def __len__(self) -> int:
        return (sum(1 for n in self.HOST_COLUMNS if n in self._host)
                + len(self.ENRICHMENT_COLUMNS))


class PipelineDispatcher(LifecycleComponent):
    """Owns the ingest -> step -> egress loop for one card.

    Collaborators are duck-typed providers, so tests can compose subsets:

    - ``registry_provider()`` / ``zones_provider()`` / ``rules_provider()``
      -> current device-resident epochs (RegistryMirror / RuleManager)
    - ``state_manager`` -> DeviceStateManager (commit + sweeps)
    - ``event_store`` -> accepted-row persistence:
      ``append_columns(cols, mask=)`` at egress and ``flush()`` (sealing
      every buffered row durably, raising if it cannot) before each
      offset commit; a ``SegmentStore`` in an ``Instance``
    - ``registration`` -> registration manager (process_unregistered);
      None = unregistered rows only dead-letter
    - ``on_command_rows(cols, mask, trace=None)`` -> command delivery of
      the accepted COMMAND_INVOCATION rows (``trace`` is the plan's, so
      the delivery span joins it); None = they are only stored
    - ``analytics`` -> the streaming query runner (``submit_live`` with
      ``committed=``, a non-blocking bounded offer); None = no live
      queries
    - ``rules_engine`` -> the tenant rule engine (``submit_live``, a
      non-blocking bounded offer); None = no BYO rule programs

    ``device`` is where the step runs: ``None`` means the card and raises
    without one; the CPU only when named.
    """

    def __init__(
        self,
        batcher: Batcher,
        registry_provider: Callable[[], object],
        state_manager,
        rules_provider: Callable[[], object],
        zones_provider: Callable[[], object],
        event_store=None,
        registration=None,
        on_command_rows: Optional[Callable[..., None]] = None,
        rules_engine=None,
        analytics=None,
        journal: Optional[Journal] = None,
        dead_letters: Optional[Journal] = None,
        resolve_tenant: Optional[Callable[[str], int]] = None,
        max_replay_depth: int = 4,
        inflight_depth: Optional[int] = None,
        journal_reader: Optional[JournalReader] = None,
        tracer=None,
        metrics=None,
        egress_offload: Optional[bool] = None,
        ring_depth: Optional[int] = None,
        quarantine_after: int = 3,
        device: DeviceLike = None,
        name: str = "pipeline-dispatcher",
    ):
        super().__init__(name)
        self.device = resolve_device(device)
        self.batcher = batcher
        self.registry_provider = registry_provider
        self.rules_provider = rules_provider
        self.zones_provider = zones_provider
        self.state_manager = state_manager
        self.event_store = event_store
        self.registration = registration
        self.on_command_rows = on_command_rows
        # Bring-your-own rules: egress offers every accepted batch to the
        # engine's bounded queue; its worker evaluates the tenant programs
        # and fired ones re-enter through inject_rule_alerts.
        self.rules_engine = rules_engine
        # Streaming analytics: egress offers every accepted batch, with the
        # committed journal offset as the runner's applied watermark.
        self.analytics = analytics
        self.journal = journal
        self.dead_letters = dead_letters
        self.resolve_tenant = resolve_tenant or (lambda token: 0)
        self.max_replay_depth = max_replay_depth
        self._step = pipeline_step
        self._packed_step = packed_pipeline_step
        self._tables_cache: Optional[tuple] = None
        # Registration's re-decoded journal records, by offset: a line of
        # a record split across two plans is decoded once, not once per
        # plan (records are immutable; the decoded requests are only
        # read)
        self._redecoded: "collections.OrderedDict[int, RecordEvents]" = (
            collections.OrderedDict())
        self._redecoded_lock = threading.Lock()
        # Commit-after-egress stream position: the highest journal offset
        # whose row has completed egress, committed only at quiescent
        # points (no pending rows, no in-flight step).
        self.journal_reader = journal_reader
        self._max_egressed_ref = -1
        # Crash-recovery store dedup: rows whose journal offset is below
        # this floor are durably in the event store already (the commit
        # gate seals BEFORE the offset commits), so a replay that starts
        # below the committed offset, rebuilding state from an older
        # checkpoint, re-runs their state effects without storing them
        # twice.  0 = inactive; set by replay_journal.
        self.store_dedup_floor = 0
        # Plans emitted by the batcher whose egress has not completed
        # (guarded by _lock): the commit gate requires it to be zero.
        self._plans_outstanding = 0
        self._lock = threading.Lock()
        # Serializes read-state -> step -> commit -> egress across the
        # loop thread, source threads and the egress worker.  RLock:
        # replay/derived re-injection recurses.
        self._step_lock = threading.RLock()
        # The reference keeps 8 steps in flight on a TPU and 1 elsewhere;
        # the port takes the non-TPU branch until measured.
        if inflight_depth is None or inflight_depth <= 0:
            inflight_depth = 1
        self.inflight_depth = int(inflight_depth)
        # The K-deep ring: full-width packed plans collect in `_ring`
        # until `ring_depth` are staged, then one K-step chain steps them
        # all with one host sync for the whole ring's egress.  Any value
        # below 2 disables it.
        if ring_depth is None or ring_depth < 0:
            ring_depth = ring_depth_default()
        self.ring_depth = int(ring_depth) if int(ring_depth) >= 2 else 0
        self._ring: List[BatchPlan] = []
        self._ring_chains: Dict[int, Callable] = {}
        # Ring-shaped dispatch scratch, cleared after each dispatch so
        # staged buffers don't outlive their ring.
        self._ring_slots_i: List = [None] * self.ring_depth
        self._ring_slots_f: List = [None] * self.ring_depth
        if self.ring_depth:
            # the in-flight window holds at least two rings so chain N+1
            # dispatches while ring N's egress drains
            self.inflight_depth = max(self.inflight_depth,
                                      2 * self.ring_depth)
        self._inflight: collections.deque = collections.deque()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Egress offload: between start() and stop() a supervised worker
        # pulls dispatched steps off _inflight and runs the host fan-out.
        # The reference turns it on off the CPU (on the CPU the GIL
        # serializes the stages anyway); the card is not a CPU.
        if egress_offload is None:
            egress_offload = self.device.type != "cpu"
        self.egress_offload = bool(egress_offload)
        self.egress_queue_depth = max(2, self.inflight_depth)
        self._egress_super: Optional[Supervisor] = None
        self._egress_busy = False
        self._egress_stop = threading.Event()
        self._egress_evt = threading.Event()   # work queued
        self._room_evt = threading.Event()     # slot freed
        self.egress_failures = 0
        # Per-plan end-to-end latency samples: from the receipt of the
        # payload of the plan's oldest row (before its decode; see
        # ``ingest_wire_lines``) to egress complete.
        self.latencies_s: collections.deque = collections.deque(maxlen=4096)
        # Span tracing: no-op unless a sampling tracer is passed.
        self.tracer = tracer if tracer is not None else Tracer(
            sample_rate=0.0)
        # Instruments are bound once here, under the reference's names.
        if metrics is None:
            metrics = MetricsRegistry()
        self.metrics = metrics
        self._m_e2e = metrics.histogram("pipeline.e2e_latency_s")
        self._m_assemble = metrics.histogram("pipeline.batch_assemble_s")
        self._m_steps = metrics.counter("pipeline.steps")
        # Per-stage host time: when the stage totals exceed wall elapsed,
        # the stages provably overlap.
        self._m_stage = {
            s: metrics.timer(f"pipeline.stage_{s}_s")
            for s in ("decode", "batch", "dispatch", "egress",
                      "ring_wait", "ring_dispatch", "h2d")
        }
        # Egress legs and table republishes, host seconds each
        self._m_leg = {
            s: metrics.timer(f"pipeline.{s}_s")
            for s in ("egress_registration", "egress_commands",
                      "registry_publish", "tables_repack")
        }
        # One inc per BLOCKING device-to-host wait on the dispatch/egress
        # path: a view's first read (single step) or a ring's shared
        # fetch.  With the ring on, host_syncs / steps is 1/K.
        self._m_host_syncs = metrics.counter("pipeline.host_syncs")
        # Bytes copied per host stage: the fill-direct decode adds nothing
        # to decode (the C scan writes once, into the batcher's packed
        # rows), an adopted reservation nothing to the batcher's batch
        # count; h2d counts the staged transfer bytes.
        self._m_decode_bytes = metrics.counter(
            "pipeline.bytes_copied.decode")
        self._m_h2d_bytes = metrics.counter("pipeline.bytes_copied.h2d")
        # decodes that took the pure-Python lane for want of the native
        # tier (``native.build_fallbacks``; 0 in the port, whose build
        # blocks), sampled by the loop thread
        self._m_native_fb = metrics.gauge("native.build_fallbacks")
        self._m_ring_chains = metrics.counter("pipeline.ring_chains")
        self._m_ring_flushes = metrics.counter("pipeline.ring_flushes")
        self._m_egress_fail = metrics.counter("pipeline.egress_failures")
        self._m_stall_overflow = metrics.counter(
            "pipeline.egress_stall_overflows")
        self._m_queue = metrics.gauge("ingest.queue_depth")
        self._m_inflight = metrics.gauge("pipeline.inflight_steps")
        self._m_seal = metrics.gauge("pipeline.ingest_to_seal_latency_s")
        self._m_totals = {
            key: metrics.counter(f"pipeline.events_{key}")
            for key in ("processed", "accepted", "unregistered",
                        "unassigned", "threshold_alerts", "zone_alerts")
        }
        # On-device occupancy telemetry (the packed metrics vector's
        # TELEMETRY_SCALARS), surfaced as last-batch gauges.
        self._m_occ = {
            key: metrics.gauge(f"device.occupancy.{key}")
            for key in ("rows_admitted", "rows_invalid", "rules_fired",
                        "state_writes", "presence_merges")
        }
        self._m_quar_devices = metrics.gauge("pipeline.quarantine.devices")
        self._m_quar_rows = metrics.counter(
            "pipeline.quarantine.rows_nonfinite")
        self._m_quar_changes = metrics.counter(
            "pipeline.quarantine.state_changes")
        # NaN/Inf quarantine: host policy over the device-counted
        # rows_nonfinite scalar; a device crossing `quarantine_after`
        # cumulative poison rows emits one STATE_CHANGE through egress.
        self.quarantine_after = max(1, int(quarantine_after))
        self._nonfinite_seen: Dict[int, int] = {}
        self._quarantined: set = set()
        # host-aggregated counters (metrics endpoint surface)
        self.steps = 0
        self.totals: Dict[str, int] = {
            "processed": 0, "accepted": 0, "unregistered": 0,
            "unassigned": 0, "threshold_alerts": 0, "zone_alerts": 0,
            "replayed": 0, "derived_alerts": 0, "commands": 0,
        }

    # -- ingest entry points ------------------------------------------------

    def _take(self, intake: Callable[[], object]) -> List[BatchPlan]:
        """Run a batcher intake under the lock, counting every emitted plan
        as outstanding until its egress completes (the commit gate's
        accounting, see :meth:`_maybe_commit_offset`)."""
        t0 = time.perf_counter()
        with self._lock:
            out = intake()
            if out is None:
                plans: List[BatchPlan] = []
            elif isinstance(out, list):
                plans = [p for p in out if p is not None]
            else:
                plans = [out]
            self._plans_outstanding += len(plans)
        if plans:
            self._m_stage["batch"].observe(time.perf_counter() - t0)
        return plans

    def _run_plans(self, plans: List[BatchPlan],
                   replay_depth: int = 0) -> None:
        """Stage every plan's H2D copy up front, then step them: with 2+
        plans from one intake the later copies overlap the earlier
        steps."""
        for plan in plans:
            self._stage_plan(plan)
        for plan in plans:
            self._run_plan(plan, replay_depth)

    def _stage_plan(self, plan: BatchPlan) -> None:
        """Start the H2D copy of a plan: packed buffers through pinned
        memory without blocking, or an unpacked plan's EventBatch."""
        if plan.staged is None and plan.packed_i is not None:
            plan.staged = stage_packed_batch(plan.packed_i, plan.packed_f,
                                             self.device)
            self._m_h2d_bytes.inc(
                plan.packed_i.nbytes + plan.packed_f.nbytes)
        elif plan.packed_i is None and plan.batch is None \
                and plan.host_cols:
            t0 = time.perf_counter()
            plan.materialize_batch(self.device)
            self._m_stage["h2d"].observe(time.perf_counter() - t0)

    def ingest(self, req: DecodedRequest, payload: bytes = b"",
               source_id: str = "ingest") -> None:
        """Queue one decoded request (journal it first: at-least-once)."""
        ref = NULL_ID
        if self.journal is not None and payload:
            ref = self.journal.append(payload)
        tenant_id = self.resolve_tenant(req.metadata.get("tenant", "default")
                                        if req.metadata else "default")
        self._run_plans(self._take(
            lambda: self.batcher.add(req, tenant_id=tenant_id,
                                     payload_ref=ref)))

    def ingest_many(self, reqs: List[DecodedRequest],
                    payload: bytes = b"",
                    source_id: str = "ingest") -> None:
        """Intake of one wire payload's decoded events: one resolution
        pass, and the payload journals ONCE (every row shares the
        offset)."""
        if not reqs:
            return
        # validate BEFORE journaling, so a host-plane request in the
        # batch can't leave an orphaned journal record behind an error
        for r in reqs:
            if r.event_type is None:
                raise ValueError(
                    f"{r.kind.name} is a host-plane request, not a pipeline event"
                )
        ref = NULL_ID
        if self.journal is not None and payload:
            ref = self.journal.append(payload)
        tenants = [
            self.resolve_tenant(r.metadata.get("tenant", "default")
                                if r.metadata else "default")
            for r in reqs
        ]
        self._run_plans(self._take(
            lambda: self.batcher.add_requests(reqs, tenants,
                                              [ref] * len(reqs))))

    def ingest_arrays(self, **columns) -> None:
        """Pre-resolved columnar intake (dense handles, no string work).
        Rows without an explicit ``tenant_id`` land in the default
        tenant."""
        if "tenant_id" not in columns:
            n = len(columns["device_id"])
            columns["tenant_id"] = np.full(
                n, self.resolve_tenant("default"), np.int32)
        self._run_plans(self._take(
            lambda: self.batcher.add_arrays(**columns)))

    def ingest_wire_lines(self, payload: bytes, source_id: str = "wire",
                          raise_on_decode_error: bool = False,
                          received_at: Optional[float] = None) -> int:
        """Columnar NDJSON wire intake: bytes -> column arrays -> batcher,
        one journal record shared by every row.  Host-plane lines
        (registrations) take the scalar path; an undecodable payload
        dead-letters whole.  Returns the number of event rows accepted
        into the batcher.

        ``received_at`` (on the batcher's clock) is when the payload's
        bytes arrived; omitted, it is the time of this call.  Each plan's
        latency counts from it, so the decode is inside the number."""
        if received_at is None:
            received_at = self.batcher.clock()
        try:
            columns, host_reqs = self.decode_wire_lines(payload)
        except DecodeError as e:
            if raise_on_decode_error:
                raise
            self.ingest_failed_decode(payload, source_id, e)
            return 0
        return self.ingest_wire_decoded(payload, columns, host_reqs,
                                        source_id=source_id,
                                        received_at=received_at)

    def decode_wire_lines(self, payload: bytes):
        """The pure DECODE stage of :meth:`ingest_wire_lines`: no journal
        append, no state mutation.  Raises :class:`DecodeError`; returns
        ``(columns, host_requests)``.

        Fill-direct: a measurement payload that fits one batch scans
        straight into a private batcher reservation, which rides the
        ``columns`` slot and commits at :meth:`ingest_wire_decoded`.  Any
        shape deviation takes :func:`decode_json_lines`, with the same
        result, errors included."""
        with self._m_stage["decode"].time():
            space = space_of(self.batcher.resolve_device)
            if space is not None and fill_direct_ready(payload):
                res = self.batcher.reserve(payload.count(b"\n") + 1)
                if res is not None and decode_fill_direct(
                        payload, space, res,
                        self.batcher.resolve_mtype) is not None:
                    return res, []
            tally = CopyTally()
            out = decode_json_lines(payload, device_space=space,
                                    copied=tally)
            if tally.n:
                self._m_decode_bytes.inc(tally.n)
            return out

    def ingest_wire_decoded(self, payload: bytes, columns,
                            host_reqs, source_id: str = "wire",
                            received_at: Optional[float] = None) -> int:
        """The ordered INGEST tail of :meth:`ingest_wire_lines`: journal
        once, route host-plane lines, resolve + batch the event rows
        (``received_at``: when the payload arrived, before its decode).
        ``columns`` may be the fill-direct :class:`Reservation`."""
        if isinstance(columns, Reservation):
            return self._ingest_reserved(payload, columns, received_at)
        ref = NULL_ID
        if self.journal is not None and payload:
            ref = self.journal.append(payload)
            # chaos kill point: journaled, never batched; the record is
            # the durable truth and must reappear via replay
            faults.crosspoint("crash.post_journal")
        for req in host_reqs:
            if req.kind == RequestKind.REGISTRATION:
                self.ingest_registration(req, b"")
            elif self.dead_letters is not None:
                # host-plane lines must never silently mint devices
                dead_letter(self.dead_letters, {
                    "kind": "unsupported-wire-line",
                    "request_kind": req.kind.name,
                    "device_token": req.device_token,
                    "payload_ref": int(ref),
                })
        if not columns:
            return 0
        return self._ingest_resolved_columns(columns, ref, received_at)

    def _ingest_reserved(self, payload: bytes, res: Reservation,
                         received_at: Optional[float] = None) -> int:
        """The ordered ingest tail of the fill-direct lane: one journal
        append, the per-payload constants, then the commit under the
        intake lock.  (Overload admission, a whole-payload TELEMETRY
        decision in the reference, comes here, before the journal append,
        with the ``Instance`` slice.)"""
        n = res.n
        ref = NULL_ID
        if self.journal is not None and payload:
            ref = self.journal.append(payload)
            faults.crosspoint("crash.post_journal")
        res.set_const(tenant_id=self.resolve_tenant("default"),
                      payload_ref=ref)
        self._run_plans(self._take(
            lambda: res.commit(received_at=received_at)))
        return n

    def _ingest_resolved_columns(self, columns, ref: int,
                                 received_at: Optional[float] = None) -> int:
        """Resolve one decoded column dict and queue its rows (shared by
        live wire intake and columnar journal replay: rows get ``ref`` as
        payload_ref and land in the default tenant)."""
        n = n_rows(columns)
        if n == 0:
            return 0
        cols = resolve_columns(
            columns,
            self.batcher.resolve_device,
            self.batcher.resolve_mtype,
            self.batcher.resolve_alert,
            invocations=self.batcher.invocations,
        )
        cols["payload_ref"] = np.full(n, ref, np.int32)
        cols["tenant_id"] = np.full(
            n, self.resolve_tenant("default"), np.int32)
        self._run_plans(self._take(
            lambda: self.batcher.add_arrays(
                _copy=False, received_at=received_at, **cols)))
        return n

    def ingest_registration(self, req: DecodedRequest,
                            payload: bytes = b"") -> None:
        if self.registration is not None:
            self.registration.handle_registration(req)

    def ingest_failed_decode(self, payload: bytes, source_id: str,
                             error) -> None:
        if self.dead_letters is not None:
            dead_letter(self.dead_letters,
                        {"kind": "failed-decode", "source": source_id,
                         "error": str(error), "payload": payload.hex()})

    # -- the loop -----------------------------------------------------------

    def start(self) -> None:
        super().start()
        self._stop.clear()
        if self.egress_offload and self._egress_super is None:
            self._egress_stop.clear()
            self._egress_super = Supervisor(
                f"{self.name}-egress", self._egress_worker,
                policy=RetryPolicy(initial_s=0.01, max_s=1.0),
                max_restarts=8, min_uptime_s=5.0,
                metrics=self.metrics)
            self._egress_super.start()
        self._warm_up()
        self._thread = threading.Thread(
            target=self._loop, name=f"{self.name}-loop", daemon=True
        )
        self._thread.start()

    def _warm_up(self) -> None:
        """Build the native wire tier's scanners (and the device space's
        ``TokenTable`` mirror), then run one all-invalid dispatch (a
        semantic no-op: zero valid rows touch no state): the K-step chain
        when the ring is on, else one packed step.  Its first launch
        builds the geofence kernel.  So no live payload pays the ``cc``
        or ``nvcc`` build, and a failure of either raises here, with the
        state manager still holding the pre-boot epoch."""
        native.load_swwire()
        space = space_of(self.batcher.resolve_device)
        if space is not None:
            space.native_table()
        width = self.batcher.width
        bi, bf = stage_packed_batch(
            np.zeros((len(BATCH_I), width), np.int32),
            np.zeros((len(BATCH_F), width), np.float32), self.device)
        tables = self._tables_packed()
        with self._step_lock:
            if self.ring_depth:
                self._dispatch_chain(
                    self._ring_chain(self.ring_depth), tables,
                    [bi] * self.ring_depth, [bf] * self.ring_depth,
                    block=True)
                return
            epoch = self.state_manager.current_packed
            new_ps, _, _, present = self._packed_step(tables, epoch, bi, bf)
            self._block()
            self.state_manager.commit_packed(new_ps, present_now=present,
                                             read_epoch=epoch)

    def _block(self) -> None:
        """Wait for the card's queued work (boot only: it surfaces an
        asynchronous execution failure before its commit)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dispatch_chain(self, chain, tables, slots_i, slots_f,
                        block: bool = False):
        """ONE chained dispatch over the leased carry (shared by the live
        ring and the boot warm-up).  The lease gives the chain the epoch
        exclusively; the commit re-applies a concurrent sweep's flags.
        ``block=True`` forces completion before the commit (warm-up
        only)."""
        ps, token = self.state_manager.lease_packed()
        out = chain(tables, ps, *slots_i, *slots_f)
        if block:
            self._block()
        self.state_manager.commit_packed(
            out[0], present_now=out[3], lease_token=token)
        return out

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        self.flush()
        if self._egress_super is not None:
            # after flush: the offload queue is drained (or the gate is
            # wedged closed by a dead plan)
            self._egress_stop.set()
            self._egress_evt.set()
            self._egress_super.stop()
            self._egress_super = None
        super().stop()

    def _loop(self) -> None:
        # poll at half the deadline, floored at 2 ms
        while not self._stop.wait(max(self.batcher.deadline_s / 2, 0.002)):
            try:
                self._m_native_fb.set(native.build_fallbacks)
                # Backpressure: with the in-flight window full, drain one
                # slot instead of emitting a partial plan behind it.
                # Never block this thread on the step lock.
                if not self._step_lock.acquire(blocking=False):
                    continue
                try:
                    full = len(self._inflight) >= self.inflight_depth
                finally:
                    self._step_lock.release()
                if full:
                    self._drain_inflight(max_n=1)
                    continue
                plans = self._take(self.batcher.poll)  # deadline emit
                if plans:
                    self._run_plans(plans)
                else:
                    # No new batch: age out a partial ring, then drain
                    # the deferred steps so egress latency stays bounded
                    # when traffic pauses.
                    self._flush_ring_if_due()
                    self._drain_inflight()
                    self._maybe_commit_offset()
            except Exception:
                logger.exception("dispatch cycle failed")

    def flush(self, timeout_s: float = 10.0) -> None:
        """Force pending rows through; on return every row ingested
        BEFORE the call has completed egress.  Waits (bounded) for the
        plans-outstanding gate to quiesce, since a plan the loop thread
        has taken but not yet run is in neither the batcher nor the
        window."""
        self._run_plans(self._take(self.batcher.flush))
        self._flush_ring()
        self._drain_inflight()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                quiesced = (self._plans_outstanding == 0
                            and self.batcher.pending == 0)
            if quiesced and not self._egress_busy:
                break
            self._run_plans(self._take(self.batcher.flush))
            self._flush_ring()
            self._drain_inflight()
            time.sleep(0.001)
        self._maybe_commit_offset()

    def _maybe_commit_offset(self) -> None:
        """Durably commit journal progress at a quiescent point: the event
        store's buffer is sealed first, so a crash after the commit can
        never have dropped a row the offset claims is done."""
        reader = self.journal_reader
        if reader is None or self._max_egressed_ref < 0:
            return
        with self._step_lock:
            if self._inflight or self._egress_busy:
                return
            with self._lock:
                if self.batcher.pending > 0 or self._plans_outstanding > 0:
                    return
                upto = self._max_egressed_ref + 1
                if upto > reader.committed:
                    if self.event_store is not None:
                        self.event_store.flush()
                    reader.commit(upto)

    def replay_journal(self, decoder=None, max_records: int = 4096,
                       upto: Optional[int] = None,
                       from_offset: Optional[int] = None) -> int:
        """Re-ingest journal records past the committed offset (crash
        recovery, at-least-once).

        Records replay through ``decoder`` (default JSON, with the C
        resolved scanner first) without re-journaling, keeping their
        offsets as ``payload_ref``; undecodable records dead-letter.
        ``upto`` (exclusive) bounds the replay: pass the journal end
        captured before live intake starts, so a racing fresh append is
        never ingested twice.  ``from_offset`` starts the replay BELOW
        the committed offset (a checkpoint's replay floor): those records
        re-run their state effects but skip the event store, where they
        are durably stored already (``store_dedup_floor``).  Returns
        replayed event rows.
        """
        reader = self.journal_reader
        if reader is None:
            return 0
        use_columnar = decoder is None
        decoder = decoder or JsonLinesDecoder()
        start = reader.committed
        if from_offset is not None:
            start = min(start, max(0, int(from_offset)))
        # rows below the committed offset sealed before that offset
        # committed: replaying them must not store them twice
        self.store_dedup_floor = max(self.store_dedup_floor,
                                     reader.committed)
        reader.seek(start)
        n = 0
        done = False
        while not done:
            records = reader.poll(max_records)
            if not records:
                break
            for offset, payload in records:
                if upto is not None and offset >= upto:
                    done = True
                    break
                if use_columnar:
                    fast = self._replay_columnar(payload, offset)
                    if fast is not None:
                        n += fast
                        continue
                try:
                    reqs = decoder(payload)
                except DecodeError as e:
                    self.ingest_failed_decode(payload, "journal-replay", e)
                    continue
                events = [r for r in reqs if r.event_type is not None]
                if not events:
                    continue
                tenants = [
                    self.resolve_tenant(r.metadata.get("tenant", "default")
                                        if r.metadata else "default")
                    for r in events
                ]
                self._run_plans(self._take(
                    lambda: self.batcher.add_requests(
                        events, tenants, [offset] * len(events))))
                n += len(events)
        if n:
            logger.info("replayed %d journaled events from offset %d",
                        n, start)
        self.flush()
        with self._lock:
            quiesced = (self._plans_outstanding == 0
                        and self.batcher.pending == 0
                        and not self._egress_busy)
        if quiesced:
            # every replayed sub-committed row has egressed: retire the
            # dedup mask so live egress stops paying for it (a timed-out
            # flush keeps the floor)
            self.store_dedup_floor = 0
        return n

    def _replay_columnar(self, payload: bytes, offset: int) -> Optional[int]:
        """Replay one journal record through the C resolved measurement
        scanner, or None when it does not take the record and the caller
        must take the scalar decoder.  Only that scanner qualifies: it
        bails on any unknown request key, so a record it takes carries no
        ``metadata`` and the scalar decoder would give the same rows
        (default tenant).  The event-family scanner skips unknown keys and
        would drop a per-request tenant.  Rows keep ``offset`` as
        payload_ref; nothing is re-journaled."""
        space = space_of(self.batcher.resolve_device)
        if space is None:
            return None
        # the scan bails (None) on shapes it does not take, but the epoch
        # split raises DecodeError for a finite out-of-int32 eventDate:
        # the scalar decoder then owns the dead-lettering
        try:
            out = _native_decode_resolved(payload, space)
        except DecodeError:
            return None
        if out is None:
            return None
        columns, _host = out
        return self._ingest_resolved_columns(columns, offset)

    # -- one step -----------------------------------------------------------

    def _tables_packed(self):
        """PackedTables for the current provider epochs, identity-cached
        (re-packs only when a registry/rule/zone epoch changed)."""
        t0 = time.perf_counter()
        reg = self.registry_provider()
        t_reg = time.perf_counter() - t0
        rules = self.rules_provider()
        zones = self.zones_provider()
        c = self._tables_cache
        if c is not None and c[0] is reg and c[1] is rules and c[2] is zones:
            return c[3]
        if c is not None and c[0] is not reg:
            self._m_leg["registry_publish"].observe(t_reg)
        t0 = time.perf_counter()
        t = pack_tables(reg, rules, zones)
        self._m_leg["tables_repack"].observe(time.perf_counter() - t0)
        self._tables_cache = (reg, rules, zones, t)
        return t

    def _run_plan(self, plan: BatchPlan, replay_depth: int = 0) -> None:
        """Route one emitted plan: full-width fill plans join the ring;
        everything else takes the single-step path, draining ring-held
        predecessors first so per-device event order is preserved."""
        if self._ring_eligible(plan, replay_depth):
            self._stage_plan(plan)
            with self._step_lock:
                self._ring.append(plan)
                due = len(self._ring) >= self.ring_depth
            if due:
                self._stall_for_egress_room()
                with self._step_lock:
                    if len(self._ring) >= self.ring_depth:
                        self._run_ring()
            return
        if self.ring_depth and self._ring:
            # ordering barrier, bounded by this plan's emission seq: newer
            # fill plans are successors and stay ringed
            self._flush_ring(stall=replay_depth == 0,
                             upto_seq=plan.seq if plan.seq >= 0 else None)
        self._dispatch_plan(plan, replay_depth)

    def _ring_eligible(self, plan: BatchPlan, replay_depth: int) -> bool:
        """May this plan wait in the ring?  Only depth-0 full-width fill
        emissions of packed plans: partials are latency-sensitive and
        re-injected plans must not recurse through the ring."""
        return (self.ring_depth > 0
                and replay_depth == 0
                and plan.packed_i is not None
                and plan.reason == "fill"
                and plan.n_events == plan.width)

    def _stall_for_egress_room(self) -> None:
        """Bounded offload queue: stall (never while holding the step
        lock) once egress has fallen a full window behind."""
        if not self._offloaded():
            return
        deadline = time.monotonic() + 10.0
        while (len(self._inflight) >= self.egress_queue_depth
               and self._offloaded()
               and time.monotonic() < deadline):
            self._room_evt.clear()
            # re-check after the clear: a slot freed in between must not
            # cost a full poll interval
            if len(self._inflight) < self.egress_queue_depth:
                break
            self._room_evt.wait(0.05)
        else:
            if (self._offloaded()
                    and len(self._inflight) >= self.egress_queue_depth):
                self._m_stall_overflow.inc()
                logger.warning(
                    "egress stalled > 10s with %d plans in flight "
                    "(bound %d); proceeding past the window bound",
                    len(self._inflight), self.egress_queue_depth)

    def _flush_ring(self, stall: bool = True,
                    upto_seq: Optional[int] = None) -> None:
        """Drain ring-held plans through the single-step path in emission
        order (the partial-ring deadline/flush path, and the ordering
        barrier ahead of a non-ring plan).  ``stall=False`` from the
        egress worker's own context; ``upto_seq`` bounds the drain to
        plans emitted before that sequence number.  Each pop+dispatch
        happens under one step-lock hold."""
        while True:
            if stall:
                self._stall_for_egress_room()
            with self._step_lock:
                if not self._ring:
                    return
                if upto_seq is not None and self._ring[0].seq >= upto_seq:
                    return
                plan = self._ring.pop(0)
                self._m_ring_flushes.inc()
                self._dispatch_plan(plan, 0, stall=False)

    def _flush_ring_if_due(self) -> None:
        """Loop-thread linger bound: a partial ring whose oldest plan has
        aged past the batcher deadline drains single-step."""
        if not self.ring_depth:
            return
        with self._step_lock:
            due = bool(self._ring) and (
                time.monotonic() - self._ring[0].created_at
                >= self.batcher.deadline_s)
        if due:
            self._flush_ring()

    def _ring_chain(self, k: int):
        """The K-step chain, built once per K."""
        chain = self._ring_chains.get(k)
        if chain is None:
            chain = build_packed_chain(k)
            self._ring_chains[k] = chain
        return chain

    @hot_path
    def _run_ring(self) -> None:
        """Dispatch one K-step chain over the ring's staged slots (called
        under ``_step_lock`` with a full ring): one host dispatch covers K
        steps, the carry threads on the device, and the stacked outputs'
        copy to the host starts at once, so egress waits once per ring.
        Each slot then windows as its own plan: commits stay fail-closed
        per batch.  A fault propagates with the K plans outstanding."""
        faults.fire("dispatcher.step")
        plans = self._ring[:self.ring_depth]
        del self._ring[:self.ring_depth]
        k = len(plans)
        chain = self._ring_chain(k)
        now = time.monotonic()
        slots_i, slots_f = self._ring_slots_i, self._ring_slots_f
        for i, plan in enumerate(plans):
            self._m_stage["ring_wait"].observe(
                max(0.0, now - plan.created_at))
            slots_i[i], slots_f[i] = plan.staged
        t0 = time.perf_counter()
        tables = self._tables_packed()
        ctrace = self.tracer.trace("pipeline.chain")
        try:
            if faults.device_active():
                # device-fault injection against the retained host copies
                for plan in plans:
                    faults.device_fire("device.dispatch",
                                       values=plan.packed_f,
                                       valid=plan.packed_i[0] != 0)
            with ctrace.span("ring.dispatch").tag("steps", k):
                _, ois, mets, _present = self._dispatch_chain(
                    chain, tables, slots_i, slots_f)
            fetch = RingFetch(ois, mets, on_fetch=self._m_host_syncs.inc)
        finally:
            ctrace.end()
            for i in range(k):
                slots_i[i] = None
                slots_f[i] = None
        # chaos kill point: the chain dispatched and committed, but no
        # slot has egressed; every ring plan must replay
        faults.crosspoint("crash.mid_ring")
        chain_dt = time.perf_counter() - t0
        self._m_stage["ring_dispatch"].observe(chain_dt)
        self._m_ring_chains.inc()
        for slot, plan in enumerate(plans):
            trace = self.tracer.trace("pipeline.plan")
            trace.record("batch.assemble", plan.max_wait_s,
                         rows=plan.n_events, fill=round(plan.fill, 3))
            trace.record("ring.slot", max(0.0, now - plan.created_at),
                         slot=slot, seq=plan.seq, chain_k=k)
            self._m_assemble.observe(plan.max_wait_s)
            self._window_step(plan, RingStepView(fetch, slot), 0, trace)

    @hot_path
    def _dispatch_plan(self, plan: BatchPlan, replay_depth: int = 0,
                       stall: bool = True) -> None:
        """The single-step path: one step over the live epoch, committed
        with ``read_epoch`` (a sweep between the read and the commit keeps
        its flags).  A fault propagates with the plan outstanding."""
        faults.fire("dispatcher.step")
        if stall and replay_depth == 0:
            # re-injected plans (depth > 0, everything the egress worker
            # submits) skip the wait: the worker never blocks on itself
            self._stall_for_egress_room()
        self._stage_plan(plan)
        trace = self.tracer.trace("pipeline.plan")
        trace.record("batch.assemble", plan.max_wait_s,
                     rows=plan.n_events, fill=round(plan.fill, 3))
        self._m_assemble.observe(plan.max_wait_s)
        t_dispatch = time.perf_counter()
        with self._step_lock:
            if faults.device_active() and plan.packed_i is not None:
                faults.device_fire("device.dispatch", values=plan.packed_f,
                                   valid=plan.packed_i[0] != 0)
            with trace.span("step.dispatch").tag("rows", plan.n_events):
                if plan.packed_i is not None:
                    tables = self._tables_packed()
                    epoch = self.state_manager.current_packed
                    bi, bf = plan.staged
                    new_ps, oi, metrics, present = self._packed_step(
                        tables, epoch, bi, bf)
                    self.state_manager.commit_packed(
                        new_ps, present_now=present, read_epoch=epoch)
                else:
                    batch = plan.batch
                    new_state, out = self._step(
                        self.registry_provider(), self.state_manager.current,
                        self.rules_provider(), self.zones_provider(), batch)
                    self.state_manager.commit(new_state,
                                              present_now=out.present_now)
                    # the packed output block: one egress for both forms
                    oi, metrics, present = pack_outputs(out, batch)
                view = PackedView(oi, metrics, present,
                                  on_fetch=self._m_host_syncs.inc)
            self._m_stage["dispatch"].observe(
                time.perf_counter() - t_dispatch)
            self._window_step(plan, view, replay_depth, trace)

    def _offloaded(self) -> bool:
        """Is the supervised egress worker accepting work?  False before
        start(), after stop(), with ``egress_offload=False``, and once the
        worker has escalated: every caller then egresses inline."""
        sup = self._egress_super
        return sup is not None and sup.alive and not sup.escalated

    @hot_path
    def _window_step(self, plan, out, replay_depth: int, trace) -> None:
        """Window the dispatched step in flight.  Offloaded: hand it to
        the egress worker and return.  Inline: egress the oldest plans
        beyond the window on this thread.  Called under _step_lock."""
        self.steps += 1
        self._m_steps.inc()
        self._inflight.append((plan, out, replay_depth, trace))
        if self._offloaded():
            self._m_inflight.set(len(self._inflight))
            self._egress_evt.set()
            return
        while len(self._inflight) > self.inflight_depth:
            self._egress_guarded(self._inflight.popleft())

    def _drain_inflight(self, max_n: Optional[int] = None) -> None:
        if self._offloaded():
            # the worker owns draining: wake it; flush() waits on the
            # outstanding-plan accounting for completion
            self._egress_evt.set()
            return
        with self._step_lock:
            # egress may re-inject (replay, derived alerts), appending new
            # steps to the window: loop until settled
            n = 0
            while self._inflight and (max_n is None or n < max_n):
                self._egress_guarded(self._inflight.popleft())
                n += 1

    def _egress_worker(self) -> None:
        """Egress offload loop (runs under a Supervisor).  An egress
        exception propagates: the Supervisor restarts the loop and the
        failed plan stays outstanding (the commit gate fails closed)."""
        while True:
            item = None
            with self._step_lock:
                if self._inflight:
                    item = self._inflight.popleft()
                    self._egress_busy = True
                elif self._egress_stop.is_set():
                    return
            if item is None:
                self._egress_evt.wait(0.01)
                self._egress_evt.clear()
                continue
            try:
                self._egress_guarded(item)
            finally:
                self._egress_busy = False
                self._room_evt.set()

    def _egress_guarded(self, item) -> None:
        """:meth:`_egress` with crash accounting, shared by the offload
        worker and the inline paths."""
        try:
            self._egress(*item)
        except Exception:
            self.egress_failures += 1
            self._m_egress_fail.inc()
            raise

    @hot_path
    def _egress(self, plan: BatchPlan, out, replay_depth: int,
                trace=None) -> None:
        """Host fan-out of one step's outputs.

        The input batch never leaves the host (``plan.host_cols``); only
        step outputs are read, and the rare-row masks (unregistered,
        derived alerts) only when their metric counters are nonzero.
        """
        # chaos hook: an egress failure mid-window; the plan has stepped
        # but never completes, so the offset never commits past it
        faults.fire("dispatcher.egress")
        t_egress = time.perf_counter()
        if trace is None:
            trace = _NOOP_TRACE
        host_cols = plan.host_cols
        with trace.span("egress.fetch-outputs"):
            m = out.metrics
            accepted = out.accepted
            cols = EgressColumns(host_cols, out)
        for key in ("processed", "accepted", "unregistered", "unassigned",
                    "threshold_alerts", "zone_alerts"):
            count = int(getattr(m, key))
            self.totals[key] += count
            if count:
                self._m_totals[key].inc(count)
        self._m_occ["rows_admitted"].set(int(m.processed))
        self._m_occ["rules_fired"].set(
            int(m.threshold_alerts) + int(m.zone_alerts))
        # the device counter is width - valid; the plan's real row count
        # is host knowledge
        self._m_occ["rows_invalid"].set(
            max(0, int(plan.n_events) - int(m.processed)))
        telemetry = out.telemetry
        for key in ("state_writes", "presence_merges"):
            self._m_occ[key].set(telemetry[key])
        # numeric-integrity quarantine: the per-device host scan runs
        # only when the device counted NaN/Inf rows in this plan
        nf = int(telemetry["rows_nonfinite"])
        if nf:
            self._m_quar_rows.inc(nf)
            self._scan_quarantine(plan, replay_depth)
        # monotonic receive time of the plan's oldest row
        ingest_t0 = plan.received_at

        refs = host_cols["payload_ref"]
        journaled = refs != NULL_ID
        if journaled.any():
            self._max_egressed_ref = max(
                self._max_egressed_ref, int(refs[journaled].max()))

        # 1. persistence.  Replay below the committed offset (a
        # checkpoint's replay floor) skips rows already durably stored;
        # their state effects still re-run.
        store_mask = accepted
        if self.store_dedup_floor > 0:
            store_mask = accepted & ((refs == NULL_ID)
                                     | (refs >= self.store_dedup_floor))
        if self.event_store is not None and store_mask.any():
            with trace.span("egress.persist").tag(
                    "rows", int(store_mask.sum())):
                self.event_store.append_columns(cols, mask=store_mask)
            self._m_seal.set(time.monotonic() - ingest_t0)
        # chaos kill point: stored but the offset commit never runs
        faults.crosspoint("crash.mid_egress")

        # 1b. streaming analytics: live window/session/pattern queries on
        # the runner's own worker (non-blocking offer).  The committed
        # offset rides along as the runner's fully-applied watermark:
        # queue order guarantees every batch carrying rows of records
        # below it was offered before this one.
        if self.analytics is not None and accepted.any():
            with trace.span("egress.analytics"):
                self.analytics.submit_live(
                    cols, accepted, trace=trace,
                    committed=(int(self.journal_reader.committed)
                               if self.journal_reader is not None
                               else None))

        # 1c. tenant rule programs: the same accepted enriched batch,
        # evaluated on the engine's own worker (non-blocking offer)
        if self.rules_engine is not None and accepted.any():
            with trace.span("egress.rules"):
                self.rules_engine.submit_live(cols, accepted)

        # 2. command invocations (command delivery, synchronous on this
        # thread as in the reference)
        cmd_mask = accepted & (cols["event_type"]
                               == EventType.COMMAND_INVOCATION)
        if self.on_command_rows is not None and cmd_mask.any():
            self.totals["commands"] += int(cmd_mask.sum())
            with trace.span("egress.commands"), \
                    self._m_leg["egress_commands"].time():
                self.on_command_rows(cols, cmd_mask, trace=trace)

        # 3. auto-registration + replay
        if int(m.unregistered) > 0:
            with trace.span("egress.registration"), \
                    self._m_leg["egress_registration"].time():
                self._handle_unregistered(host_cols, out, replay_depth)

        # 4. derived alerts re-injection, read only when rules fired
        if int(m.threshold_alerts) + int(m.zone_alerts) > 0:
            with trace.span("egress.derived-alerts"):
                self._reinject_derived(plan, out, replay_depth)

        # Egress complete: record the plan's end-to-end latency and
        # release it from the commit gate.  On an exception above the
        # count stays elevated: commits stop (fail closed).
        lat = max(0.0, time.monotonic() - ingest_t0)
        with self._lock:
            self.latencies_s.append(lat)
            self._plans_outstanding -= 1
        trace.end()
        self._m_e2e.observe(
            lat, trace_id=(trace.trace_id if trace.sampled else None))
        self._m_queue.set(self.batcher.pending)
        self._m_inflight.set(len(self._inflight))
        self._m_stage["egress"].observe(time.perf_counter() - t_egress)

    def _scan_quarantine(self, plan: BatchPlan, replay_depth: int) -> None:
        """Per-device attribution of the plan's nonfinite rows (called
        only when the device-counted ``rows_nonfinite`` is nonzero).  A
        device crossing ``quarantine_after`` cumulative poison rows emits
        one STATE_CHANGE (``STATE_CHANGE_QUARANTINED``) through the normal
        re-injection egress."""
        host = plan.host_cols
        valid = np.asarray(host["valid"]) != 0
        finite = np.ones(valid.shape, dtype=bool)
        for field in ("value", "lat", "lon", "elevation"):
            finite &= np.isfinite(np.asarray(host[field], dtype=np.float32))
        bad = valid & ~finite
        if not bad.any():
            return
        devs = np.asarray(host["device_id"])[bad].tolist()
        tens = np.asarray(host["tenant_id"])[bad].tolist()
        newly = []
        for dev, ten in zip(devs, tens):
            if dev < 0:
                continue
            seen = self._nonfinite_seen.get(dev, 0) + 1
            self._nonfinite_seen[dev] = seen
            if (seen >= self.quarantine_after
                    and dev not in self._quarantined):
                self._quarantined.add(dev)
                newly.append((int(dev), int(ten)))
        self._m_quar_devices.set(len(self._quarantined))
        if not newly:
            return
        self._m_quar_changes.inc(len(newly))
        logger.warning("quarantined %d device(s) for nonfinite values: %s",
                       len(newly), [d for d, _ in newly])
        if replay_depth < self.max_replay_depth:
            batch = state_changes_for(
                np.asarray([d for d, _ in newly], np.int32),
                np.asarray([t for _, t in newly], np.int32),
                int(time.time()), device=self.device,
                code=STATE_CHANGE_QUARANTINED)
            self.inject_batch(batch, np.ones(len(newly), dtype=bool),
                              replay_depth + 1)

    def _handle_unregistered(self, host_cols, out, replay_depth: int) -> None:
        mask = np.asarray(out.unregistered)
        if not mask.any():
            return
        refs = host_cols["payload_ref"][mask]
        records: List[RecordEvents] = []
        unreplayable: List[int] = []
        if self.journal is not None and self.registration is not None:
            # resolve the original requests from the journal for replay;
            # rows of one payload share an offset, so decode each once
            unreplayable = [int(r) for r in refs if int(r) == NULL_ID]
            for ref in dict.fromkeys(int(r) for r in refs
                                     if int(r) != NULL_ID):
                try:
                    records.append(self._redecode(ref))
                except Exception:
                    logger.debug("unreplayable payload ref %d", ref)
                    unreplayable.append(ref)
        else:
            unreplayable = [int(r) for r in refs]
        # every unreplayable row dead-letters, even when siblings replay
        if unreplayable and self.dead_letters is not None:
            dead_letter(self.dead_letters,
                        {"kind": "unregistered", "count": len(unreplayable),
                         "refs": unreplayable})
        if self.registration is None or not any(records):
            return
        # A multi-event payload shares one journal ref, so the re-decode
        # above returns EVERY event in it: drop only the siblings this
        # plan processed normally.  A token that raced to registration
        # between intake and egress is still replayed.
        replayed_refs = np.isin(
            host_cols["payload_ref"],
            [int(r) for r in dict.fromkeys(int(r) for r in refs)
             if int(r) != NULL_ID])
        sibling_processed = {
            int(i)
            for i in host_cols["device_id"][replayed_refs & ~mask]
            if int(i) != NULL_ID
        }
        resolve = self.batcher.resolve_device
        requests = [
            rec.request(i) for rec in records
            for i, token in enumerate(rec.tokens)
            if not sibling_processed
            or resolve(token) not in sibling_processed
        ]
        if not requests:
            return
        replay = self.registration.process_unregistered(requests)
        if replay and replay_depth < self.max_replay_depth:
            self.totals["replayed"] += len(replay)

            def intake():
                out = []
                for req in replay:
                    tenant_id = self.resolve_tenant(
                        req.metadata.get("tenant", "default")
                        if req.metadata else "default"
                    )
                    plan = self.batcher.add(req, tenant_id=tenant_id,
                                            payload_ref=NULL_ID)
                    if plan is not None:
                        out.append(plan)
                return out

            self._run_plans(self._take(intake), replay_depth + 1)

    def _redecode(self, ref: int) -> RecordEvents:
        """The events of journal record ``ref`` (host-plane lines were
        handled at first ingest; only events replay), kept for the last
        few records so a record split across plans decodes once."""
        cache = self._redecoded
        with self._redecoded_lock:
            events = cache.get(ref)
            if events is not None:
                cache.move_to_end(ref)
                return events
        events = RecordEvents.of(self.journal.read_one(ref))
        with self._redecoded_lock:
            cache[ref] = events
            while len(cache) > _REDECODED_RECORDS:
                cache.popitem(last=False)
        return events

    def _reinject_derived(self, plan: BatchPlan, out,
                          replay_depth: int) -> None:
        """Re-inject the plan's derived alerts, rebuilt from its host
        columns and the packed output block."""
        if replay_depth >= self.max_replay_depth:
            return
        rows = np.nonzero(out.derived_valid)[0]
        if rows.size == 0:
            return
        self.totals["derived_alerts"] += int(rows.size)
        cols = out.derived_cols(plan.host_cols, rows)
        self._run_plans(self._take(
            lambda: self.batcher.add_arrays(_copy=False, **cols)),
            replay_depth + 1)

    def inject_batch(self, batch: EventBatch, mask: np.ndarray,
                     replay_depth: int = 0) -> None:
        """Re-inject an already-dense event batch (derived alerts, presence
        STATE_CHANGEs) through the pipeline as first-class events."""
        rows = np.nonzero(np.asarray(mask))[0]
        if rows.size == 0:
            return
        cols = {f: getattr(batch, f).cpu().numpy()[rows]
                for f in _COL_FIELDS}
        # fancy-indexed gathers above are fresh arrays: skip the copy
        self._run_plans(self._take(
            lambda: self.batcher.add_arrays(_copy=False, **cols)),
            replay_depth)

    def inject_rule_alerts(self, cols: Dict[str, np.ndarray]) -> int:
        """Re-inject fired tenant-program alerts as first-class ALERT
        events (the rule engine's half of the derived-alert contract).

        Called from the rule engine's worker thread, outside the engine's
        stream, so any step it runs launches on this thread's current
        stream as every other intake does; ``_take`` and ``_run_plans``
        serialize it against live intake.  The engine builds the columns
        with ``update_state=False`` and masks ALERT rows at eval, so the
        path cannot amplify itself."""
        n = int(np.asarray(cols["device_id"]).size)
        if n == 0:
            return 0
        self.totals["derived_alerts"] += n
        # the key appears with the first program alert, as in the
        # reference's totals
        self.totals["rule_program_alerts"] = (
            self.totals.get("rule_program_alerts", 0) + n)
        self._run_plans(self._take(
            lambda: self.batcher.add_arrays(_copy=False, **cols)))
        return n

    def metrics_snapshot(self) -> Dict[str, object]:
        with self._lock:
            pending = self.batcher.pending
            samples = list(self.latencies_s)
        snap: Dict[str, object] = {
            "steps": self.steps,
            "pending_rows": pending,
            "host_syncs": int(self._m_host_syncs.value),
            "ring_depth": self.ring_depth,
            "ring_chains": int(self._m_ring_chains.value),
            "ring_flushed_plans": int(self._m_ring_flushes.value),
            "quarantined_devices": len(self._quarantined),
            **self.totals,
        }
        if samples:
            lat = np.asarray(samples)
            snap["latency_p50_ms"] = round(
                float(np.percentile(lat, 50)) * 1e3, 3)
            snap["latency_p99_ms"] = round(
                float(np.percentile(lat, 99)) * 1e3, 3)
        return snap
