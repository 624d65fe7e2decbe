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

- ADMISSION (``overload``, an
  :class:`~sitewhere_tpu_torch.runtime.overload.OverloadController`):
  every wire entry point admits or sheds each row's priority class before
  the journal append (a fill-direct reservation is admitted or shed,
  whole, before it is adopted); shed rows dead-letter replayably
  (``intake-shed`` / ``tenant-budget``) and a fully shed payload raises
  :class:`~sitewhere_tpu_torch.runtime.overload.OverloadShed`.  The loop
  ticks the ladder and the SLO burn-rate engine (``slo``).
- METERING (``usage_ledger``): egress folds each plan's packed 16-slot
  tenant block, read from the copy egress already fetches, into the
  usage ledger (:meth:`_meter_plan`): no extra host sync.
- CONTAINMENT (``runtime/devguard.py``).  A host-raised device fault
  (an injected fault, a host exception around the launch, a NaN/Inf
  poison row) is contained without a restart, as in the reference: a
  failed chain re-parks its plans and re-dispatches them single-step
  from the pre-chain epoch the state manager still holds
  (:meth:`_recover_ring`); a failed single step bisects its rows, each
  subset a full-width step with the other rows masked ``valid = 0`` and
  its errors forced out by an event sync on the containment path only,
  until the poison singles dead-letter replayably as ``device-poison``
  (:meth:`_contain_step_failure`).  Faults of distinct batches trip the
  :class:`~sitewhere_tpu_torch.runtime.devguard.DeviceBreaker` down its
  ladder (chained, single-step, FALLBACK); the trip forces the overload
  ladder to DEGRADED and the restore releases it.  The
  :class:`~sitewhere_tpu_torch.runtime.devguard.DeviceWatchdog` times
  every in-flight dispatch against its soft and hard budgets from the
  loop's idle tick.  An error the CUDA runtime or torch raised about the
  card (:func:`is_card_error`: a sticky one such as an illegal address or
  a device-side assert, an out-of-memory, a refused launch) hits the
  whole fixed-shape batch, not a row, so the dispatcher fails closed
  instead of bisecting: it logs and flight-records the error and exits
  the process with :data:`STICKY_EXIT_CODE`, dead-letters nothing, and a
  restart recovers through the checkpoint and the journal replay.  The
  breaker's FALLBACK level fails closed the same way on a card, where the
  reference steps on the CPU; a dispatcher on the CPU steps there anyway
  and counts those steps in ``device.fault.cpu_fallback_steps``.
- THE MESH (``mesh``, :mod:`~sitewhere_tpu_torch.parallel.mesh`): the
  step, the packed step and the K-chain run over the shards
  (:mod:`~sitewhere_tpu_torch.pipeline.sharded`), each plan staged as one
  block per shard.  Faults are attributed to shards by the batch segment
  of their NaN/Inf rows, and a
  :class:`~sitewhere_tpu_torch.runtime.devguard.ShardBreakers` bank
  demotes only the sick shard: its rows leave the chain through the
  side route (:meth:`_sidecar_shard_rows`) while the healthy shards keep
  chaining.  A shard at FALLBACK side-steps through the mesh on a card
  (counted in ``sidecar_steps``), the reference's own branch for a host
  without a CPU device; the process fails closed only when every shard
  is at FALLBACK.

Backend switches follow the reference's non-TPU branch until an H100
measurement chooses: ``inflight_depth`` 1, ring depth
:func:`~sitewhere_tpu_torch.pipeline.packed.ring_depth_default` (0 unless
``SW_TPU_RING_DEPTH`` is set), egress offload on off the CPU.
"""

from __future__ import annotations

import collections
import collections.abc
import logging
import os
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
from sitewhere_tpu_torch.parallel.mesh import SHARD_AXIS, P, gather
from sitewhere_tpu_torch.parallel.shmap import place_tree, tree_map
from sitewhere_tpu_torch.pipeline.packed import (
    BATCH_F,
    BATCH_I,
    HostCopy,
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
from sitewhere_tpu_torch.pipeline.sharded import (
    build_sharded_packed_chain,
    build_sharded_packed_step,
    build_sharded_step,
    place_packed_batch,
    place_packed_tables,
    unpack_sharded_state,
)
from sitewhere_tpu_torch.pipeline.step import pipeline_step
from sitewhere_tpu_torch.runtime import faults
from sitewhere_tpu_torch.runtime.devguard import (
    BREAKER_LEVELS,
    FALLBACK,
    DeviceBreaker,
    DeviceWatchdog,
    ShardBreakers,
)
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry
from sitewhere_tpu_torch.runtime.overload import (
    CLASS_OF_EVENT_TYPE,
    OverloadState,
    PriorityClass,
    classify_event_type,
)
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

# Exit status of a process that failed closed on a card fault
# (EX_SOFTWARE): the restart recovers through the journal
STICKY_EXIT_CODE = 70

# CUDA errors after which the context is unusable: every later launch on
# it fails (cudaError_t codes, and the text torch raises them with)
_STICKY_CODES = frozenset((214, 700, 702, 710, 714, 715, 716, 717, 718,
                           719))
_STICKY_TEXT = ("illegal memory access", "device-side assert",
                "unspecified launch failure", "misaligned address",
                "illegal instruction", "uncorrectable ecc",
                "hardware stack error", "invalid program counter",
                "invalid address space", "launch timed out")


def is_sticky_cuda_error(exc: BaseException) -> bool:
    """True for a CUDA error that has poisoned the context (an illegal
    address, a device-side assert, a launch failure): bisecting it would
    dead-letter every row, and moving the state to the CPU would move a
    dead card's state.  An injected fault, a host exception and a poison
    row leave the context alive and are not sticky."""
    code = getattr(exc, "error_code", None)
    if isinstance(code, int) and code in _STICKY_CODES:
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if not isinstance(exc, RuntimeError) and not (
            accel is not None and isinstance(exc, accel)):
        return False
    text = str(exc).lower()
    return "cuda" in text and any(m in text for m in _STICKY_TEXT)


# Text of errors the CUDA runtime or torch raises about the card itself
# (a launch that cannot start, an allocation the card refuses) rather than
# about the host's inputs
_CARD_TEXT = ("cuda error", "cuda out of memory", "cuda driver error",
              "cublas_status", "cudnn_status")


def is_card_error(exc: BaseException) -> bool:
    """True for any error the CUDA runtime or torch raised about the
    card: a sticky one (:func:`is_sticky_cuda_error`), an out-of-memory,
    a launch the card refused.  The step has a fixed shape, so such an
    error hits the whole batch, not a row: bisecting it would step every
    subset to a single row and dead-letter them all.  The dispatcher
    fails closed on it instead.  Only host-raised faults (an injected
    fault, a host exception around the launch, a poison row) bisect."""
    if is_sticky_cuda_error(exc):
        return True
    if isinstance(getattr(exc, "error_code", None), int):
        return True
    for name in ("AcceleratorError", "OutOfMemoryError"):
        cls = getattr(torch, name, None)
        if cls is not None and isinstance(exc, cls):
            return True
    if not isinstance(exc, RuntimeError):
        return False
    text = str(exc).lower()
    return any(m in text for m in _CARD_TEXT)


def _exit_process(code: int) -> None:
    """The fail-closed exit: no ``finally`` blocks, no flush, no atexit
    (nothing may run on a lost context); the journal is the durable
    truth and the restart replays it."""
    logging.shutdown()
    os._exit(code)


class _FailedCopy:
    """Stands in for a device-to-host copy that could not start: its
    fetch raises the copy's error, so the plan's egress fails and the
    dispatcher re-dispatches it (see :meth:`PipelineDispatcher.
    _on_host_copy_error`)."""

    def __init__(self, exc: BaseException):
        self._exc = exc

    def fetch(self):
        raise self._exc


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

    def release_output(self) -> None:
        """Memoize the enrichment columns and drop the step-output
        reference.  Egress calls this before it hands the view to an
        async consumer whenever no store path fetched the columns: a view
        parked in a lagging outbound queue must never pin the step's
        pinned host block, nor make a connector's thread wait on its
        copy."""
        self._enrichment()

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
    - ``outbound`` -> the outbound connectors manager (``submit(cols,
      mask, trace=, ingest_t0=)``, a non-blocking offer to each
      connector's queue); None = no outbound fan-out
    - ``analytics`` -> the streaming query runner (``submit_live`` with
      ``committed=``, a non-blocking bounded offer); None = no live
      queries
    - ``rules_engine`` -> the tenant rule engine (``submit_live``, a
      non-blocking bounded offer); None = no BYO rule programs
    - ``overload`` -> the admission controller; None = admit everything
    - ``flightrec`` -> the flight recorder (one record per egressed plan,
      dumps on anomaly); None = recording off
    - ``slo`` -> the SLO burn-rate engine the loop ticks; None = off
    - ``usage_ledger`` -> the tenant usage ledger egress bills; None =
      metering off
    - ``breaker`` / ``watchdog`` -> pre-configured device guards (their
      unset callbacks get the dispatcher's handlers); None = defaults

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
        outbound=None,
        rules_engine=None,
        analytics=None,
        journal: Optional[Journal] = None,
        dead_letters: Optional[Journal] = None,
        resolve_tenant: Optional[Callable[[str], int]] = None,
        on_host_request: Optional[Callable[[DecodedRequest, bytes], None]] = None,
        max_replay_depth: int = 4,
        inflight_depth: Optional[int] = None,
        journal_reader: Optional[JournalReader] = None,
        tracer=None,
        metrics=None,
        egress_offload: Optional[bool] = None,
        ring_depth: Optional[int] = None,
        quarantine_after: int = 3,
        overload=None,
        flightrec=None,
        slo=None,
        usage_ledger=None,
        breaker: Optional[DeviceBreaker] = None,
        watchdog: Optional[DeviceWatchdog] = None,
        device: DeviceLike = None,
        mesh=None,
        name: str = "pipeline-dispatcher",
    ):
        super().__init__(name)
        if mesh is not None and device is None:
            device = mesh.shard_devices[0]
        self.device = resolve_device(device)
        # On a mesh the step runs over the shards (the Kafka-partitioning
        # analog): the batcher routes each row to the segment of the
        # shard owning its registry block, and the packed step, the
        # K-chain and the unpacked step are their sharded forms.
        self.mesh = mesh
        self.batcher = batcher
        self.registry_provider = registry_provider
        self.rules_provider = rules_provider
        self.zones_provider = zones_provider
        self.state_manager = state_manager
        self.event_store = event_store
        self.registration = registration
        self.on_command_rows = on_command_rows
        # Outbound connectors: egress offers every accepted enriched
        # batch, after persistence, to each connector's bounded queue.
        self.outbound = outbound
        # host-plane wire lines (device-stream requests) go to the
        # instance's handler; without one they dead-letter here
        self.on_host_request = on_host_request
        # Bring-your-own rules: egress offers every accepted batch to the
        # engine's bounded queue; its worker evaluates the tenant programs
        # and fired ones re-enter through inject_rule_alerts.
        self.rules_engine = rules_engine
        # Streaming analytics: egress offers every accepted batch, with the
        # committed journal offset as the runner's applied watermark.
        self.analytics = analytics
        self.journal = journal
        self.dead_letters = dead_letters
        # Overload control: admission at every wire entry point; None =
        # admit everything (bare dispatchers)
        self.overload = overload
        self.resolve_tenant = resolve_tenant or (lambda token: 0)
        self.max_replay_depth = max_replay_depth
        if mesh is not None:
            self._step = build_sharded_step(mesh)
            self._packed_step = build_sharded_packed_step(mesh)
        else:
            self._step = pipeline_step
            self._packed_step = packed_pipeline_step
        self._tables_cache: Optional[tuple] = None
        # mesh-placed registry/rules/zones epochs of the unpacked step,
        # keyed by the provider epoch's identity
        self._placed_cache: Dict[int, tuple] = {}
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
            for s in ("egress_outbound", "egress_registration",
                      "egress_commands", "registry_publish",
                      "tables_repack")
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
        # SW_NATIVE_FILL=0 keeps the C scanners but turns the fill-direct
        # decode off (the A/B switch; SW_NATIVE=0 turns the whole tier off)
        self._fill_enabled = os.environ.get("SW_NATIVE_FILL", "1") != "0"
        self._m_ring_chains = metrics.counter("pipeline.ring_chains")
        self._m_ring_flushes = metrics.counter("pipeline.ring_flushes")
        self._m_host_copy_err = metrics.counter("pipeline.host_copy_errors")
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
        # Flight recorder: one structured record per egressed plan, dumped
        # to JSONL on anomaly (egress crash, device faults, watchdog
        # trips; the instance adds overload transitions and SLO alerts)
        self.flightrec = flightrec
        # SLO burn-rate engine: the loop ticks it beside the overload
        # ladder
        self.slo = slo
        # Device-tier fault containment (runtime/devguard.py and the
        # _recover_ring / _contain_step_failure paths below), under the
        # reference's closed device.fault.* family
        self._m_fault = {
            key: metrics.counter(f"device.fault.{key}")
            for key in ("chain_faults", "step_faults", "bisect_rounds",
                        "poison_rows", "releases", "breaker_trips",
                        "watchdog_soft_trips", "watchdog_hard_trips",
                        "host_copy_faults", "cpu_fallback_steps")
        }
        self._m_breaker_state = metrics.gauge("device.fault.breaker_state")
        self._m_quar_devices = metrics.gauge("pipeline.quarantine.devices")
        self._m_quar_rows = metrics.counter(
            "pipeline.quarantine.rows_nonfinite")
        self._m_quar_changes = metrics.counter(
            "pipeline.quarantine.state_changes")
        # Breaker: repeated device faults across distinct batches demote
        # dispatch chained -> single-step -> CPU fallback; a cooldown
        # probe restores.  Watchdog: wall-clock budgets over in-flight
        # dispatches.  Callers may pass pre-configured guards; the
        # dispatcher attaches its handlers to any callbacks left unset.
        # On a mesh with a sharded batcher the bank holds one breaker per
        # shard: a fault attributed to one shard's batch segment demotes
        # that shard alone (side-routed, _sidecar_shard_rows) while the
        # healthy shards keep chaining.
        self._mesh_shards = (batcher.n_shards
                             if mesh is not None and batcher.n_shards > 1
                             else 0)
        # batch rows of shard s live at [s*seg, (s+1)*seg)
        self._shard_seg = (batcher.width // batcher.n_shards
                           if self._mesh_shards else 0)
        if breaker is not None:
            self.breaker = breaker
        elif self._mesh_shards:
            self.breaker = ShardBreakers(self._mesh_shards)
        else:
            self.breaker = DeviceBreaker()
        self._shard_breakers = hasattr(self.breaker, "demoted_shards")
        if self.breaker.on_trip is None:
            self.breaker.on_trip = (self._on_shard_breaker_trip
                                    if self._shard_breakers
                                    else self._on_breaker_trip)
        if self.breaker.on_restore is None:
            self.breaker.on_restore = (self._on_shard_breaker_restore
                                       if self._shard_breakers
                                       else self._on_breaker_restore)
        # the breaker bank's suspect shards during a watchdog wedge
        # (device_unhealthy_shards); cleared when the tier recovers
        self._unhealthy_shards: tuple = ()
        # side-route dispatches of demoted shards' rows (a FALLBACK shard
        # on a card steps through the mesh; see _sidecar_shard_rows)
        self.sidecar_steps = 0
        self.watchdog = (watchdog if watchdog is not None
                         else DeviceWatchdog())
        if self.watchdog.on_soft is None:
            self.watchdog.on_soft = self._on_watchdog_soft
        if self.watchdog.on_unhealthy is None:
            self.watchdog.on_unhealthy = self._on_watchdog_hard
        if self.watchdog.on_recovered is None:
            self.watchdog.on_recovered = self._on_watchdog_recovered
        # D2H copy-fault escalation: _on_host_copy_error flags the
        # suspect; the egress failure that follows re-dispatches the plan
        # single-step
        self._copy_suspect = False
        # watchdog tokens per dispatched plan, keyed by id(plan)
        self._wd_tokens: Dict[int, int] = {}
        # Tenant metering: egress folds each plan's packed tenant block
        # into the ledger (_meter_plan), from the copy it fetches anyway
        self.usage_ledger = usage_ledger
        # decode-stage attribution mark: egress is serialized per plan, so
        # the decode timer's running-total delta between meter calls is
        # the decode time this plan's rows paid for
        self._meter_decode_mark = 0.0
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

    def step_barrier(self):
        """The lock serializing read-state → step → commit (the
        reference's :647).  Out-of-band state writers (ownership migration
        imports) hold it, so a step or a ring computed from the pre-write
        epoch cannot drop their rows at its commit: every path (the
        single step, the ring's lease to commit, the sharded step and the
        mesh chain, the containment re-runs) holds it from its read of
        the epoch to its commit."""
        return self._step_lock

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
        memory without blocking (on a mesh, one block per shard), or an
        unpacked plan's EventBatch."""
        if plan.staged is None and plan.packed_i is not None:
            plan.staged = self._stage_packed(plan.packed_i, plan.packed_f)
            self._m_h2d_bytes.inc(
                plan.packed_i.nbytes + plan.packed_f.nbytes)
        elif plan.packed_i is None and plan.batch is None \
                and plan.host_cols:
            t0 = time.perf_counter()
            plan.materialize_batch(self.device)
            self._m_stage["h2d"].observe(time.perf_counter() - t0)

    def _stage_packed(self, bi, bf):
        if self.mesh is not None:
            return place_packed_batch(self.mesh, bi, bf)
        return stage_packed_batch(bi, bf, self.device)

    # -- admission ----------------------------------------------------------

    def _shed_intake(self, payload: bytes, shed: Dict[object, int],
                     source_id: str, tenant: str,
                     budget_bound: bool = False) -> None:
        """Audit one intake shed: dead-letter the payload with reason and
        per-class counts, so shedding is inspectable and replayable
        (``Instance.requeue_dead_letter`` re-drives it).  Sheds the
        tenant's CONFIGURED budget overlay caused carry their own kind,
        ``tenant-budget``, with the budget that clipped them."""
        doc = {
            "kind": "tenant-budget" if budget_bound else "intake-shed",
            "state": self.overload.state.name,
            "reason": ("tenant budget exceeded" if budget_bound
                       else self.overload.last_driver or "admission"),
            "classes": {cls.name.lower(): int(n)
                        for cls, n in shed.items()},
            "source": source_id,
            "tenant": tenant,
            "payload": payload.hex(),
        }
        if budget_bound:
            overlay = self.overload.tenant_budgets.overlay(tenant)
            if overlay:
                doc["budget"] = overlay
        dead_letter(self.dead_letters, doc)
        if self.usage_ledger is not None:
            try:
                self.usage_ledger.charge(
                    self.resolve_tenant(tenant), "dead_letter_rows",
                    sum(shed.values()))
            except Exception:
                logger.exception("dead-letter usage charge failed")

    def _admit_requests(self, reqs: List[DecodedRequest], payload: bytes,
                        source_id: str) -> List[DecodedRequest]:
        """Admission-filter a decoded request list.  Returns the admitted
        subset; sheds dead-letter once per payload.  Raises
        :class:`~sitewhere_tpu_torch.runtime.overload.OverloadShed` when
        NOTHING was admitted."""
        admitted: List[DecodedRequest] = []
        shed: Dict[object, int] = {}
        worst = None
        budget_bound = False
        for req in reqs:
            cls = classify_event_type(int(req.event_type))
            tenant = (req.metadata.get("tenant", "default")
                      if req.metadata else "default")
            ok, reason = self.overload.admit_detail(
                cls, tenant=tenant, source=source_id)
            if ok:
                admitted.append(req)
            else:
                shed[cls] = shed.get(cls, 0) + 1
                worst = cls
                budget_bound = budget_bound or reason == "budget"
        if shed:
            tenant = (reqs[0].metadata.get("tenant", "default")
                      if reqs[0].metadata else "default")
            self._shed_intake(payload, shed, source_id, tenant,
                              budget_bound=budget_bound)
        if not admitted and shed:
            raise self.overload.shed_exception(worst)
        return admitted

    def _admit_columns(self, columns, payload: bytes, source_id: str):
        """Admission-filter one decoded wire-column dict (one
        fancy-index classifies every row, one bucket take per class per
        payload).  Returns ``(admitted_columns, shed_classes)``: the
        input unchanged, a filtered copy, or None for zero admitted
        rows; raising is the caller's decision."""
        n = n_rows(columns)
        if n == 0:
            return columns, {}
        et = np.asarray(columns["event_type"])
        class_of = np.fromiter(
            (int(c) for c in CLASS_OF_EVENT_TYPE), np.int32,
            len(CLASS_OF_EVENT_TYPE))
        # out-of-range types (STATE_CHANGE, future kinds) classify as
        # COMMAND, the default of classify_event_type
        in_range = (et >= 0) & (et < len(class_of))
        classes = np.where(
            in_range, class_of[np.clip(et, 0, len(class_of) - 1)],
            np.int32(int(PriorityClass.COMMAND)))
        keep = np.ones(n, bool)
        shed: Dict[object, int] = {}
        budget_bound = False
        for cls in (PriorityClass.TELEMETRY, PriorityClass.COMMAND):
            m = classes == int(cls)
            count = int(m.sum())
            if count:
                ok, reason = self.overload.admit_detail(
                    cls, source=source_id, n=count)
                if not ok:
                    keep &= ~m
                    shed[cls] = count
                    budget_bound = budget_bound or reason == "budget"
        if not shed:
            return columns, shed
        self._shed_intake(payload, shed, source_id, "default",
                          budget_bound=budget_bound)
        if not keep.any():
            return None, shed
        # decoded columns mix ndarrays and python lists: filter every
        # length-n sequence, pass scalars and None through
        rows = np.nonzero(keep)[0]

        def _filter(value):
            if isinstance(value, np.ndarray) and value.ndim >= 1 \
                    and len(value) == n:
                return value[keep]
            if isinstance(value, (list, tuple)) and len(value) == n:
                return [value[i] for i in rows]
            return value

        return ({key: _filter(value) for key, value in columns.items()},
                shed)

    def ingest(self, req: DecodedRequest, payload: bytes = b"",
               source_id: str = "ingest") -> None:
        """Queue one decoded request (journal it first: at-least-once)."""
        if self.overload is not None and req.event_type is not None:
            req = self._admit_requests([req], payload, source_id)[0]
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
        if self.overload is not None:
            # admission before the journal append: shed rows dead-letter
            # (replayable), never journaled; a fully shed payload raises
            reqs = self._admit_requests(reqs, payload, source_id)
            if not reqs:
                return
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
            if space is not None and self._fill_enabled \
                    and fill_direct_ready(payload):
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
            return self._ingest_reserved(payload, columns, source_id,
                                         received_at)
        if self.overload is not None:
            columns, shed = self._admit_columns(columns, payload, source_id)
            if columns is None:
                if host_reqs:
                    columns = {}   # host-plane lines still route below
                else:
                    # the WHOLE payload was shed: native backpressure,
                    # attributed to the most-privileged class refused
                    raise self.overload.shed_exception(min(shed, key=int))
        ref = NULL_ID
        if self.journal is not None and payload:
            ref = self.journal.append(payload)
            # chaos kill point: journaled, never batched; the record is
            # the durable truth and must reappear via replay
            faults.crosspoint("crash.post_journal")
        for req in host_reqs:
            if req.kind == RequestKind.REGISTRATION:
                self.ingest_registration(req, b"")
            elif self.on_host_request is not None:
                self.on_host_request(req, payload)
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
                         source_id: str = "wire",
                         received_at: Optional[float] = None) -> int:
        """The ordered ingest tail of the fill-direct lane: admission,
        one journal append, the per-payload constants, then the commit
        under the intake lock.  Every scanned row is a MEASUREMENT, so
        admission is the whole-payload TELEMETRY decision the column path
        would make, taken before the reservation is adopted: a shed
        reservation is aborted, never committed."""
        n = res.n
        if self.overload is not None:
            ok, reason = self.overload.admit_detail(
                PriorityClass.TELEMETRY, source=source_id, n=n)
            if not ok:
                res.abort()
                self._shed_intake(payload, {PriorityClass.TELEMETRY: n},
                                  source_id, "default",
                                  budget_bound=reason == "budget")
                raise self.overload.shed_exception(PriorityClass.TELEMETRY)
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
                on_restart=self._on_egress_restart,
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
        if space is not None and native.enabled():
            space.native_table()
        width = self.batcher.width
        bi, bf = self._stage_packed(
            np.zeros((len(BATCH_I), width), np.int32),
            np.zeros((len(BATCH_F), width), np.float32))
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
                if self.overload is not None:
                    # sample the pressure signals and run the ladder
                    # (rate-limited inside tick)
                    self.overload.tick()
                if self.slo is not None:
                    self.slo.tick()
                # Hung-step watchdog: dispatch is asynchronous, so this
                # thread stays live while a wedged step is in flight
                self.watchdog.check()
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
            except Exception as e:
                if is_card_error(e):
                    self._fail_closed(e, "dispatch cycle")
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

    def _placed(self, obj, sharded: bool):
        """A provider epoch placed on the mesh (the unpacked step's
        registry sharded by capacity, its rules and zones replicated),
        cached by the epoch's identity."""
        c = self._placed_cache.get(id(obj))
        if c is not None and c[0] is obj:
            return c[1]
        placed = place_tree(self.mesh, obj,
                            P(SHARD_AXIS) if sharded else P())
        if len(self._placed_cache) > 8:
            self._placed_cache.clear()
        self._placed_cache[id(obj)] = (obj, placed)
        return placed

    def _tables_packed(self):
        """PackedTables for the current provider epochs, identity-cached
        (re-packs only when a registry/rule/zone epoch changed; on a mesh,
        placed with the canonical placements)."""
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
        if self.mesh is not None:
            t = place_packed_tables(self.mesh, t)
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
        emissions of packed plans, and only while the breaker admits
        chained dispatch: partials are latency-sensitive and re-injected
        plans must not recurse through the ring."""
        return (self.ring_depth > 0
                and replay_depth == 0
                and plan.packed_i is not None
                and plan.reason == "fill"
                and plan.n_events == plan.width
                # breaker demoted past CHAINED: bisectable single-step
                # dispatch only, until a cooldown probe succeeds
                and self.breaker.allow_chain())

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
            chain = (build_sharded_packed_chain(self.mesh, k)
                     if self.mesh is not None else build_packed_chain(k))
            self._ring_chains[k] = chain
        return chain

    @hot_path
    def _run_ring(self) -> None:
        """Dispatch one K-step chain over the ring's staged slots (called
        under ``_step_lock`` with a full ring): one host dispatch covers K
        steps, the carry threads on the device, and the stacked outputs'
        copy to the host starts at once, so egress waits once per ring.
        Each slot then windows as its own plan: commits stay fail-closed
        per batch.  A fault in the chain is contained by
        :meth:`_recover_ring`."""
        # chaos hook: a chain-dispatch failure before anything is popped
        # leaves every plan in the ring, outstanding
        faults.fire("dispatcher.step")
        plans = self._ring[:self.ring_depth]
        del self._ring[:self.ring_depth]
        k = len(plans)
        chain = self._ring_chain(k)
        now = time.monotonic()
        # per-shard containment (mesh): rows of the shards the breaker
        # bank has demoted are side-routed and masked BEFORE the chain,
        # so one sick shard degrades alone while the healthy shards keep
        # the 1/K host-sync economy
        demoted = (self.breaker.demoted_shards()
                   if self._shard_breakers else ())
        if demoted:
            self._sidecar_shard_rows(plans, demoted)
        slots_i, slots_f = self._ring_slots_i, self._ring_slots_f
        for i, plan in enumerate(plans):
            self._m_stage["ring_wait"].observe(
                max(0.0, now - plan.created_at))
            slots_i[i], slots_f[i] = plan.staged
        t0 = time.perf_counter()
        tables = self._tables_packed()
        # one watchdog entry for the whole chain; each slot's egress ends
        # one part, so the entry drains with the LAST slot
        wd = self.watchdog.begin(plans, parts=k)
        for plan in plans:
            self._wd_tokens[id(plan)] = wd
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
        except Exception as e:
            ctrace.end()
            self._recover_ring(plans, e)
            return
        finally:
            for i in range(k):
                slots_i[i] = None
                slots_f[i] = None
        ctrace.end()
        fetch = self._host_copy(RingFetch, ois, mets)
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
            plan.dispatch_s = chain_dt / k   # per-slot share of the chain
            self._window_step(plan, RingStepView(fetch, slot), 0, trace)
        # a clean CHAINED dispatch closes a half-open breaker probe; on a
        # mesh it vouches only for the shards that rode the chain
        if demoted:
            self.breaker.record_success(chained=True, masked=demoted)
        else:
            self.breaker.record_success(chained=True)

    def _host_copy(self, make, oi, metrics):
        """Start a step's device-to-host copy; a copy that cannot start
        is escalated (:meth:`_on_host_copy_error`) and its fetch raises,
        so the plan's egress fails and re-dispatches."""
        try:
            return make(oi, metrics, on_fetch=self._m_host_syncs.inc)
        except Exception as e:
            if is_card_error(e):
                self._fail_closed(e, "device-to-host copy")
            self._on_host_copy_error(e)
            return _FailedCopy(e)

    def _recover_ring(self, plans, exc) -> None:
        """Chain-failure containment (runs under ``_step_lock``).

        The K plans were popped off the ring before the dispatch; they go
        back at the FRONT, which restores emission order and the
        accounting that reads ``_ring`` (``oldest_unsealed_wait_s``, the
        partial-ring drain).  The chain's lease is not stranded: the
        chain faulted before ``commit_packed``, so the state manager still
        holds the pre-chain epoch (no step writes into leased buffers),
        and each single-step re-dispatch below reads it again: recovery
        without a restart.  A re-dispatch that fails again is contained by
        :meth:`_contain_step_failure`; faults across distinct batches trip
        the breaker.  A card error fails closed instead."""
        if is_card_error(exc):
            self._fail_closed(exc, f"chain of {len(plans)}")
        self._ring[:0] = plans
        self._m_fault["chain_faults"].inc()
        # the failed chain held the packed lease: the re-dispatches read
        # the carry again from the last committed epoch
        self._m_fault["releases"].inc()
        for plan in plans:
            self._wd_end(plan)
        logger.warning(
            "chained dispatch failed (%d plans re-parked): %s",
            len(plans), exc)
        if self.flightrec is not None:
            for plan in plans:
                self._flight_record(
                    plan, None, 0, commit="device-fault",
                    error=f"{type(exc).__name__}: {exc}")
            self.flightrec.anomaly(
                "device-fault",
                detail=f"chain of {len(plans)} failed: "
                       f"{type(exc).__name__}: {exc}")
        # per-shard attribution on a mesh: NaN/Inf rows in a shard's
        # batch segment strike THAT shard's breaker; an unattributable
        # chain fault strikes every shard
        self._record_device_fault(plans[0].seq, plans)
        # single-step re-dispatch in emission order; a plan that fails
        # AGAIN stays re-parked (front of the ring) and keeps the commit
        # gate closed: journal replay recovers it after a restart
        for _ in range(len(plans)):
            plan = self._ring.pop(0)
            try:
                self._dispatch_plan(plan, 0, stall=False)
            except Exception:
                self._ring.insert(0, plan)
                logger.exception(
                    "single-step re-dispatch of seq=%d failed; "
                    "plan stays parked", plan.seq)
                break

    def _on_host_copy_error(self, exc) -> None:
        """A device-to-host output copy failed.  The dispatch committed,
        so the rows are not lost, but the egress fetch that follows hits
        the same dead buffer: flag the plan's egress failure for a
        single-step re-dispatch (the state re-step is at-least-once,
        like journal replay) and dump the anomaly."""
        self._m_host_copy_err.inc()
        self._m_fault["host_copy_faults"].inc()
        self._copy_suspect = True
        logger.warning("device->host output copy failed: %s", exc)
        if self.flightrec is not None:
            self.flightrec.anomaly(
                "host-copy-fault",
                detail=f"{type(exc).__name__}: {exc}")

    def _fail_closed(self, exc: BaseException, where: str) -> None:
        """A card fault (:func:`is_card_error`, or the breaker's FALLBACK
        level on a card): bisecting would dead-letter every row as poison,
        and a sticky error has lost the context for every later launch.
        Log it, write the flight recorder synchronously, and end the
        process with :data:`STICKY_EXIT_CODE`; nothing is dead-lettered,
        and the restart recovers through the checkpoint and the journal."""
        logger.critical("card fault in %s, failing closed: %s: %s",
                        where, type(exc).__name__, exc)
        if self.flightrec is not None:
            try:
                self.flightrec.record(kind="sticky-cuda-error", where=where,
                                      error=f"{type(exc).__name__}: {exc}")
                self.flightrec.snapshot(
                    "device-lost", detail=f"{where}: "
                    f"{type(exc).__name__}: {exc}")
            except Exception:
                logger.exception("flight-recorder dump failed")
        _exit_process(STICKY_EXIT_CODE)

    # -- device-tier fault-containment callbacks (devguard wiring) --------

    def _on_breaker_trip(self, level: int) -> None:
        self._m_fault["breaker_trips"].inc()
        self._m_breaker_state.set(level)
        logger.warning("device breaker tripped to %s",
                       BREAKER_LEVELS[level])
        if self.flightrec is not None:
            self.flightrec.anomaly(
                "device-breaker",
                detail=f"dispatch demoted to {BREAKER_LEVELS[level]}")
        if (self.overload is not None
                and self.overload.state == OverloadState.NORMAL):
            # ride the overload ladder: a demoted device tier sheds the
            # same way genuine pressure does
            self.overload.force(OverloadState.DEGRADED,
                                reason="device-breaker")

    def _on_breaker_restore(self) -> None:
        self._m_breaker_state.set(0)
        logger.info("device breaker restored chained dispatch")
        if (self.overload is not None
                and self.overload.state == OverloadState.DEGRADED
                and getattr(self.overload, "last_driver", None)
                == "device-breaker"):
            # release only our own demotion: a ladder driven by real
            # pressure meanwhile keeps its state
            self.overload.force(OverloadState.NORMAL,
                                reason="device-breaker-recovered")

    def _on_watchdog_soft(self, payload, elapsed_s: float) -> None:
        """Soft budget tripped: dump the in-flight dispatch's plan records
        to the flight recorder (``payload`` is the plan, or the ring's
        plan list, handed to ``watchdog.begin``)."""
        plans = payload if isinstance(payload, list) else [payload]
        self._m_fault["watchdog_soft_trips"].inc()
        logger.warning("device dispatch slow: %.3fs in flight (budget "
                       "%.3fs), %d plan(s)", elapsed_s,
                       self.watchdog.soft_s, len(plans))
        if self.flightrec is not None:
            for i, plan in enumerate(plans):
                self.flightrec.record(
                    kind="hung-step",
                    **self._wd_record(plan,
                                      slot=i if len(plans) > 1 else None))
            self.flightrec.anomaly(
                "device-hung-step",
                detail=f"{elapsed_s:.3f}s in flight "
                       f"(soft budget {self.watchdog.soft_s:.3f}s)")

    def _on_watchdog_hard(self, payload, elapsed_s: float) -> None:
        self._m_fault["watchdog_hard_trips"].inc()
        # shard-scoped wedge attribution (mesh): the bank's suspects,
        # shards with live strikes or an elevated level; () = the whole
        # tier is suspect
        if self._shard_breakers:
            self._unhealthy_shards = self.breaker.suspect_shards()
        logger.error("device tier unhealthy: dispatch wedged %.3fs "
                     "(hard budget %.3fs)%s", elapsed_s,
                     self.watchdog.hard_s,
                     (f", suspect shards {self._unhealthy_shards}"
                      if self._unhealthy_shards else ""))
        if self.flightrec is not None:
            self.flightrec.anomaly(
                "device-wedged",
                detail=f"{elapsed_s:.3f}s in flight "
                       f"(hard budget {self.watchdog.hard_s:.3f}s)")

    def _on_watchdog_recovered(self) -> None:
        self._unhealthy_shards = ()
        logger.info("device tier recovered: in-flight dispatches drained")

    @property
    def device_unhealthy(self) -> bool:
        """True while the hung-step watchdog holds the tier unhealthy."""
        return self.watchdog.unhealthy

    @property
    def device_unhealthy_shards(self) -> tuple:
        """Mesh refinement of :attr:`device_unhealthy`: the shards
        suspected in the current wedge.  Empty while healthy, and when a
        wedge cannot be attributed (then the whole tier is suspect)."""
        if not self.watchdog.unhealthy:
            return ()
        return self._unhealthy_shards

    def _on_shard_breaker_trip(self, shard: int, level: int) -> None:
        """One mesh shard demoted (ShardBreakers callback): the gauge
        tracks the WORST shard, the flight recorder names the sick one,
        and the overload ladder engages only once NO shard can chain."""
        self._m_fault["breaker_trips"].inc()
        self._m_breaker_state.set(self.breaker.level)
        logger.warning("device breaker tripped to %s for mesh shard %d "
                       "(other shards keep chaining)",
                       BREAKER_LEVELS[level], shard)
        if self.flightrec is not None:
            self.flightrec.anomaly(
                "device-breaker",
                detail=f"shard {shard} demoted to {BREAKER_LEVELS[level]}")
        if (self.overload is not None
                and not self.breaker.allow_chain()
                and self.overload.state == OverloadState.NORMAL):
            self.overload.force(OverloadState.DEGRADED,
                                reason="device-breaker")

    def _on_shard_breaker_restore(self, shard: int) -> None:
        self._m_breaker_state.set(self.breaker.level)
        logger.info("device breaker restored chained dispatch for "
                    "mesh shard %d", shard)
        if (self.breaker.level == 0
                and self.overload is not None
                and self.overload.state == OverloadState.DEGRADED
                and getattr(self.overload, "last_driver", None)
                == "device-breaker"):
            self.overload.force(OverloadState.NORMAL,
                                reason="device-breaker-recovered")

    def _fault_shards(self, plans) -> Optional[set]:
        """Attribute a mesh dispatch fault to shard(s): the retained HOST
        batch buffers' NaN/Inf rows, each mapped by its batch position to
        its shard segment.  None = unattributable (the caller strikes
        every shard)."""
        if not self._mesh_shards:
            return None
        shards: set = set()
        for plan in plans:
            if plan.packed_i is None:
                continue
            bf = np.asarray(plan.packed_f)
            valid = np.asarray(plan.packed_i[0]) != 0
            bad = valid & ~np.isfinite(bf).all(axis=0)
            for row in np.nonzero(bad)[0]:
                shards.add(int(row) // self._shard_seg)
        return shards or None

    def _record_device_fault(self, seq: int, plans) -> None:
        """Route one device fault into the breaker: per shard when the
        bank is shard-aware AND the fault attributes to segments,
        tier-wide otherwise."""
        if not self._shard_breakers:
            self.breaker.record_fault(seq)
            return
        shards = self._fault_shards(plans)
        if shards is None:
            self.breaker.record_fault(seq)
        else:
            for s in sorted(shards):
                self.breaker.record_fault(seq, shard=s)

    def _tier_fallback(self) -> bool:
        """Is the whole tier at FALLBACK?  On a mesh, only when every
        shard is: a single FALLBACK shard side-steps through the mesh."""
        if self._shard_breakers:
            return all(self.breaker.level_of(s) >= FALLBACK
                       for s in range(self.breaker.n_shards))
        return self.breaker.level >= FALLBACK

    def _sidecar_shard_rows(self, plans, demoted: tuple) -> None:
        """Demoted-shard side route (mesh ring, under ``_step_lock``):
        each ring plan's rows of the ``demoted`` shards go through the
        containment subset path (one step over the mesh with only those
        rows valid), then are masked out of the staged chain batch.  The
        healthy shards keep the chain; the sick shard's rows still flow,
        commit through the same read-epoch merge, and egress normally.

        At FALLBACK the reference routes these rows through its CPU step.
        A dispatcher on a card never moves the card's state to the CPU,
        so it takes the reference's branch for a host without a CPU
        device: the shard keeps single-stepping through the mesh,
        counted in :attr:`sidecar_steps`, and the process does not exit
        for one sick shard.  On the CPU the side steps count as CPU
        fallback steps, as the reference's do.  A side dispatch that
        FAILS leaves its rows in the chain on purpose: the chain fault
        that follows re-enters :meth:`_recover_ring`'s containment."""
        fallback = any(self.breaker.level_of(s) >= FALLBACK
                       for s in demoted)
        seg = self._shard_seg
        for plan in plans:
            if plan.packed_i is None:
                continue
            valid = np.asarray(plan.packed_i[0]) != 0
            take = np.zeros(valid.shape[0], dtype=bool)
            for s in demoted:
                take[s * seg:(s + 1) * seg] = True
            rows = np.nonzero(take & valid)[0]
            if rows.size == 0:
                continue
            trace = self.tracer.trace("pipeline.shard-sidecar")
            trace.record("shard.sidecar", 0.0, seq=plan.seq,
                         rows=int(rows.size), shards=list(demoted))
            if not self._try_subset(plan, rows, 0, trace):
                logger.warning(
                    "sidecar dispatch for demoted shard(s) %s failed "
                    "(seq=%d); rows stay in the chain for containment",
                    demoted, plan.seq)
                continue
            self.sidecar_steps += 1
            if fallback and self.device.type == "cpu":
                self._m_fault["cpu_fallback_steps"].inc()
            # mask the side-routed rows out of the chained dispatch: a
            # fresh host buffer (the retained original keeps its rows for
            # bisect and dead-letter), restaged on the mesh
            bi = np.array(plan.packed_i, copy=True)
            bi[0][rows] = 0
            plan.packed_i = bi
            plan.staged = self._stage_packed(bi, plan.packed_f)

    def _wd_record(self, plan: BatchPlan,
                   slot: Optional[int] = None) -> dict:
        rec = {"seq": int(plan.seq), "rows": int(plan.n_events),
               "reason": plan.reason}
        if slot is not None:
            rec["slot"] = slot
        return rec

    def _wd_end(self, plan: BatchPlan) -> None:
        self.watchdog.end(self._wd_tokens.pop(id(plan), None))

    def _on_egress_restart(self, exc) -> None:
        """Supervisor restart of the egress worker: the same reason as the
        worker's own crash dump, so the two coalesce into one snapshot
        under the per-reason rate limit."""
        if self.flightrec is not None:
            self.flightrec.anomaly(
                "egress-crash", detail=f"supervisor restart: {exc}")

    @hot_path
    def _flight_record(self, plan: BatchPlan, out, replay_depth: int,
                       commit: str, e2e_s: float = 0.0,
                       egress_s: float = 0.0, trace=None,
                       error: Optional[str] = None) -> None:
        """Append one structured per-batch record to the flight recorder:
        sequence, ring slot, per-host-stage timings, overload state, trace
        id, commit outcome.  Pure host dict work, no device access."""
        rec = {
            "seq": int(plan.seq),
            "reason": plan.reason,
            "rows": int(plan.n_events),
            "fill": round(plan.fill, 4),
            "slot": getattr(out, "slot", None),
            "replay_depth": int(replay_depth),
            "wait_ms": round(plan.max_wait_s * 1e3, 3),
            "dispatch_ms": round(plan.dispatch_s * 1e3, 3),
            "egress_ms": round(egress_s * 1e3, 3),
            "e2e_ms": round(e2e_s * 1e3, 3),
            "overload": (self.overload.state.name
                         if self.overload is not None else "NORMAL"),
            "trace_id": getattr(trace, "trace_id", None),
            "commit": commit,
        }
        if error is not None:
            rec["error"] = error
        self.flightrec.record(**rec)

    @hot_path
    def _dispatch_plan(self, plan: BatchPlan, replay_depth: int = 0,
                       stall: bool = True) -> None:
        """The single-step path: one step over the live epoch, committed
        with ``read_epoch`` (a sweep between the read and the commit keeps
        its flags).  A packed step's fault is contained by
        :meth:`_contain_step_failure`; the breaker's FALLBACK level goes
        through :meth:`_fallback_step`."""
        # chaos hook: a step-dispatch failure before the step; the plan
        # stays outstanding, so the commit gate fails closed
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
            if plan.packed_i is not None:
                tables = self._tables_packed()
                epoch = self.state_manager.current_packed
                bi, bf = plan.staged
                step_fn = self._packed_step
                if self._tier_fallback():
                    step_fn = self._fallback_step(plan)
                wd = self.watchdog.begin(plan)
                self._wd_tokens[id(plan)] = wd
                try:
                    if faults.device_active():
                        # fires against the retained host copies
                        faults.device_fire("device.dispatch",
                                           values=plan.packed_f,
                                           valid=plan.packed_i[0] != 0)
                    with trace.span("step.dispatch").tag(
                            "rows", plan.n_events):
                        new_ps, oi, metrics, present = step_fn(
                            tables, epoch, bi, bf)
                        self.state_manager.commit_packed(
                            new_ps, present_now=present, read_epoch=epoch)
                except Exception as e:
                    self._wd_end(plan)
                    self._contain_step_failure(plan, e, replay_depth, trace)
                    return
                view = PackedView(None, None, present, copy=self._host_copy(
                    HostCopy, oi, metrics))
            else:
                batch = plan.batch
                with trace.span("step.dispatch").tag("rows", plan.n_events):
                    if self.mesh is not None:
                        new_state, out = self._step(
                            self._placed(self.registry_provider(), True),
                            unpack_sharded_state(
                                self.state_manager.current_packed),
                            self._placed(self.rules_provider(), False),
                            self._placed(self.zones_provider(), False),
                            batch)
                        self.state_manager.commit(
                            new_state, present_now=out.present_now)
                        out = tree_map(gather, out)
                    else:
                        new_state, out = self._step(
                            self.registry_provider(),
                            self.state_manager.current,
                            self.rules_provider(), self.zones_provider(),
                            batch)
                        self.state_manager.commit(
                            new_state, present_now=out.present_now)
                    # the packed output block: one egress for both forms
                    oi, metrics, present = pack_outputs(out, batch)
                view = PackedView(oi, metrics, present,
                                  on_fetch=self._m_host_syncs.inc)
            dt = time.perf_counter() - t_dispatch
            self._m_stage["dispatch"].observe(dt)
            plan.dispatch_s = dt   # flight-record stage attribution
            self._window_step(plan, view, replay_depth, trace)

    def _contain_step_failure(self, plan: BatchPlan, exc,
                              replay_depth: int, trace) -> None:
        """A single-step packed dispatch failed: bisect the batch on the
        host until the poison rows are isolated (under ``_step_lock``).

        The full valid-row set is retried FIRST: a transient fault
        recovers in one extra dispatch with zero loss.  A subset that
        still faults splits in half; singles that fault are poison and
        dead-letter replayably as ``device-poison`` (the raw columns ride
        the document).  Every CLEAN subset dispatches, commits and windows
        normally.  Subsets mask rows with ``valid = 0`` (the device's
        short-batch semantics), so disjoint subsets never double count.
        A card error fails closed instead (:meth:`_fail_closed`)."""
        if is_card_error(exc):
            self._fail_closed(exc, f"step seq={plan.seq}")
        self._m_fault["step_faults"].inc()
        self._record_device_fault(plan.seq, (plan,))
        logger.warning("packed step failed for seq=%d (%d rows): %s; "
                       "bisecting", plan.seq, plan.n_events, exc)
        if self.flightrec is not None:
            self._flight_record(
                plan, None, replay_depth, commit="device-fault",
                trace=trace, error=f"{type(exc).__name__}: {exc}")
            self.flightrec.anomaly(
                "device-fault",
                detail=f"step seq={plan.seq} failed: "
                       f"{type(exc).__name__}: {exc}")
        try:
            valid_rows = np.nonzero(np.asarray(plan.packed_i[0]) != 0)[0]
            poison: List[int] = []
            stack = [valid_rows]
            while stack:
                rows = stack.pop()
                if rows.size == 0:
                    continue
                self._m_fault["bisect_rounds"].inc()
                if self._try_subset(plan, rows, replay_depth, trace):
                    continue
                if rows.size == 1:
                    poison.append(int(rows[0]))
                    continue
                mid = rows.size // 2
                stack.append(rows[mid:])
                stack.append(rows[:mid])
            if poison:
                self._m_fault["poison_rows"].inc(len(poison))
                logger.warning("isolated %d poison row(s) in seq=%d; "
                               "dead-lettering", len(poison), plan.seq)
                self._dead_letter_poison(plan, poison, exc)
        finally:
            # the original plan never egresses: its outstanding slot
            # retires here; clean subsets balanced their own increments
            # through normal egress
            with self._lock:
                self._plans_outstanding -= 1

    def _try_subset(self, plan: BatchPlan, rows: np.ndarray,
                    replay_depth: int, trace) -> bool:
        """Dispatch ``plan`` with only ``rows`` valid; True on success.

        The batch is rebuilt from the retained HOST buffers (not
        ``plan.staged``), so the masked columns are exactly what the
        device sees.  The step's errors are forced out here, by a sync on
        an event recorded after it (the containment path only), not at
        the egress fetch."""
        bi = np.array(plan.packed_i, copy=True)
        mask = np.zeros(bi.shape[1], dtype=bool)
        mask[rows] = True
        bi[0] = np.where(mask, bi[0], 0)
        bf = plan.packed_f
        try:
            if faults.device_active():
                faults.device_fire("device.dispatch", values=bf,
                                   valid=bi[0] != 0)
            tables = self._tables_packed()
            epoch = self.state_manager.current_packed
            with self._lock:
                self._plans_outstanding += 1
            try:
                sbi, sbf = self._stage_packed(bi, bf)
                new_ps, oi, metrics, present = self._packed_step(
                    tables, epoch, sbi, sbf)
                if self.device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
                    done.synchronize()
                self.state_manager.commit_packed(
                    new_ps, present_now=present, read_epoch=epoch)
            except Exception:
                with self._lock:
                    self._plans_outstanding -= 1
                raise
        except Exception as e:
            if is_card_error(e):
                self._fail_closed(e, f"bisect of seq={plan.seq}")
            return False
        view = PackedView(None, None, present, copy=self._host_copy(
            HostCopy, oi, metrics))
        self._window_step(plan, view, replay_depth, trace)
        return True

    def _dead_letter_poison(self, plan: BatchPlan, rows: List[int],
                            exc) -> None:
        """Dead-letter isolated poison rows replayably: the document
        carries the raw host columns, so the ``device-poison`` requeue
        (``Instance.requeue_dead_letter``) rebuilds and re-ingests them."""
        if self.dead_letters is None:
            return
        idx = np.asarray(rows, dtype=np.int64)
        columns = {
            field: np.asarray(col)[idx].tolist()
            for field, col in plan.host_cols.items()
        }
        dead_letter(self.dead_letters, {
            "kind": "device-poison",
            "error": f"{type(exc).__name__}: {exc}",
            "seq": int(plan.seq),
            "count": len(rows),
            "columns": columns,
        }, metrics=self.metrics)
        if self.usage_ledger is not None and "tenant_id" in columns:
            self.usage_ledger.charge_rows_host(
                np.asarray(columns["tenant_id"], np.int64),
                "dead_letter_rows")

    def _fallback_step(self, plan: BatchPlan):
        """The breaker's FALLBACK level, reached after repeated faults of
        distinct batches.  On a card it fails closed as a card fault does
        (:meth:`_fail_closed`): no step moves the card's tables and state
        to the CPU, and the restart replays the journal.  A dispatcher on
        the CPU already steps there: its own step runs, counted in
        ``device.fault.cpu_fallback_steps`` as the reference counts its
        CPU steps, logged and flight-recorded."""
        if self.device.type != "cpu":
            self._fail_closed(RuntimeError(
                f"device breaker at {self.breaker.level_name} after "
                "repeated device faults"), f"step seq={plan.seq}")
        self._m_fault["cpu_fallback_steps"].inc()
        logger.warning("breaker at %s: seq=%d steps on the CPU",
                       self.breaker.level_name, plan.seq)
        if self.flightrec is not None:
            self.flightrec.record(kind="cpu-fallback-step",
                                  seq=int(plan.seq),
                                  rows=int(plan.n_events))
        return self._packed_step

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
        worker and the inline paths: the failure is counted and
        flight-recorded (the failed plan's record, then the dump), a
        failure after a host-copy fault re-dispatches the plan, and a
        card error fails closed.  The plan's watchdog entry
        retires here whatever the outcome."""
        try:
            try:
                self._egress(*item)
            except Exception as e:
                if is_card_error(e):
                    self._fail_closed(e, f"egress of seq={item[0].seq}")
                self.egress_failures += 1
                self._m_egress_fail.inc()
                if self.flightrec is not None:
                    self._flight_record(
                        item[0], item[1], item[2], commit="failed",
                        trace=item[3], error=f"{type(e).__name__}: {e}")
                    self.flightrec.anomaly("egress-crash", detail=str(e))
                plan = item[0]
                if (self._copy_suspect and plan.packed_i is not None
                        and item[2] == 0):
                    # the plan's device-to-host copy faulted and its fetch
                    # hit the dead buffer: re-dispatch it single-step (the
                    # re-step is at-least-once, like journal replay).  Only
                    # the FIRST faulted plan retries inline.
                    self._copy_suspect = False
                    logger.warning(
                        "egress failed after host-copy fault; "
                        "re-dispatching seq=%d single-step", plan.seq)
                    self._dispatch_plan(plan, 1, stall=False)
                    return
                raise
        finally:
            self._wd_end(item[0])

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
        # tenant metering: the packed tenant block of the same fetched
        # metrics vector (no extra host sync)
        if self.usage_ledger is not None:
            self._meter_plan(out, host_cols)
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
        elif accepted.any() and (self.outbound is not None
                                 or self.analytics is not None):
            # the store path would have fetched the enrichment columns
            # (releasing the step output); without it, fetch and release
            # here, on this thread, so an async queue holding the view
            # never pins the step's host block.  With no async consumer
            # the view dies with this frame and the fetch is skipped.
            cols.release_output()
        # chaos kill point: stored but the offset commit never runs
        faults.crosspoint("crash.mid_egress")

        # 1a. enriched fan-out to the outbound connectors; the trace rides
        # along so each async delivery span joins it
        if self.outbound is not None and accepted.any():
            with trace.span("egress.outbound"), \
                    self._m_leg["egress_outbound"].time():
                self.outbound.submit(cols, accepted, trace=trace,
                                     ingest_t0=ingest_t0)

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
        egress_dt = time.perf_counter() - t_egress
        self._m_stage["egress"].observe(egress_dt)
        if self.flightrec is not None:
            self._flight_record(plan, out, replay_depth, commit="ok",
                                e2e_s=lat, egress_s=egress_dt, trace=trace)

    def _meter_plan(self, out, host_cols: Dict[str, np.ndarray]) -> None:
        """Bill one egressed plan to its tenants.  The step bucketed the
        accepted rows, state writes and nonfinite rows by ``tenant_id %
        TENANT_METER_SLOTS``; the ledger resolves the buckets against the
        plan's host tenant column.  The decode timer's running-total delta
        rides along, so decode time is billed by row share."""
        tenants = host_cols.get("tenant_id") if host_cols else None
        if tenants is None:
            return
        block = out.tenant_meter
        decode_total = self._m_stage["decode"].total
        decode_s = max(0.0, decode_total - self._meter_decode_mark)
        self._meter_decode_mark = decode_total
        try:
            self.usage_ledger.charge_device_block(
                block, tenants, decode_s=decode_s)
            self.usage_ledger.publish(min_interval_s=1.0)
        except Exception:
            logger.exception("tenant metering failed for one plan")

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
        if self.flightrec is not None:
            self.flightrec.record(
                kind="quarantine", seq=int(plan.seq),
                rows=len(devs), devices=[d for d, _ in newly],
                strikes=self.quarantine_after)
            self.flightrec.anomaly(
                "device-quarantine",
                detail=f"devices {[d for d, _ in newly]} crossed "
                       f"{self.quarantine_after} nonfinite rows")
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

    def requeue_rows(self, cols: Dict[str, np.ndarray]) -> int:
        """Re-ingest raw event columns through the normal batch path (the
        ``device-poison`` dead-letter requeue): the isolated rows re-enter
        like fresh ingest.  Returns the row count."""
        n = int(np.asarray(cols["device_id"]).size)
        if n == 0:
            return 0
        self._run_plans(self._take(
            lambda: self.batcher.add_arrays(_copy=False, **cols)))
        return n

    def oldest_unsealed_wait_s(self) -> float:
        """The live ingest-to-seal watermark: the age of the oldest event
        admitted but not yet through egress (the overload ladder's lag
        signal).  It decays as work seals, unlike the last-value seal
        gauge.  Lock-free reads (a torn read only skews one sample)."""
        if self.steps == 0:
            # warm-up gate: before the first step rows wait on the boot
            return 0.0
        now = time.monotonic()
        wait = 0.0
        oldest = self.batcher._oldest
        if oldest is not None and self.batcher.pending > 0:
            wait = now - oldest
        try:
            plan = self._inflight[0][0]
            wait = max(wait, now - plan.created_at + plan.max_wait_s)
        except IndexError:
            pass
        # ring-held plans are in flight too (emitted, not yet stepped)
        try:
            plan = self._ring[0]
            wait = max(wait, now - plan.created_at + plan.max_wait_s)
        except IndexError:
            pass
        return max(0.0, wait)

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
            "device_fault": {
                "breaker": self.breaker.snapshot(),
                "watchdog": self.watchdog.snapshot(),
                "quarantined_devices": len(self._quarantined),
            },
            **self.totals,
        }
        if samples:
            lat = np.asarray(samples)
            snap["latency_p50_ms"] = round(
                float(np.percentile(lat, 50)) * 1e3, 3)
            snap["latency_p99_ms"] = round(
                float(np.percentile(lat, 99)) * 1e3, 3)
        return snap
