"""The port's composition root, as far as the slices ported so far go.

Counterpart of ``sitewhere_tpu/instance.py``'s :class:`Instance`, cut to
the components this package has: the identity map, the registry mirror
and the device system of record over it (``DeviceManagement``), asset
management, the rule manager, the device-state manager, the segment
store, command delivery (the ``CommandProcessor``: the dispatcher's
command-rows leg delivers every accepted COMMAND_INVOCATION row whose
journal record is one JSON document, and :meth:`create_command_invocation`
journals one), auto-registration (``registration.*``: the
``RegistrationManager`` registers the senders of unregistered rows and
the dispatcher replays their rows), the ingest journal and its dead
letters, the streaming analytics runner
(``analytics.enabled``, on by default as in the reference: registered
Window/Session/Pattern queries evaluate on every accepted batch, and
their operator state is the ``analytics`` checkpoint section), the
bring-your-own rule engine (``rules.programs_enabled``, on by default as
in the reference; its fired programs re-enter through the dispatcher's
``inject_rule_alerts`` and its programs and attributes are the
``rule-programs`` checkpoint section), the batcher, the pipeline
dispatcher with its device-fault containment (the breaker and the
watchdog of ``runtime/devguard.py``: bisection, single-step re-dispatch,
and a fail-closed exit on a card error and at the breaker's FALLBACK
level on a card), the
control plane (the flight recorder, ``flightrec.*``; the SLO burn-rate
engine, ``slo.*``; overload admission and shedding, ``overload.*``, with
per-tenant budgets from ``tenants.<token>.overload``; the tenant usage
ledger and its quotas, ``metering.*``, with per-tenant quotas from
``tenants.<token>.quota``; the tenant partition views of the device
state, ``state.partition_min_capacity``), the dead-letter listing and
requeue (:meth:`list_dead_letters`, :meth:`requeue_dead_letter`), the
ingest sources (the config's ``sources`` section, built through
``ingest/factory.py build_sources`` at :meth:`start`, or attached with
:meth:`add_source`) with the decode pool that decodes their payloads on
its workers (``ingest.decode_workers``, 2 by default; 0 decodes on the
receiver's thread) and the checkpointer (with the segment catalog's,
the ``runtime`` and the ``tenant-metering`` sections), the outbound
connectors (``outbound``: the ``OutboundConnectorsManager``, which the
dispatcher's egress offers every accepted batch after persistence and
the analytics runner its matches; connectors are attached in code with
``outbound.add_connector``), the presence manager (``presence.*``: its
sweeps flag devices silent past ``missing_after_s`` and their
STATE_CHANGE rows re-enter through the dispatcher's ``inject_batch``),
the ``"local"`` event search provider (``search_providers``), the
device streams (``streams``, ``stream_manager``: host-plane stream
create, data and send requests from the sources and the wire), the users
and their JWTs (``users``, ``tokens``; ``security.jwt_secret``), the
tenants with one engine each (``tenants``, ``engines``: the
``MultitenantEngineManager`` builds every tenant's engine as service
façades over the shared identity map and mirror, so an engine's
``tenant_id`` keys its rows in the shared tensors; the ``default``
tenant's engine is the instance's own services), the QR label generators
(``labels``, switched off by the overload ladder from DEGRADED up), the
uploadable scripts (``scripts``: decoders named after a script in a
``sources`` entry, routers, encoders and processors), the schedules with
their jobs and the batch command operations (``schedules``,
``batch_ops``; ``batch.throttle_delay_ms``), and the bootstrap from an
:class:`InstanceTemplate` (users and tenants ensured on every
:meth:`start`, its dataset initializers run once, gated by a marker
file).  The attributes keep the reference's names, since the
:class:`~sitewhere_tpu_torch.runtime.checkpoint.Checkpointer` reads
them.

Components the reference composes by default and this instance does NOT
yet, so the port does less than the reference until their slices come
(line numbers in ``sitewhere_tpu/instance.py`` unless named):

- the fabric: :meth:`invoke_command` runs locally and has no peers to
  route an unknown assignment to, the ``forward-shed`` requeue finds
  no forwarder, and the federated and remote search providers
  (:694-706) have no peers to search;
- the mesh's per-shard breakers (``ShardBreakers``);
- the profiler endpoints that calibrate the watchdog's budgets
  (:1040-1060): the budgets stay at their defaults, soft 1 s, hard 10 s;
- the forwarder, so the ``runtime`` section's ``spools`` stay empty,
  and :meth:`topology` gives the local view only (no
  ``cluster_topology``, no ``forwarding`` entry).

The runner's ``outbound`` hook (its match fan-out), and its and the rule
engine's ``overload``, ``usage_ledger`` and ``quotas``, are wired.

Lifecycle, as in the reference:

- ``__init__`` builds the components, then restores the newest complete
  checkpoint generation (identity, the management stores, mirror, rules,
  device state, catalog manifest, the analytics queries with their
  operator state, the rule programs) before anything starts;
- :meth:`start` bootstraps from the template, builds the
  config-declared sources (decoder scripts resolved through
  ``scripts``), captures the
  journal end (``recover_upto``) before anything ingests, starts the
  store, the analytics runner, the rule
  engine, the dispatcher (whose warm-up builds the native scanners, the
  ``TokenTable`` mirror and the geofence kernel, and raises if any build
  fails) and the checkpointer, then replays the journal from the
  checkpoint's replay floor up to ``recover_upto`` while the sources
  already receive (the runner drops the
  replayed rows already inside its restored state, row-exactly), and
  sets the ``recovery.restore_s``, ``recovery.replay_s`` and
  ``recovery.replay_events`` gauges;
- :meth:`stop` stops the sources, drains the decode pool, then stops
  the other children in reverse: the presence thread, then the
  dispatcher flushes (every row egressed and sealed, the offset
  committed) while the rule engine, the analytics runner and the
  outbound workers still run, then those stop (a connector worker drops
  what is still queued, as in the reference: call ``outbound.drain``
  first to deliver it), then the store; a final generation is saved.

Configuration: the reference's keys and defaults
(:mod:`~sitewhere_tpu_torch.runtime.config`), plus two of the port's own,
``pipeline.max_zones`` and ``pipeline.max_zone_verts`` (the registry
mirror's zone table; defaults 256 and 32, the reference mirror's).  The
keys in :data:`HONOURED` drive the instance.  Sections whose components
the port does not have yet (``rpc`` and the rest) are not composed: at
their defaults the instance runs without them, and any other value
raises :class:`NotImplementedError`.  The ``outbound`` section's ``connectors`` key is such a value: the
reference builds no connector from config either.  Events arrive
through the sources, or through ``instance.dispatcher``
(``ingest_wire_lines`` and the other entry points) on the caller's
thread.

The instance runs on the card unless ``device="cpu"`` is named.  With
``pipeline.n_shards`` above 1 it runs the sharded pipeline over a mesh of
that many shards (the reference's ``make_mesh``): ``device`` may then be
one device, which hosts every shard, or a sequence of ``n_shards``
devices; ``None`` takes ``cuda:0`` and up and raises when fewer cards
are visible.  ``pipeline.packed_step`` (then ``SW_TPU_PACKED_STEP``)
chooses the packed or the unpacked step interface; packed by default.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pickle
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from sitewhere_tpu_torch.analytics.runner import QueryRunner
from sitewhere_tpu_torch.commands.model import CommandInvocation
from sitewhere_tpu_torch.commands.processing import CommandProcessor
from sitewhere_tpu_torch.device import resolve_device
from sitewhere_tpu_torch.ids import NULL_ID, IdentityMap
from sitewhere_tpu_torch.ingest.batcher import (
    _COL_FIELDS,
    _DTYPE,
    AdaptiveBatchController,
    Batcher,
)
from sitewhere_tpu_torch.ingest.decoders import (
    DecodedRequest,
    DecodeError,
    JsonLinesDecoder,
    RequestKind,
    encode_envelope,
)
from sitewhere_tpu_torch.ingest.factory import build_sources
from sitewhere_tpu_torch.ingest.journal import (
    CorruptJournal,
    Journal,
    JournalReader,
)
from sitewhere_tpu_torch.ingest.sources import DecodePool
from sitewhere_tpu_torch.parallel.mesh import make_mesh
from sitewhere_tpu_torch.labels.manager import LabelGeneratorManager
from sitewhere_tpu_torch.outbound.manager import OutboundConnectorsManager
from sitewhere_tpu_torch.outbound.search import (
    EventSearchProvider,
    SearchProvidersManager,
)
from sitewhere_tpu_torch.pipeline.packed import packed_env_override
from sitewhere_tpu_torch.pipeline.rules import RuleManager
from sitewhere_tpu_torch.rules.engine import RuleEngineRunner
from sitewhere_tpu_torch.runtime.checkpoint import (
    Checkpointer,
    StateProvider,
    merge_store,
)
from sitewhere_tpu_torch.runtime.config import DEFAULTS, Config
from sitewhere_tpu_torch.runtime.dispatcher import PipelineDispatcher
from sitewhere_tpu_torch.runtime.flightrec import FlightRecorder
from sitewhere_tpu_torch.runtime.lifecycle import (
    LifecycleComponent,
    LifecycleState,
)
from sitewhere_tpu_torch.runtime.metering import QuotaTable, UsageLedger
from sitewhere_tpu_torch.runtime.metrics import (
    BurnRateEngine,
    MetricsRegistry,
    SloTargets,
    global_registry,
)
from sitewhere_tpu_torch.runtime.overload import (
    OverloadController,
    OverloadShed,
    OverloadSignals,
    TenantBudgets,
    Watermarks,
)
from sitewhere_tpu_torch.runtime.resilience import dead_letter
from sitewhere_tpu_torch.runtime.scripting import ScriptManager
from sitewhere_tpu_torch.runtime.tracing import Tracer
from sitewhere_tpu_torch.schema import DEFAULT_EWMA_HALFLIVES_S
from sitewhere_tpu_torch.security.jwt import TokenManagement
from sitewhere_tpu_torch.security.users import UserManagement
from sitewhere_tpu_torch.services.assets import AssetManagement
from sitewhere_tpu_torch.services.batch_ops import BatchOperationManager
from sitewhere_tpu_torch.services.common import (
    EntityNotFound,
    ServiceError,
    ValidationError,
    mint_token,
    now_s,
)
from sitewhere_tpu_torch.services.device_management import (
    DeviceManagement,
    RegistryMirror,
)
from sitewhere_tpu_torch.services.registration import RegistrationManager
from sitewhere_tpu_torch.services.schedules import ScheduleManager
from sitewhere_tpu_torch.services.streams import (
    DeviceStreamManagement,
    DeviceStreamManager,
)
from sitewhere_tpu_torch.services.tenants import (
    MultitenantEngineManager,
    TenantEngine,
    TenantManagement,
)
from sitewhere_tpu_torch.state.manager import DeviceStateManager
from sitewhere_tpu_torch.state.presence import PresenceManager
from sitewhere_tpu_torch.store.catalog import catalog_state_provider
from sitewhere_tpu_torch.store.segmented import SegmentStore

logger = logging.getLogger("sitewhere_tpu_torch.instance")


class MultiHostUnavailable(ServiceError):
    """A call that needs the multi-host fabric (501 over REST)."""

    http_status = 501


#: Config keys this instance reads (dotted paths; a trailing ``.*`` takes
#: the whole section).
HONOURED = (
    "instance.*",
    "pipeline.width", "pipeline.registry_capacity", "pipeline.mtype_slots",
    "pipeline.deadline_ms", "pipeline.deadline_min_ms",
    "pipeline.deadline_max_ms", "pipeline.adaptive_deadline",
    "pipeline.egress_offload", "pipeline.ring_depth",
    "pipeline.inflight_depth", "pipeline.quarantine_after",
    "pipeline.ewma_halflives_s", "pipeline.max_zones",
    "pipeline.max_zone_verts", "pipeline.n_shards", "pipeline.packed_step",
    "journal.*", "events.*", "checkpoint.interval_s", "rules.*",
    "analytics.*", "registration.*",
    "dead_letters.retain_records",
    "tracing.sample_rate", "tracing.tail_errors", "tracing.tail_latency_ms",
    "tracing.pending_capacity",
    "overload.*", "metering.*", "slo.*", "flightrec.*", "tenants.*",
    "state.partition_min_capacity",
    "sources", "ingest.*", "presence.*",
    "security.jwt_secret", "batch.throttle_delay_ms",
    "telemetry.device_profile_on_start",
)


def _leaves(tree: Dict[str, Any], prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict) and value:
            yield from _leaves(value, path + ".")
        else:
            yield path, value


def _honoured(path: str) -> bool:
    return any(path == key or (key.endswith(".*")
                               and path.startswith(key[:-1]))
               for key in HONOURED)


def refuse_unsupported(config: Config) -> None:
    """Raise :class:`NotImplementedError` for a setting this instance
    cannot honour: a key outside :data:`HONOURED` whose value differs from
    the default."""
    defaults = dict(_leaves(DEFAULTS))
    for path, value in _leaves(config.as_dict()):
        if _honoured(path):
            continue
        if path not in defaults or defaults[path] != value:
            section = path.split(".", 1)[0]
            raise NotImplementedError(
                f"config {path}={value!r}: the port's Instance does not "
                f"compose the {section!r} component yet (see "
                "sitewhere_tpu_torch/instance.py)")


@dataclasses.dataclass
class InstanceTemplate:
    """Bootstrap template (the reference's instance templates: default
    users, tenants, and dataset initializers, Python callables in place
    of Groovy scripts)."""

    template_id: str = "default"
    users: List[Dict[str, object]] = dataclasses.field(
        default_factory=lambda: [
            {
                "username": "admin",
                "password": "password",
                "first_name": "Admin",
                "last_name": "User",
                "authorities": ["ROLE_ADMIN"],
            }
        ]
    )
    tenants: List[Dict[str, object]] = dataclasses.field(
        default_factory=lambda: [
            {"token": "default", "name": "Default Tenant",
             "auth_token": "sitewhere1234567890"}
        ]
    )
    # dataset initializers run once per instance with the Instance as arg
    # (the GroovyDeviceModelInitializer analog)
    dataset_initializers: List[Callable[["Instance"], None]] = \
        dataclasses.field(default_factory=list)


def _mesh_for(n_shards: int, device):
    """The instance's mesh: None for one shard, else ``n_shards`` shards
    over ``device`` (one device hosts them all; a sequence names each
    shard's; None takes the visible cards and raises when too few)."""
    if n_shards <= 1:
        return None
    if device is None:
        devices = None
    elif isinstance(device, (list, tuple)):
        devices = list(device)
    else:
        devices = [device] * n_shards
    return make_mesh(n_devices=n_shards, devices=devices)


class Instance(LifecycleComponent):
    """One configured instance of the port, on one card or over a mesh."""

    def __init__(self, config: Optional[Config] = None,
                 template: Optional[InstanceTemplate] = None,
                 device=None):
        super().__init__("instance")
        self.config = config or Config()
        refuse_unsupported(self.config)
        self.template = template or InstanceTemplate()
        n_shards = int(self.config["pipeline.n_shards"])
        # Multi-shard: one (shard, model) mesh; the dispatcher runs the
        # sharded step and the batcher routes rows to the owning shard
        # (the Kafka-partitioning analog)
        self.mesh = _mesh_for(n_shards, device)
        if self.mesh is not None:
            device = self.mesh.shard_devices[0]
        elif isinstance(device, (list, tuple)):
            if len(device) != 1:
                raise ValueError(
                    f"{len(device)} devices for a pipeline of one shard")
            device = device[0]
        self.device = resolve_device(device)
        dev = self.device
        self.instance_id = self.config["instance.id"]
        self.data_dir = os.path.abspath(self.config["instance.data_dir"])
        os.makedirs(self.data_dir, exist_ok=True)
        # one on-demand torch.profiler capture at a time
        self._profiler_lock = threading.Lock()
        self._profiler = None

        cap = int(self.config["pipeline.registry_capacity"])
        width = int(self.config["pipeline.width"])
        ewma_halflives = tuple(self.config.get(
            "pipeline.ewma_halflives_s", DEFAULT_EWMA_HALFLIVES_S))

        # identity and security (a shared JWT secret lets hosts verify
        # each other's service tokens, as the reference's one
        # instance-wide secret does)
        self.identity = IdentityMap(capacity=cap)
        self.users = UserManagement()
        jwt_secret = self.config.get("security.jwt_secret")
        self.tokens = TokenManagement(
            secret=jwt_secret.encode("utf-8") if jwt_secret else None)
        self.tenants = TenantManagement()
        self.mirror = RegistryMirror(
            capacity=cap,
            max_zones=int(self.config.get("pipeline.max_zones", 256)),
            max_verts=int(self.config.get("pipeline.max_zone_verts", 32)),
            device=dev)
        # the device system of record over the mirror
        self.device_management = DeviceManagement(
            "default", self.identity, self.mirror)
        self.rules = RuleManager(self.identity,
                                 ewma_halflives_s=ewma_halflives, device=dev)
        mirror = self.mirror
        self.device_state = DeviceStateManager(
            cap, self.identity,
            num_mtype_slots=int(self.config["pipeline.mtype_slots"]),
            tenant_id_of_device=lambda ids: mirror.tenant_id[ids],
            num_ewma_scales=len(ewma_halflives), device=dev,
            mesh=self.mesh)
        self.metrics = MetricsRegistry()

        # durable stores: the log-structured segment store (parallel
        # background seal off the egress worker, catalog-governed
        # retention and compaction, packed hot tier), the ingest journal
        # and the dead letters, which also take a store's terminal seal
        # failures.  On a mesh, segment shards key to MESH shards (the
        # registry block owning each device), so one egress segment's
        # columns append into one shard buffer.
        if self.mesh is not None:
            rows_per_shard = max(1, cap // n_shards)

            def store_shard_key(dev_ids, ten_ids, _r=rows_per_shard):
                return np.asarray(dev_ids, np.int64) // _r
        else:
            store_shard_key = None
        self.event_store = self.add_child(SegmentStore(
            self.data_dir,
            flush_interval_s=0.25,
            retention_s=self.config.get("events.retention_s"),
            resident_bytes=int(self.config["events.resident_bytes"]),
            n_shards=(n_shards if self.mesh is not None
                      else int(self.config["events.shards"])),
            shard_key=store_shard_key,
            seal_workers=int(self.config["events.seal_workers"]),
            hot_bytes=int(self.config["events.hot_bytes"]),
            compact_interval_s=float(
                self.config["events.compact_interval_s"]),
            metrics=self.metrics,
        ))
        # device streams: a journal-backed chunk store under the data
        # directory, and the request-level manager the host plane routes
        # stream create, data and send requests to
        self.streams = self.add_child(DeviceStreamManagement(self.data_dir))
        self.stream_manager = self.add_child(DeviceStreamManager(
            self.device_management, self.streams))
        # QR label generation, on the host
        self.labels = self.add_child(LabelGeneratorManager())
        self.ingest_journal = Journal(
            self.data_dir, name="ingest",
            fsync_every=int(self.config["journal.fsync_every"]),
            segment_bytes=int(self.config["journal.segment_bytes"]),
        )
        self.dead_letters = Journal(self.data_dir, name="dead-letters")
        self.event_store.dead_letters = self.dead_letters

        tail_ms = self.config.get("tracing.tail_latency_ms", 100.0)
        self.tracer = Tracer(
            sample_rate=float(self.config.get("tracing.sample_rate", 0.01)),
            tail_errors=bool(self.config.get("tracing.tail_errors", True)),
            tail_latency_s=(float(tail_ms) / 1e3
                            if tail_ms is not None else None),
            pending_capacity=int(
                self.config.get("tracing.pending_capacity", 512)))
        # runtime-uploadable scripts (the ScriptSynchronizer analog),
        # versioned under data_dir/scripts/
        self.scripts = ScriptManager(self.data_dir)

        # Flight recorder: an always-on bounded ring of per-batch records,
        # snapshotted to JSONL on anomaly (SLO burn alert, egress crash,
        # overload transition, device fault, watchdog trip)
        self.flightrec = None
        if bool(self.config.get("flightrec.enabled", True)):
            self.flightrec = FlightRecorder(
                data_dir=self.data_dir,
                capacity=int(self.config.get("flightrec.capacity", 2048)),
                min_snapshot_interval_s=float(self.config.get(
                    "flightrec.min_snapshot_interval_s", 5.0)),
                max_snapshots=int(self.config.get(
                    "flightrec.max_snapshots", 32)),
                metrics=self.metrics,
            )

        # SLO burn-rate engine: multi-window burn evaluation against the
        # reference's targets (1M events/s, a 10 ms p99, a 1% shed rate),
        # ticked by the dispatcher loop; alerts dump the flight recorder.
        # slo.throughput_eps=0 disables that objective.
        self.slo = None
        if bool(self.config.get("slo.enabled", True)):
            self.slo = BurnRateEngine(
                targets=SloTargets(
                    throughput_eps=float(self.config.get(
                        "slo.throughput_eps", 1_000_000.0)),
                    p99_ms=float(self.config.get("slo.p99_ms", 10.0)),
                    shed_rate=float(self.config.get(
                        "slo.shed_rate", 0.01))),
                windows_s=(float(self.config.get("slo.fast_window_s",
                                                 60.0)),
                           float(self.config.get("slo.slow_window_s",
                                                 600.0))),
                error_budget=float(self.config.get(
                    "slo.error_budget", 0.05)),
                alert_burn=float(self.config.get("slo.alert_burn", 2.0)),
                min_samples=int(self.config.get("slo.min_samples", 5)),
                lag_tolerance_s=float(self.config.get(
                    "slo.lag_tolerance_s", 2.0)),
                sample_interval_s=float(self.config.get(
                    "slo.sample_interval_s", 1.0)),
                sample_fn=self._slo_sample,
                metrics=self.metrics,
                tracer=self.tracer,
                on_alert=self._on_slo_alert,
            )
        self._slo_last = {"processed": 0, "shed": 0, "admitted": 0,
                          "at": None}

        # Overload control: a watermark-driven state machine over signals
        # the pipeline exports, ticked by the dispatcher loop; admission
        # at ingest hangs off its state.  Journal append, seal and
        # checkpoint are never gated by it.
        self.overload = None
        if bool(self.config.get("overload.enabled", True)):
            self.overload = OverloadController(
                watermarks=Watermarks().replace(
                    self.config.get("overload.watermarks") or {}),
                cooldown_s=float(self.config.get("overload.cooldown_s", 2.0)),
                hysteresis=float(self.config.get("overload.hysteresis", 0.7)),
                confirm_samples=int(self.config.get(
                    "overload.confirm_samples", 2)),
                sample_interval_s=float(self.config.get(
                    "overload.sample_interval_s", 0.1)),
                retry_after_s=float(self.config.get(
                    "overload.retry_after_s", 1.0)),
                degraded_telemetry_rate_per_s=float(self.config.get(
                    "overload.degraded_telemetry_rate_per_s", 10_000.0)),
                degraded_telemetry_burst=float(self.config.get(
                    "overload.degraded_telemetry_burst", 20_000.0)),
                budget_refresh_s=float(self.config.get(
                    "overload.budget_refresh_s", 5.0)),
                signals_fn=self._overload_signals,
                metrics=self.metrics,
                tracer=self.tracer,
            )
            # per-tenant budget overlays compose with (never replace) the
            # ledger's measured-share scaling
            self.overload.set_tenant_budgets(
                TenantBudgets.from_config(self.config.get("tenants")))
            # label rendering is optional work: refused from DEGRADED up
            self.labels.load_gate = self.overload.allow_optional
            if self.flightrec is not None:
                # every ladder move dumps the recorder
                self.overload.on_transition(
                    lambda old, new, signals: self._flightrec_dump_async(
                        f"overload-{new.name.lower()}",
                        f"{old.name}->{new.name}"))

        # Tenant metering: the sliding-window usage ledger, fed by the
        # packed step's tenant block (riding the fetch egress makes
        # anyway) and by host charges (shed, dead-letter, seal, rule and
        # analytics eval).  It feeds measured shares back into the
        # DEGRADED per-tenant rates.
        self.usage_ledger = None
        if bool(self.config.get("metering.enabled", True)):
            self.usage_ledger = UsageLedger(
                top_k=int(self.config.get("metering.top_k", 32)),
                window_s=float(self.config.get("metering.window_s", 60.0)),
                fair_share_frac=float(self.config.get(
                    "metering.fair_share_frac", 0.25)),
                min_rate_frac=float(self.config.get(
                    "metering.min_rate_frac", 0.1)),
            )
            self.usage_ledger.bind_metrics(
                self.metrics, resolve=self.identity.tenant.token_of)
            if self.overload is not None:
                self.overload.set_usage_ledger(
                    self.usage_ledger, resolve=self._tenant_dense_id)
            self.event_store.usage_ledger = self.usage_ledger

        # Metered quotas: per-tenant rule/analytics eval-seconds budgets
        # over the ledger's window, deprioritize then refuse; never on the
        # ingest path
        self.quotas = None
        if self.usage_ledger is not None and bool(self.config.get(
                "metering.quota.enabled", True)):
            self.quotas = QuotaTable(
                self.usage_ledger,
                default_eval_s=self.config.get(
                    "metering.quota.eval_s_per_window"),
                soft_frac=float(self.config.get(
                    "metering.quota.soft_frac", 0.8)),
                metrics=self.metrics,
            )
            tenants_cfg = self.config.get("tenants")
            if isinstance(tenants_cfg, dict):
                for tok, overlay in tenants_cfg.items():
                    quota = (overlay.get("quota")
                             if isinstance(overlay, dict) else None)
                    if isinstance(quota, dict) \
                            and "eval_s_per_window" in quota:
                        self.quotas.set_quota(
                            self._tenant_dense_id(str(tok)),
                            float(quota["eval_s_per_window"]))

        # Tenant-partitioned device-state views over the registry
        # mirror's tenant column
        def _tenant_column():
            return np.where(mirror.active, mirror.tenant_id, NULL_ID)

        self.device_state.attach_partitions(
            _tenant_column,
            min_capacity=int(self.config.get(
                "state.partition_min_capacity", 64)),
            metrics=self.metrics)

        # domain services the dispatcher egresses into, registered as
        # children BEFORE it so the reverse-order stop keeps them alive
        # through the dispatcher's shutdown flush
        self.assets = AssetManagement("default", self.identity)
        self.commands = self.add_child(CommandProcessor(
            self.device_management,
            on_undelivered=self._on_undelivered_command,
            metrics=self.metrics,
        ))
        self.batch_ops = self.add_child(BatchOperationManager(
            self.device_management, self.commands,
            throttle_delay_ms=int(self.config.get(
                "batch.throttle_delay_ms", 0)),
        ))
        self.schedules = self.add_child(ScheduleManager(executors={
            "CommandInvocation": self._run_scheduled_invocation,
            "BatchCommandInvocation": self._run_scheduled_batch,
        }))
        # one engine per tenant over the SHARED tensors, each restartable
        # on its own; the engines share the instance's identity map, so
        # their dense tenant ids are the pipeline's tenant column
        self.engines = self.add_child(MultitenantEngineManager(
            self.tenants,
            engine_factory=self._make_tenant_engine,
            tenant_ids=self.identity,
        ))

        # Outbound connectors: every accepted enriched batch fans out to
        # each connector's worker after persistence; from SHEDDING up only
        # priority connectors are offered batches.  Added before the
        # analytics runner and the dispatcher, so the reverse-order stop
        # keeps its workers alive through the dispatcher's shutdown flush
        # and the runner's last match fan-out.
        self.outbound = self.add_child(OutboundConnectorsManager(
            metrics=self.metrics, overload=self.overload))
        self.outbound.usage_ledger = self.usage_ledger

        # Streaming analytics: registered Window/Session/Pattern queries
        # evaluate live on every accepted batch (the dispatcher's egress
        # offers it to the runner's worker) and retrospectively over the
        # sealed store.  Added before the dispatcher so the reverse-order
        # stop keeps it alive through the dispatcher's shutdown flush.
        self.analytics = None
        if bool(self.config.get("analytics.enabled", True)):
            self.analytics = self.add_child(QueryRunner(
                capacity=cap,
                resolve_mtype=self.identity.mtype.mint,
                event_store=self.event_store,
                metrics=self.metrics,
                tracer=self.tracer,
                max_queries=int(self.config.get("analytics.max_queries", 32)),
                max_matches=int(self.config.get(
                    "analytics.max_matches", 1024)),
                queue_depth=int(self.config.get("analytics.queue_depth", 64)),
                fanout_matches=bool(self.config.get(
                    "analytics.fanout_matches", True)),
                outbound=self.outbound,
                overload=self.overload,
                device=dev,
            ))
            self.analytics.usage_ledger = self.usage_ledger
            self.analytics.quotas = self.quotas

        # Bring-your-own rules: per-tenant rule programs bucketed into
        # per-structure group passes.  Added before the dispatcher so the
        # reverse-order stop keeps the engine draining through the
        # dispatcher's shutdown flush.
        self.rule_engine = None
        if bool(self.config.get("rules.programs_enabled", True)):
            self.rule_engine = self.add_child(RuleEngineRunner(
                capacity=cap,
                n_mtype_slots=int(self.config.get("pipeline.mtype_slots", 8)),
                asset_capacity=int(self.config.get(
                    "rules.asset_capacity", 1024)),
                resolve_mtype=self.identity.mtype.mint,
                resolve_alert=self.identity.alert_type.mint,
                metrics=self.metrics,
                programs_per_tenant=int(self.config.get(
                    "rules.programs_per_tenant", 4)),
                max_programs=int(self.config.get(
                    "rules.max_programs", 262144)),
                queue_depth=int(self.config.get("rules.queue_depth", 64)),
                overload=self.overload,
                device=dev,
            ))
            self.rule_engine.usage_ledger = self.usage_ledger
            self.rule_engine.quotas = self.quotas

        self.registration = self.add_child(RegistrationManager(
            self.device_management,
            default_device_type=self.config.get(
                "registration.default_device_type"),
            allow_new_devices=bool(
                self.config.get("registration.allow_new_devices", True)),
        ))

        controller = None
        if bool(self.config.get("pipeline.adaptive_deadline", True)):
            controller = AdaptiveBatchController(
                deadline_ms=float(self.config["pipeline.deadline_ms"]),
                min_ms=self.config.get("pipeline.deadline_min_ms"),
                max_ms=self.config.get("pipeline.deadline_max_ms"),
                metrics=self.metrics,
            )
        self.batcher = Batcher(
            width=width,
            n_shards=n_shards,
            registry_capacity=cap,
            resolve_device=self.identity.device.lookup,
            resolve_mtype=self.identity.mtype.mint,
            resolve_alert=self.identity.alert_type.mint,
            invocations=self.identity.invocation,
            deadline_ms=float(self.config["pipeline.deadline_ms"]),
            emit_packed=self._packed_step_enabled(),
            metrics=self.metrics,
            controller=controller,
        )
        # Decode worker pool: wire payloads decode on these workers while
        # earlier windows are on the card; per-source lanes keep delivery
        # in submission order.  ingest.decode_workers=0 decodes on the
        # receiver's thread.  The workers own no CUDA stream: a delivery
        # that steps a plan launches on the thread's default stream, as
        # every other intake does.
        decode_workers = int(self.config.get("ingest.decode_workers", 2))
        self.decode_pool = (
            DecodePool(workers=decode_workers,
                       max_pending=int(self.config.get(
                           "ingest.decode_max_pending", 128)),
                       metrics=self.metrics)
            if decode_workers > 0 else None)
        ring_depth = self.config.get("pipeline.ring_depth")
        self.dispatcher = self.add_child(PipelineDispatcher(
            batcher=self.batcher,
            registry_provider=self.mirror.publish_registry,
            state_manager=self.device_state,
            rules_provider=self.rules.publish,
            zones_provider=self.mirror.publish_zones,
            event_store=self.event_store,
            registration=self.registration,
            on_command_rows=self._on_command_rows,
            outbound=self.outbound,
            rules_engine=self.rule_engine,
            analytics=self.analytics,
            journal=self.ingest_journal,
            dead_letters=self.dead_letters,
            resolve_tenant=self._tenant_dense_id,
            on_host_request=self._on_host_request,
            inflight_depth=int(self.config.get("pipeline.inflight_depth", 0)),
            egress_offload=self.config.get("pipeline.egress_offload"),
            ring_depth=int(ring_depth) if ring_depth is not None else None,
            journal_reader=JournalReader(self.ingest_journal, "pipeline"),
            tracer=self.tracer,
            metrics=self.metrics,
            quarantine_after=int(self.config.get(
                "pipeline.quarantine_after", 3)),
            overload=self.overload,
            flightrec=self.flightrec,
            slo=self.slo,
            usage_ledger=self.usage_ledger,
            device=dev,
            mesh=self.mesh,
        ))
        if self.rule_engine is not None:
            # fired tenant programs re-enter the pipeline as first-class
            # ALERT events through the dispatcher's derived-alert edge
            self.rule_engine.inject = self.dispatcher.inject_rule_alerts
        # Presence: a background sweep flags devices silent past
        # missing_after_s, once per episode; their STATE_CHANGE rows
        # re-enter the pipeline through the dispatcher
        self.presence = self.add_child(PresenceManager(
            self.device_state,
            check_interval_s=float(self.config["presence.scan_interval_s"]),
            missing_after_s=int(self.config["presence.missing_after_s"]),
            on_state_changes=self._on_presence_changes,
        ))
        self.sources: List[LifecycleComponent] = []
        self._config_sources_built = False

        # event search: the local store is the built-in index (the
        # federated provider over peers waits for the fabric)
        self.search_providers = SearchProvidersManager(
            [EventSearchProvider("local", self.event_store)])

        # checkpoint/resume: restore the newest complete snapshot BEFORE
        # start, so identity, registry, rules and device state survive a
        # restart; the journal replay in start() re-derives what was
        # journaled after each section's as-of offset.  The tenant
        # engines' façades wait in _engine_snapshots for their factory.
        self._engine_snapshots: Dict[str, dict] = {}
        self._dedup_snapshot: Dict[str, list] = {}
        self.checkpointer = self.add_child(Checkpointer(
            self,
            interval_s=float(self.config.get("checkpoint.interval_s", 30.0)),
            prune_journal=bool(self.config.get(
                "journal.prune_after_checkpoint", False)),
        ))
        if self.analytics is not None:
            # live query/CEP state: open windows, rings, sessions, pattern
            # stages, with the exact journal offset it is applied up to
            self.checkpointer.register_provider(StateProvider(
                name="analytics",
                snapshot_fn=self.analytics.snapshot_state,
                restore_fn=self.analytics.restore_state,
                version=1))
        if self.rule_engine is not None:
            # tenant rule programs + attribute tables (the docs are the
            # durable identity; operand tables rebuild on the first
            # publish after a restore)
            self.checkpointer.register_provider(StateProvider(
                name="rule-programs",
                snapshot_fn=self.rule_engine.snapshot_state,
                restore_fn=self.rule_engine.restore_state,
                version=1))
        # the sources' dedup windows (and the forward-spool cursors,
        # empty: the port has no forwarder)
        self.checkpointer.register_provider(StateProvider(
            name="runtime",
            snapshot_fn=self._snapshot_runtime_state,
            restore_fn=self._restore_runtime_state,
            version=1))
        self.checkpointer.register_provider(
            catalog_state_provider(self.event_store))
        if self.usage_ledger is not None:
            # tenant usage totals and the heavy-hitter / count-min
            # sketches, as JSON (readable across packages); the sliding
            # window restarts empty
            self.checkpointer.register_provider(StateProvider(
                name="tenant-metering",
                snapshot_fn=self.usage_ledger.snapshot_payload,
                restore_fn=self.usage_ledger.restore_payload,
                version=1))
        self.restored = self.checkpointer.restore()

    # -- bootstrap (service-instance-management) ----------------------------

    def _packed_step_enabled(self) -> bool:
        """Config ``pipeline.packed_step`` (true/false) pins the step
        interface; otherwise ``SW_TPU_PACKED_STEP``; the default is the
        packed step, on every backend, as in the reference: the
        dispatcher's egress reads one ``[10, B]`` block per step instead
        of many output buffers."""
        cfg = self.config.get("pipeline.packed_step", "auto")
        if isinstance(cfg, bool):
            return cfg
        if str(cfg).lower() in ("true", "false"):
            return str(cfg).lower() == "true"
        env = packed_env_override()
        return True if env is None else env

    @property
    def _marker_path(self) -> str:
        return os.path.join(self.data_dir, ".bootstrapped")

    @property
    def bootstrapped(self) -> bool:
        return os.path.exists(self._marker_path)

    def bootstrap(self) -> bool:
        """Ensure the template's users and tenants exist (on every start:
        the management stores live in memory until a checkpoint restores
        them) and run its dataset initializers ONCE; the marker file gates
        only the initializers, as the reference's bootstrapped marker
        gates its Groovy scripts.  Returns True if the initializers ran."""
        for spec in self.template.users:
            spec = dict(spec)
            authorities = list(spec.pop("authorities", []))
            existing = {a.authority
                        for a in self.users.list_granted_authorities()}
            for auth in authorities:
                if auth not in existing:
                    self.users.create_granted_authority(auth)
            if not any(u.username == spec["username"] for u in
                       self.users.list_users()):
                self.users.create_user(authorities=authorities, **spec)
        known = {t.token for t in self.tenants.list_tenants()}
        for spec in self.template.tenants:
            if spec["token"] not in known:
                self.tenants.create_tenant(**spec)
            self._tenant_dense_id(spec["token"])
        if self.bootstrapped:
            logger.info("instance %s already bootstrapped", self.instance_id)
            return False
        for initializer in self.template.dataset_initializers:
            initializer(self)
        with open(self._marker_path, "w") as f:
            json.dump({"template": self.template.template_id}, f)
        logger.info("bootstrapped instance %s from template %s",
                    self.instance_id, self.template.template_id)
        return True

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        self.bootstrap()
        # Config-declared sources, attached before the lifecycle start
        # below brings them up; a bad declaration fails boot
        source_docs = self.config.get("sources")
        if source_docs and not self._config_sources_built:
            for src in build_sources(source_docs, scripts=self.scripts):
                self.add_source(src)
            self._config_sources_built = True
        # the journal end BEFORE the sources start: the recovery replay
        # never re-ingests a fresh append racing it
        recover_upto = self.ingest_journal.end_offset
        super().start()
        if bool(self.config.get("telemetry.device_profile_on_start",
                                False)):
            # boot-time device-stage calibration off the data path: the
            # probes run on a background thread (on a stream of their
            # own) and land in the device.stage_ms.* histograms when done
            def _calibrate():
                try:
                    self.run_device_profile()
                except Exception:
                    logger.exception("device-stage calibration failed")

            threading.Thread(target=_calibrate, daemon=True,
                             name="device-profile").start()
        t0 = time.perf_counter()
        replayed = self.dispatcher.replay_journal(
            upto=recover_upto,
            from_offset=self.checkpointer.replay_floor)
        replay_s = time.perf_counter() - t0
        self.metrics.gauge("recovery.restore_s").set(
            self.checkpointer.restore_s)
        self.metrics.gauge("recovery.replay_events").set(replayed)
        self.metrics.gauge("recovery.replay_s").set(replay_s)
        if replayed:
            logger.info("recovered %d journaled events in %.3fs on start "
                        "(floor %s)", replayed, replay_s,
                        self.checkpointer.replay_floor)
        if self.restored and self.flightrec is not None:
            # every restore leaves a flight-recorder snapshot with the
            # replay's batch records and the recovery numbers
            self.flightrec.snapshot(
                "recovery",
                detail=(f"restored gen {self.checkpointer.restored_generation}"
                        f" in {self.checkpointer.restore_s:.3f}s; replayed "
                        f"{replayed} events in {replay_s:.3f}s from floor "
                        f"{self.checkpointer.replay_floor}"))

    def stop(self) -> None:
        # Stop the receivers, THEN drain the decode pool: a payload a
        # running receiver accepts after the drain would otherwise reach
        # the dispatcher during (or after) its shutdown flush.  The
        # sources are the last children, so super().stop() would stop
        # them first too; it skips them now.
        if self.decode_pool is not None:
            for src in self.sources:
                if src.state == LifecycleState.STARTED:
                    try:
                        src.stop()
                    except Exception:  # keep stopping, like super().stop()
                        logger.exception("error stopping %s", src.name)
            self.decode_pool.flush()
        # the other children stop in reverse: the checkpointer's interval
        # thread, then the dispatcher (its flush egresses and seals every
        # row and commits the final offset), then the rule engine and the
        # analytics runner (each drains what the flush offered), then the
        # store.  The final snapshot comes AFTER that flush and captures
        # the committed offset before reading any component, so it never
        # claims rows the journal offset has not sealed.
        super().stop()
        self.checkpointer.save()

    def terminate(self) -> None:
        super().terminate()
        if self.decode_pool is not None:
            # release the pool's worker threads
            self.decode_pool.stop(timeout_s=2.0)
            self.decode_pool = None
        self.ingest_journal.close()
        self.dead_letters.close()

    # -- topology (admin surface) -------------------------------------------

    def topology(self) -> dict:
        """The live component tree and counters of this host (the
        reference's ``TopologyStateAggregator`` feed).  The port has no
        fabric, so no ``forwarding`` entry."""
        topo = {
            "instance": self.instance_id,
            "bootstrapped": self.bootstrapped,
            "components": self.status_tree(),
            "pipeline": self.dispatcher.metrics_snapshot(),
            "devices": len(self.identity.device),
            "events_stored": self.event_store.total_events,
            "store": self.event_store.store_stats(),
            "tracing": self.tracer.stats(),
            # cross-cutting resilience counters (retries, breaker
            # transitions, supervisor restarts, dead-letter totals)
            "resilience": {
                k: v for k, v in
                global_registry().snapshot()["counters"].items()
                if k.startswith("resilience.")
            },
        }
        if self.overload is not None:
            topo["overload"] = self.overload.snapshot()
        if self.flightrec is not None:
            topo["flightrec"] = self.flightrec.stats()
        if self.slo is not None:
            topo["slo"] = self.slo.snapshot()
        return topo

    def cluster_topology(self) -> dict:
        """Every host's topology (the reference's :1900).  The port runs
        one host and polls no peers, so this is the single-host view."""
        return {"local": self.topology(), "peers": {}}

    def apply_membership_change(self, new_peers: List[str],
                                process_id: Optional[int] = None) -> dict:
        """Cluster grow or shrink (the reference's :842) needs the
        multi-host fabric, which the port does not compose yet: refused,
        never a silent success."""
        raise MultiHostUnavailable(
            "cluster membership changes need the multi-host fabric, which "
            "this instance does not have (ROADMAP.md queue 1 item 10)")

    # -- device telemetry (on-demand profiling) -------------------------------

    def run_device_profile(self, iters: int = 16,
                           repeats: int = 3) -> dict:
        """On-demand device-stage calibration at this instance's width
        and its live table capacities: records ``device.stage_ms.*``
        histogram samples, re-anchors the watchdog's budgets to the
        measured full step and returns the stage medians."""
        from sitewhere_tpu_torch.pipeline.telemetry import (
            profile_device_stages,
        )

        # the LIVE table shapes: the dense rule and zone passes cost what
        # this deployment's capacities make them cost
        rules = self.rules.publish()
        zones = self.mirror.publish_zones()
        result = profile_device_stages(
            width=int(self.config["pipeline.width"]),
            capacity=int(self.config["pipeline.registry_capacity"]),
            rules_capacity=int(rules.threshold.shape[0]),
            zones_capacity=int(zones.nvert.shape[0]),
            zone_verts=int(zones.verts.shape[1]),
            iters=iters, repeats=repeats, metrics=self.metrics,
            device=self.device)
        full_ms = result.get("full_ms")
        if full_ms:
            # the hung-step watchdog's soft/hard budgets from the
            # MEASURED step (floored inside calibrate)
            self.dispatcher.watchdog.calibrate(float(full_ms))
        return result

    def start_profiler_capture(self) -> dict:
        """Start an on-demand ``torch.profiler`` trace (host ops and, on a
        card, its kernels) into ``<data_dir>/profiles/capture-<t>``.  One
        capture at a time, owned by a thread of its own, so a stop from
        any thread ends it; returns the trace directory."""
        from sitewhere_tpu_torch.pipeline.telemetry import ProfilerCapture

        # the lock makes check-then-start atomic: two racing starts yield
        # one capture and one honest "already running" error
        with self._profiler_lock:
            if self._profiler is not None:
                raise ValidationError(
                    "profiler capture already running: "
                    f"{self._profiler.trace_dir}")
            trace_dir = os.path.join(
                self.data_dir, "profiles", f"capture-{int(time.time())}")
            os.makedirs(trace_dir, exist_ok=True)
            try:
                self._profiler = ProfilerCapture(
                    trace_dir, cuda=self.device.type == "cuda")
            except Exception as e:
                raise ValidationError(f"torch profiler unavailable: {e}")
        logger.info("torch profiler capture started -> %s", trace_dir)
        return {"capturing": True, "trace_dir": trace_dir}

    def stop_profiler_capture(self) -> dict:
        """Stop the running capture and write its trace."""
        with self._profiler_lock:
            if self._profiler is None:
                raise ValidationError("no profiler capture running")
            trace_dir = self._profiler.trace_dir
            try:
                self._profiler.stop()
            except Exception as e:
                # keep the capture: a failed stop stays retryable (clearing
                # it first would wedge both endpoints)
                raise ValidationError(f"profiler stop failed: {e}")
            self._profiler = None
        logger.info("torch profiler capture stopped (%s)", trace_dir)
        return {"capturing": False, "trace_dir": trace_dir}

    # -- control-plane wiring -----------------------------------------------

    def _tenant_dense_id(self, token: str) -> int:
        return self.identity.tenant.mint(token)

    def _make_tenant_engine(self, tenant, tenant_id: int,
                            config: Dict[str, object]) -> TenantEngine:
        """Engine factory: per-tenant service façades over the instance's
        shared identity map and registry mirror, with the per-tenant
        overlay ``tenants.<token>`` of the instance config."""
        overlay = dict(config)
        per_tenant = self.config.get(f"tenants.{tenant.token}", None)
        if isinstance(per_tenant, dict):
            overlay.update(per_tenant)
        if tenant.token == "default":
            # the instance-level services ARE the default tenant's engine
            return TenantEngine(
                tenant, tenant_id, overlay,
                identity=self.identity, mirror=self.mirror,
                device_management=self.device_management,
                asset_management=self.assets,
            )
        engine = TenantEngine(
            tenant, tenant_id, overlay,
            identity=self.identity, mirror=self.mirror,
        )
        # checkpoint resume: hydrate the engine's host dicts (its rows in
        # the shared tensors came back with the mirror).  ``get``, not
        # ``pop``: a rebuild restart or a retried start hydrates again.
        snap = self._engine_snapshots.get(tenant.token)
        if snap:
            merge_store(engine.device_management,
                        snap.get("device_management", {}))
            merge_store(engine.asset_management, snap.get("assets", {}))
            engine.device_management.reindex()
        return engine

    def _overload_signals(self) -> OverloadSignals:
        """One sample of the pressure signals the overload controller
        watches, read lock-free (a stale read delays a transition by one
        sample)."""
        d = self.dispatcher
        pool = self.decode_pool
        decode_backlog = (pool.pending / pool.max_pending
                          if pool is not None and pool.max_pending else 0.0)
        return OverloadSignals(
            # the LIVE watermark (the oldest unsealed event's age), which
            # decays as work seals
            seal_lag_s=d.oldest_unsealed_wait_s(),
            decode_backlog=decode_backlog,
            # ring-held plans are emitted, unstepped work: in-flight
            # pressure all the same
            egress_inflight=((len(d._inflight) + len(d._ring))
                             / max(1, d.egress_queue_depth)),
            batcher_backlog=self.batcher.pending / max(1, self.batcher.width),
            fsync_latency_s=float(self.ingest_journal.last_fsync_s),
        )

    # -- ingest sources -------------------------------------------------------

    def add_source(self, source: LifecycleComponent) -> LifecycleComponent:
        """Attach an ingest source wired into the dispatcher (the
        reference's single-host branch): requests to ``ingest`` /
        ``ingest_many``, raw wire payloads to ``ingest_wire_lines`` with
        its split halves for the decode pool, registrations, failed
        decodes, host-plane requests, and the dedup window re-seeded from
        the restored ``runtime`` section."""
        d = self.dispatcher
        source.on_event = d.ingest
        if hasattr(source, "on_events"):
            # batch forward: one columnar call per wire payload
            source.on_events = d.ingest_many
        if getattr(source, "raw_wire", False):
            # raw lane: C columnar decode and in-scanner token
            # resolution; decode errors come back to the source for its
            # failure accounting
            source.on_wire_payload = (
                lambda p, sid: d.ingest_wire_lines(
                    p, sid, raise_on_decode_error=True))
            # split halves for the decode pool: decode on a worker,
            # journal and batch in per-source order
            source.on_wire_decode = d.decode_wire_lines
            source.on_wire_decoded = d.ingest_wire_decoded
        source.on_registration = d.ingest_registration
        if self.decode_pool is not None and hasattr(source, "decode_pool"):
            # the source itself keeps ack-gated receivers synchronous
            source.decode_pool = self.decode_pool
        # checkpoint resume: a restart keeps refusing the duplicates the
        # window had caught
        dedup_keys = self._dedup_snapshot.get(source.name)
        if dedup_keys and getattr(source, "deduplicator", None) is not None \
                and hasattr(source.deduplicator, "import_keys"):
            source.deduplicator.import_keys(dedup_keys)
        source.on_failed_decode = d.ingest_failed_decode
        if getattr(source, "on_host_request", None) is None:
            source.on_host_request = self._on_host_request
        self.sources.append(self.add_child(source))
        return source

    def _on_host_request(self, req, payload: bytes = b"") -> None:
        """Route host-plane requests from sources and the wire to the
        ``DeviceStreamManager`` (stream create, data and send-back,
        handled by the receiving host).  A request the manager refuses
        (no such stream, device not assigned) dead-letters as
        ``failed-stream-request`` with the raw request, so the requeue
        can replay it; any other kind as ``unsupported-host-request``."""
        try:
            if req.kind == RequestKind.STREAM_CREATE:
                self.stream_manager.handle_device_stream_request(
                    req.device_token, req.stream_id,
                    req.content_type or "application/octet-stream")
                return
            if req.kind == RequestKind.STREAM_DATA:
                self.stream_manager.handle_device_stream_data_request(
                    req.device_token, req.stream_id,
                    req.sequence_number, req.stream_data or b"")
                return
            if req.kind == RequestKind.STREAM_SEND:
                self.stream_manager.handle_send_device_stream_data_request(
                    req.device_token, req.stream_id, req.sequence_number)
                return
        except ServiceError as e:
            self.dead_letters.append_json({
                "kind": "failed-stream-request",
                "request_kind": req.kind.name,
                "device_token": req.device_token,
                "stream_id": req.stream_id,
                "error": str(e),
                "payload": (payload or encode_envelope(req)).hex(),
            })
            return
        self.dead_letters.append_json({
            "kind": "unsupported-host-request",
            "request_kind": req.kind.name,
            "device_token": req.device_token,
        })

    def _snapshot_runtime_state(self):
        """The ``runtime`` section: each source's dedup LRU (so a restart
        does not re-admit the duplicates the window had caught) and the
        forward-spool cursors, empty here.  The reference's payload, a
        pickle of plain lists and ints, readable by either package."""
        dedup: Dict[str, list] = {}
        for src in self.sources:
            d = getattr(src, "deduplicator", None)
            if d is not None and hasattr(d, "export_keys"):
                dedup[src.name] = d.export_keys()
        return (pickle.dumps({"dedup": dedup, "spools": {}}, protocol=4),
                None)

    def _restore_runtime_state(self, header, payload) -> None:
        doc = pickle.loads(payload)
        # sources attach after __init__; add_source re-seeds from this
        self._dedup_snapshot = dict(doc.get("dedup") or {})

    def _slo_sample(self):
        """One SLO burn-rate sample: counter DELTAS since the previous
        sample (events processed, shed vs admitted) and the rolling p99."""
        now = time.monotonic()
        last = self._slo_last
        snap = self.dispatcher.metrics_snapshot()
        processed = int(snap.get("processed", 0))
        shed = (int(self.overload.shed_total)
                if self.overload is not None else 0)
        admitted = (int(self.overload.admitted_total)
                    if self.overload is not None else processed)
        sample = None
        if last["at"] is not None:
            events = processed - last["processed"]
            sample = {
                "events": events,
                "elapsed_s": max(1e-9, now - last["at"]),
                # the rolling p99 is evidence only while traffic flows
                "p99_ms": (snap.get("latency_p99_ms")
                           if events > 0 else None),
                "shed": shed - last["shed"],
                "admitted": admitted - last["admitted"],
                # a queue snapshot: rows pending while nothing completes
                # judge as a stall
                "backlog": int(snap.get("pending_rows", 0)),
            }
        self._slo_last = {"processed": processed, "shed": shed,
                          "admitted": admitted, "at": now}
        return sample

    def _flightrec_dump_async(self, reason: str, detail: str) -> None:
        """Anomaly dump off the calling thread: overload transitions and
        SLO alerts fire on the dispatcher loop, and a snapshot is a file
        write.  The thread touches no tensor."""
        threading.Thread(
            target=lambda: self.flightrec.anomaly(reason, detail=detail),
            daemon=True, name="flightrec-dump").start()

    def _on_slo_alert(self, objective: str, burn: float) -> None:
        """A burn alert armed: stamp the tail sampler and dump the flight
        recorder."""
        note = getattr(self.tracer, "note_anomaly", None)
        if note is not None:
            note()
        if self.flightrec is not None:
            self._flightrec_dump_async(f"slo-{objective}",
                                       f"burn {burn:.2f}x budget")

    # -- dead-letter operations ----------------------------------------------

    def list_dead_letters(self, limit: int = 100,
                          start: Optional[int] = None) -> List[dict]:
        """Dead-letter records with their offsets: without ``start`` the
        newest ``limit``, with it the first ``limit`` from that offset.
        Records already requeued carry ``"requeued": true``."""
        limit = max(1, limit)
        if start is None:
            begin = self.dead_letters.end_offset - limit
            stop = None
        else:
            begin = start
            stop = start + limit
        requeued = self._requeued_dead_letters()
        out: List[dict] = []
        for offset, raw in self.dead_letters.scan(max(0, begin), stop):
            try:
                doc = json.loads(raw)
            except ValueError:
                doc = {"kind": "corrupt", "raw": raw.hex()}
            if doc.get("kind") == "requeue-marker":
                continue  # bookkeeping, not an operator-facing record
            doc["offset"] = offset
            if offset in requeued:
                doc["requeued"] = True
            out.append(doc)
        return out[-limit:]

    def _requeued_dead_letters(self) -> set:
        """Offsets already requeued, rebuilt from the retained journal's
        marker records (cached against the journal end offset)."""
        end = self.dead_letters.end_offset
        cache = getattr(self, "_requeue_cache", None)
        if cache is not None and cache[0] == end:
            return cache[1]
        done: set = set()
        for _, raw in self.dead_letters.scan(0):
            try:
                doc = json.loads(raw)
            except ValueError:
                continue
            if doc.get("kind") == "requeue-marker":
                done.add(int(doc.get("target", -1)))
        self._requeue_cache = (end, done)
        return done

    def _mark_requeued(self, offset: int) -> None:
        """Durable idempotency marker: requeuing the same offset twice
        must not re-deliver."""
        self.dead_letters.append_json(
            {"kind": "requeue-marker", "target": int(offset)})

    def requeue_dead_letter(self, offset: int) -> dict:
        """Re-drive one dead-letter record through the pipeline.

        - ``failed-decode`` / ``intake-shed`` / ``tenant-budget``:
          re-decode the captured payload and re-ingest it; admission
          applies again, so a requeue while still overloaded (or still
          over the tenant's budget) is refused and stays un-requeued;
        - ``unregistered``: re-read each referenced journal payload and
          re-ingest it;
        - ``device-poison``: rebuild the isolated rows from the columns
          the document carries and re-ingest them;
        - ``undelivered-command``: re-invoke the command;
        - ``forward-shed``: refused here, the port has no forwarder.

        Requeue granularity is the payload (at-least-once)."""
        try:
            raw = self.dead_letters.read_one(int(offset))
        except KeyError:
            raise EntityNotFound(f"dead letter {offset} (pruned or invalid)")
        try:
            doc = json.loads(raw)
        except ValueError:
            raise ValidationError(f"dead letter {offset} is not requeueable "
                                  f"(corrupt record)")
        kind = doc.get("kind")
        if int(offset) in self._requeued_dead_letters():
            return {"requeued": False, "kind": kind, "already": True,
                    "reason": "record was already requeued"}
        decoder = JsonLinesDecoder()
        if kind == "forward-shed" and "payload" in doc:
            return {"requeued": False, "kind": kind,
                    "reason": "no forwarder on this host"}
        if kind in ("failed-decode", "failed-stream-request",
                    "intake-shed", "tenant-budget") and "payload" in doc:
            payload = bytes.fromhex(doc["payload"])
            try:
                reqs = decoder(payload)
            except DecodeError as e:
                self.dispatcher.ingest_failed_decode(
                    payload, doc.get("source", "requeue"), e)
                return {"requeued": False, "kind": kind,
                        "reason": f"decode failed again: {e}"}
            if not reqs:
                return {"requeued": False, "kind": kind,
                        "reason": "decode failed again: no rows decoded"}
            events = [r for r in reqs if r.event_type is not None]
            if kind == "tenant-budget" and events:
                # re-stamp rows without a tenant so the re-ingest checks
                # THAT tenant's current budget
                tenant = doc.get("tenant")
                if tenant:
                    for r in events:
                        if r.metadata is None or "tenant" not in r.metadata:
                            r.metadata = dict(r.metadata or {},
                                              tenant=tenant)
            if events:
                try:
                    self.dispatcher.ingest_many(events, payload,
                                                source_id="requeue")
                except OverloadShed as e:
                    reason = ("still over tenant budget"
                              if kind == "tenant-budget"
                              else "refused by admission")
                    return {"requeued": False, "kind": kind,
                            "reason": f"{reason}: {e}"}
            rows = len(events)
            for r in reqs:
                if r.event_type is not None:
                    continue
                if r.kind == RequestKind.REGISTRATION:
                    self.dispatcher.ingest_registration(r)
                else:
                    # host-plane (stream) request: re-route; a repeat
                    # failure dead-letters a fresh record
                    self._on_host_request(r, payload)
                    rows += 1
            self._mark_requeued(offset)
            return {"requeued": True, "kind": kind, "rows": rows}
        if kind == "unregistered" and doc.get("refs"):
            rows = 0
            missing: List[int] = []
            for ref in doc["refs"]:
                try:
                    payload = self.ingest_journal.read_one(int(ref))
                    reqs = [r for r in decoder(payload)
                            if r.event_type is not None]
                except Exception:
                    missing.append(int(ref))
                    continue
                if reqs:
                    self.dispatcher.ingest_many(reqs, payload)
                    rows += len(reqs)
            if rows > 0:
                self._mark_requeued(offset)
            return {"requeued": rows > 0, "kind": kind, "rows": rows,
                    **({"unreadable_refs": missing} if missing else {})}
        if kind == "device-poison" and doc.get("columns"):
            # rows isolated by the dispatcher's bisection: they re-enter
            # the normal batch path exactly as fresh ingest
            columns = doc["columns"]
            if "device_id" not in columns:
                return {"requeued": False, "kind": kind,
                        "reason": "poison record lacks device_id column"}
            cols = {
                field: np.asarray(columns[field],
                                  dtype=_DTYPE.get(field, np.float32))
                for field in _COL_FIELDS if field in columns
            }
            try:
                rows = self.dispatcher.requeue_rows(cols)
            except OverloadShed as e:
                return {"requeued": False, "kind": kind,
                        "reason": f"refused by admission: {e}"}
            self._mark_requeued(offset)
            return {"requeued": True, "kind": kind, "rows": rows}
        if kind == "undelivered-command" and doc.get("command") \
                and doc.get("assignment"):
            ok = self.commands.invoke(CommandInvocation(
                command_token=doc["command"],
                target_assignment=doc["assignment"],
                parameter_values=doc.get("parameterValues", {}),
                initiator="REQUEUE",
            ))
            if ok:
                self._mark_requeued(offset)
            return {"requeued": bool(ok), "kind": kind,
                    **({} if ok else {"reason": "delivery failed again"})}
        return {"requeued": False, "kind": kind,
                "reason": "record kind is not requeueable"}

    def _on_presence_changes(self, batch) -> None:
        """A sweep's STATE_CHANGE rows re-enter the pipeline (called on
        the presence thread, which owns no CUDA stream: the plans step on
        its current stream, as every other intake's do)."""
        self.dispatcher.inject_batch(batch, batch.valid.cpu().numpy())

    # -- command delivery ---------------------------------------------------

    def _on_command_rows(self, cols, mask, trace=None) -> None:
        """Deliver the plan's accepted COMMAND_INVOCATION rows (the
        reference's enriched-command-invocations -> command delivery).

        The row carries only dense handles; the command token and its
        parameters live in the journaled payload (``payload_ref``), read
        back as ONE JSON document: a command line inside a multi-line
        NDJSON record does not parse, and dead-letters as
        ``undeliverable-invocation`` like every row without a resolvable
        command, as in the reference."""
        refs = cols["payload_ref"][mask]
        device_ids = cols["device_id"][mask]
        for ref, dev in zip(refs, device_ids):
            invocation = None
            try:
                if int(ref) != NULL_ID:
                    doc = json.loads(self.ingest_journal.read_one(int(ref)))
                    body = doc.get("request", doc)
                    command = body.get("commandToken")
                    if command:
                        assignment = body.get("assignmentToken")
                        if not assignment:
                            token = self.identity.device.token_of(int(dev))
                            active = (self.device_management
                                      .get_active_assignment(token)
                                      if token else None)
                            assignment = active.token if active else None
                        if assignment:
                            kwargs = {}
                            if body.get("invocationToken"):
                                kwargs["token"] = str(body["invocationToken"])
                            invocation = CommandInvocation(
                                command_token=str(command),
                                target_assignment=str(assignment),
                                parameter_values=dict(
                                    body.get("parameterValues", {})),
                                initiator=str(body.get("initiator", "EVENT")),
                                initiator_id=body.get("initiatorId"),
                                **kwargs,
                            )
            except (ValueError, KeyError, CorruptJournal) as e:
                logger.debug("unresolvable command payload ref %s: %s", ref, e)
            if invocation is not None:
                self.commands.invoke(invocation, trace=trace)
            else:
                self.dead_letters.append_json({
                    "kind": "undeliverable-invocation",
                    "device_id": int(dev),
                    "payload_ref": int(ref),
                })

    def _on_undelivered_command(self, invocation, reason) -> None:
        """Undelivered commands dead-letter (the reference's
        undelivered-command-invocations topic)."""
        dead_letter(self.dead_letters, {
            "kind": "undelivered-command",
            "invocation": invocation.token,
            "command": invocation.command_token,
            "assignment": invocation.target_assignment,
            "parameterValues": invocation.parameter_values,
            "reason": str(reason),
        })

    def _run_scheduled_invocation(self, job) -> None:
        """Executor of CommandInvocation jobs (the reference's
        ``jobs/CommandInvocationJob.java``)."""
        self.commands.invoke(CommandInvocation(
            command_token=str(job.config["commandToken"]),
            target_assignment=str(job.config["assignmentToken"]),
            parameter_values=dict(job.config.get("parameterValues", {})),
            initiator="SCHEDULER",
            initiator_id=job.token,
        ))

    def _run_scheduled_batch(self, job) -> None:
        """Executor of BatchCommandInvocation jobs (the reference's
        ``jobs/BatchCommandInvocationJob.java``)."""
        self.batch_ops.create_batch_command_invocation(
            command_token=str(job.config["commandToken"]),
            parameter_values=dict(job.config.get("parameterValues", {})),
            devices=list(job.config.get("devices", [])) or None,
            group=job.config.get("group"),
        )

    def create_command_invocation(
            self, assignment_token: str, command_token: str,
            parameter_values: Optional[Dict[str, str]] = None,
            initiator: str = "REST", initiator_id: Optional[str] = None,
            ts_s: Optional[int] = None) -> dict:
        """Create a command-invocation EVENT for an assignment: journal
        the invocation body and let the pipeline's command-row egress
        deliver it (one delivery path: a direct ``commands.invoke`` would
        deliver twice), then flush.  Raises ``EntityNotFound`` when the
        assignment is not on this instance."""
        assignment = self.device_management.get_device_assignment(
            assignment_token)
        device = self.device_management.get_device(assignment.device)
        inv_token = mint_token("inv")
        event_ts = int(ts_s if ts_s is not None else now_s())
        payload = json.dumps({
            "deviceToken": device.token,
            "type": "commandinvocation",
            "request": {
                "commandToken": str(command_token),
                "assignmentToken": assignment_token,
                "parameterValues": dict(parameter_values or {}),
                "initiator": initiator,
                "initiatorId": initiator_id,
                "invocationToken": inv_token,
                # crash replay re-decodes this payload: without the
                # eventDate the recovered row would be stamped 1970 and
                # immediately TTL-pruned
                "eventDate": event_ts,
            },
        }).encode()
        self.dispatcher.ingest(DecodedRequest(
            kind=RequestKind.COMMAND_INVOCATION,
            device_token=device.token,
            ts_s=event_ts,
            # the invocation row carries the invocation handle so its
            # responses (correlated by the same token) query directly
            originating_event=inv_token,
        ), payload)
        self.dispatcher.flush()
        return {"queued": True, "token": inv_token,
                "deviceToken": device.token,
                "host": self.instance_id}

    def invoke_command(self, assignment_token: str, command_token: str,
                       parameter_values: Optional[Dict[str, str]] = None,
                       initiator: str = "REST",
                       initiator_id: Optional[str] = None,
                       ts_s: Optional[int] = None) -> dict:
        """The reference's federated invocation, on one instance: the
        assignment must be local (``EntityNotFound`` otherwise, which the
        reference answers only after asking its fabric peers; the port has
        none yet)."""
        return self.create_command_invocation(
            assignment_token, command_token=command_token,
            parameter_values=parameter_values, initiator=initiator,
            initiator_id=initiator_id, ts_s=ts_s)


__all__ = ["HONOURED", "Instance", "InstanceTemplate", "refuse_unsupported"]
