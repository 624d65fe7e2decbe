"""The port's composition root, as far as the slices ported so far go.

Counterpart of ``sitewhere_tpu/instance.py``'s :class:`Instance`, cut to
the components this package has: the identity map, the registry mirror,
the rule manager, the device-state manager, the segment store, the
ingest journal and its dead letters, the streaming analytics runner
(``analytics.enabled``, on by default as in the reference: registered
Window/Session/Pattern queries evaluate on every accepted batch, and
their operator state is the ``analytics`` checkpoint section), the
bring-your-own rule engine (``rules.programs_enabled``, on by default as
in the reference; its fired programs re-enter through the dispatcher's
``inject_rule_alerts`` and its programs and attributes are the
``rule-programs`` checkpoint section), the batcher, the pipeline
dispatcher and the checkpointer (with the segment catalog's section).
The attributes keep the reference's names, since the
:class:`~sitewhere_tpu_torch.runtime.checkpoint.Checkpointer` reads
them.

Components the reference composes by default and this instance does NOT
yet, so the port does less than the reference until their slices come
(line numbers in ``sitewhere_tpu/instance.py`` unless named):

- registration and its replay, the ``RegistrationManager`` (:495-501,
  passed to the dispatcher at :558): the port dead-letters rows of
  unregistered devices (``kind: "unregistered"``) instead of registering
  them and replaying the rows;
- command delivery, the dispatcher's command-rows leg
  (``sitewhere_tpu/runtime/dispatcher.py:2634-2639``, ``_on_command_rows``
  :1160): accepted COMMAND_INVOCATION rows are stored, never routed;
- overload control, the ``OverloadController`` (:283-340): no admission,
  no shedding;
- metering, the ``UsageLedger`` and ``QuotaTable`` (:341-386);
- the flight recorder and the SLO burn-rate engine (:224-274);
- the decode pool (:537-549): payloads decode on the caller's thread;
- tenant partitions of the device state (:388-403);
- outbound connectors, the ``OutboundConnectorsManager`` (:432-434);
- search providers (:692-706);
- presence scans, the ``PresenceManager`` (:592-597);
- device-fault containment, devguard, which the reference dispatcher
  composes (``sitewhere_tpu/runtime/dispatcher.py:531-602``);
- the ``runtime`` and ``tenant-metering`` checkpoint sections (:746-767).

The hooks the runner and the rule engine keep for those components stay
``None``: ``outbound`` (the runner's match fan-out), ``overload`` (both
shed as non-priority consumers from SHEDDING), ``usage_ledger`` and
``quotas`` (eval seconds billed and gated per tenant).

Lifecycle, as in the reference:

- ``__init__`` builds the components, then restores the newest complete
  checkpoint generation (identity, mirror, rules, device state, catalog
  manifest, the analytics queries with their operator state, the rule
  programs) before anything starts;
- :meth:`start` captures the journal end (``recover_upto``) before
  anything ingests, starts the store, the analytics runner, the rule
  engine, the dispatcher (whose warm-up builds the native scanners, the
  ``TokenTable`` mirror and the geofence kernel, and raises if any build
  fails) and the checkpointer, then replays the journal from the
  checkpoint's replay floor up to ``recover_upto`` (the runner drops the
  replayed rows already inside its restored state, row-exactly), and
  sets the ``recovery.restore_s``, ``recovery.replay_s`` and
  ``recovery.replay_events`` gauges;
- :meth:`stop` stops the children in reverse: the dispatcher flushes
  (every row egressed and sealed, the offset committed) while the rule
  engine and the analytics runner still run, then they drain, then the
  store stops; a final generation is saved.

Configuration: the reference's keys and defaults
(:mod:`~sitewhere_tpu_torch.runtime.config`), plus two of the port's own,
``pipeline.max_zones`` and ``pipeline.max_zone_verts`` (the registry
mirror's zone table; defaults 256 and 32, the reference mirror's).  The
keys in :data:`HONOURED` drive the instance.  Sections whose components
the port does not have yet (``sources``, ``overload``, ``metering``,
``outbound``, ``rpc``, ``registration``, ``presence``, the decode pool
and the rest) are not composed: at their defaults the instance runs
without them, and any other value raises :class:`NotImplementedError`,
as does ``pipeline.n_shards`` above 1.  Events are ingested through
``instance.dispatcher`` (``ingest_wire_lines`` and the other entry
points) on the caller's thread.

The instance runs on the card unless ``device="cpu"`` is named.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Iterator, Optional, Tuple

from sitewhere_tpu_torch.analytics.runner import QueryRunner
from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.ids import IdentityMap
from sitewhere_tpu_torch.ingest.batcher import AdaptiveBatchController, Batcher
from sitewhere_tpu_torch.ingest.journal import Journal, JournalReader
from sitewhere_tpu_torch.pipeline.rules import RuleManager
from sitewhere_tpu_torch.rules.engine import RuleEngineRunner
from sitewhere_tpu_torch.runtime.checkpoint import Checkpointer, StateProvider
from sitewhere_tpu_torch.runtime.config import DEFAULTS, Config
from sitewhere_tpu_torch.runtime.dispatcher import PipelineDispatcher
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry
from sitewhere_tpu_torch.runtime.tracing import Tracer
from sitewhere_tpu_torch.schema import DEFAULT_EWMA_HALFLIVES_S
from sitewhere_tpu_torch.services.device_management import RegistryMirror
from sitewhere_tpu_torch.state.manager import DeviceStateManager
from sitewhere_tpu_torch.store.catalog import catalog_state_provider
from sitewhere_tpu_torch.store.segmented import SegmentStore

logger = logging.getLogger("sitewhere_tpu_torch.instance")

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
    "pipeline.max_zone_verts",
    "journal.*", "events.*", "checkpoint.interval_s", "rules.*",
    "analytics.*",
    "dead_letters.retain_records",
    "tracing.sample_rate", "tracing.tail_errors", "tracing.tail_latency_ms",
    "tracing.pending_capacity",
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
    the default, or more than one pipeline shard."""
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
    if int(config["pipeline.n_shards"]) != 1:
        raise NotImplementedError(
            "config pipeline.n_shards > 1: the port runs one card; the "
            "sharded paths come with a later slice")


class Instance(LifecycleComponent):
    """One configured instance of the port on one card."""

    def __init__(self, config: Optional[Config] = None,
                 device: DeviceLike = None):
        super().__init__("instance")
        self.config = config or Config()
        refuse_unsupported(self.config)
        self.device = resolve_device(device)
        dev = self.device
        self.instance_id = self.config["instance.id"]
        self.data_dir = os.path.abspath(self.config["instance.data_dir"])
        os.makedirs(self.data_dir, exist_ok=True)

        cap = int(self.config["pipeline.registry_capacity"])
        width = int(self.config["pipeline.width"])
        ewma_halflives = tuple(self.config.get(
            "pipeline.ewma_halflives_s", DEFAULT_EWMA_HALFLIVES_S))

        self.identity = IdentityMap(capacity=cap)
        self.mirror = RegistryMirror(
            capacity=cap,
            max_zones=int(self.config.get("pipeline.max_zones", 256)),
            max_verts=int(self.config.get("pipeline.max_zone_verts", 32)),
            device=dev)
        self.rules = RuleManager(self.identity,
                                 ewma_halflives_s=ewma_halflives, device=dev)
        mirror = self.mirror
        self.device_state = DeviceStateManager(
            cap, self.identity,
            num_mtype_slots=int(self.config["pipeline.mtype_slots"]),
            tenant_id_of_device=lambda ids: mirror.tenant_id[ids],
            num_ewma_scales=len(ewma_halflives), device=dev)
        self.metrics = MetricsRegistry()

        # durable stores: the log-structured segment store (parallel
        # background seal off the egress worker, catalog-governed
        # retention and compaction, packed hot tier), the ingest journal
        # and the dead letters, which also take a store's terminal seal
        # failures
        self.event_store = self.add_child(SegmentStore(
            self.data_dir,
            flush_interval_s=0.25,
            retention_s=self.config.get("events.retention_s"),
            resident_bytes=int(self.config["events.resident_bytes"]),
            n_shards=int(self.config["events.shards"]),
            seal_workers=int(self.config["events.seal_workers"]),
            hot_bytes=int(self.config["events.hot_bytes"]),
            compact_interval_s=float(
                self.config["events.compact_interval_s"]),
            metrics=self.metrics,
        ))
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
                device=dev,
            ))

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
                device=dev,
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
            n_shards=1,
            registry_capacity=cap,
            resolve_device=self.identity.device.lookup,
            resolve_mtype=self.identity.mtype.mint,
            resolve_alert=self.identity.alert_type.mint,
            invocations=self.identity.invocation,
            deadline_ms=float(self.config["pipeline.deadline_ms"]),
            emit_packed=True,
            metrics=self.metrics,
            controller=controller,
        )
        ring_depth = self.config.get("pipeline.ring_depth")
        self.dispatcher = self.add_child(PipelineDispatcher(
            batcher=self.batcher,
            registry_provider=self.mirror.publish_registry,
            state_manager=self.device_state,
            rules_provider=self.rules.publish,
            zones_provider=self.mirror.publish_zones,
            event_store=self.event_store,
            rules_engine=self.rule_engine,
            analytics=self.analytics,
            journal=self.ingest_journal,
            dead_letters=self.dead_letters,
            resolve_tenant=self.identity.tenant.mint,
            inflight_depth=int(self.config.get("pipeline.inflight_depth", 0)),
            egress_offload=self.config.get("pipeline.egress_offload"),
            ring_depth=int(ring_depth) if ring_depth is not None else None,
            journal_reader=JournalReader(self.ingest_journal, "pipeline"),
            tracer=self.tracer,
            metrics=self.metrics,
            quarantine_after=int(self.config.get(
                "pipeline.quarantine_after", 3)),
            device=dev,
        ))
        if self.rule_engine is not None:
            # fired tenant programs re-enter the pipeline as first-class
            # ALERT events through the dispatcher's derived-alert edge
            self.rule_engine.inject = self.dispatcher.inject_rule_alerts

        # checkpoint/resume: restore the newest complete snapshot BEFORE
        # start, so identity, registry, rules and device state survive a
        # restart; the journal replay in start() re-derives what was
        # journaled after each section's as-of offset
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
        self.checkpointer.register_provider(
            catalog_state_provider(self.event_store))
        self.restored = self.checkpointer.restore()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        # the journal end BEFORE anything ingests: the recovery replay
        # never re-ingests a fresh append racing it
        recover_upto = self.ingest_journal.end_offset
        super().start()
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

    def stop(self) -> None:
        # children stop in reverse: the checkpointer's interval thread,
        # then the dispatcher (its flush egresses and seals every row and
        # commits the final offset), then the rule engine and the analytics
        # runner (each drains what the flush offered), then the store.  The final snapshot
        # comes AFTER that flush and captures the committed offset before
        # reading any component, so it never claims rows the journal
        # offset has not sealed.
        super().stop()
        self.checkpointer.save()

    def terminate(self) -> None:
        super().terminate()
        self.ingest_journal.close()
        self.dead_letters.close()


__all__ = ["HONOURED", "Instance", "refuse_unsupported"]
