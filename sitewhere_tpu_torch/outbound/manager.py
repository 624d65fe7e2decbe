"""Outbound connectors manager: fan each enriched batch to every connector.

Counterpart of ``sitewhere_tpu/outbound/manager.py``.  Each connector
processes each batch on its own worker thread from a bounded queue (a
full queue drops the batch for that connector and counts it), with
error isolation: a connector exception is counted and logged, never
propagated to the dispatcher.  From SHEDDING up the overload ladder
offers batches only to priority connectors.

Observability: ``submit`` carries the originating plan's trace (an
``outbound.deliver`` span per connector lands in the same trace) and
its ingest timestamp, for the ``outbound.queue_depth.<id>`` gauges, the
``outbound.ack_latency_s`` histogram (submit to successful process) and
the per-connector ``pipeline.ingest_to_outbound_ack_latency_s.<id>``
gauges.  Failed deliveries never record an ack.  The workers touch no
tensor: the columns they get are host arrays.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from sitewhere_tpu_torch.outbound.connectors import OutboundConnector
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.tracing import _NOOP_TRACE

logger = logging.getLogger("sitewhere_tpu_torch.outbound")


class OutboundConnectorsManager(LifecycleComponent):
    """Owns the connector set; dispatches batches to per-connector queues."""

    def __init__(self, connectors: Optional[List[OutboundConnector]] = None,
                 queue_depth: int = 64, metrics=None, overload=None):
        super().__init__("outbound-connectors")
        self.queue_depth = queue_depth
        self.metrics = metrics
        # degradation ladder (runtime/overload.py): from SHEDDING up,
        # batches are offered only to PRIORITY connectors (alert
        # notifiers, command bridges); bulk fan-out (search indexers,
        # file sinks, analytics taps) sheds and is counted per worker
        self.overload = overload
        # tenant metering hook (instance-wired): rows offered to at
        # least one connector bill ``outbound_rows`` to their tenant
        self.usage_ledger = None
        self._workers: Dict[str, "_Worker"] = {}
        for c in connectors or []:
            self.add_connector(c)

    def add_connector(self, connector: OutboundConnector) -> None:
        self.add_child(connector)
        worker = _Worker(connector, self.queue_depth, self.metrics)
        self._workers[connector.connector_id] = worker
        if self.state.name == "STARTED":
            worker.start()

    def start(self) -> None:
        super().start()
        for worker in self._workers.values():
            worker.start()

    def stop(self) -> None:
        for worker in self._workers.values():
            worker.shutdown()
        super().stop()

    def submit(self, cols: Dict[str, np.ndarray], mask: np.ndarray,
               trace=None, ingest_t0: Optional[float] = None) -> None:
        """Offer one enriched batch to every connector (non-blocking; a
        full queue drops the batch for that connector and counts it —
        backpressure stays local, like an overwhelmed consumer group).

        ``trace`` is the originating plan's trace (delivery spans join
        it); ``ingest_t0`` is the monotonic receive time of the plan's
        oldest row, for the ingest→outbound-ack watermark gauge."""
        item = (cols, mask, trace or _NOOP_TRACE, ingest_t0,
                time.monotonic())
        offered = 0
        for worker in self._workers.values():
            if (self.overload is not None
                    and not self.overload.allow_fanout(
                        getattr(worker.connector, "priority", False))):
                worker.overload_shed += 1
                if worker._m_shed is not None:
                    worker._m_shed.inc()
                continue
            worker.offer(item)
            offered += 1
        if offered and self.usage_ledger is not None:
            # bill fan-out per ROW × connectors offered: tenant cost
            # scales with how much delivery work their rows fan into
            try:
                tenants = cols.get("tenant_id") if hasattr(cols, "get") \
                    else None
                if tenants is not None:
                    self.usage_ledger.charge_rows_host(
                        np.asarray(tenants)[np.asarray(mask)],
                        "outbound_rows",
                        weights=np.full(int(np.asarray(mask).sum()),
                                        float(offered)))
            except Exception:
                logger.exception("outbound usage charge failed")

    def drain(self, timeout: float = 10.0) -> None:
        """Block until all queued batches are processed (tests/shutdown)."""
        for worker in self._workers.values():
            worker.drain(timeout)

    def stats(self) -> Dict[str, dict]:
        return {
            cid: {
                "processed": w.connector.processed,
                "errors": w.connector.errors,
                "dropped": w.dropped,
                "queued": w.q.qsize(),
            }
            for cid, w in self._workers.items()
        }


class _Worker:
    def __init__(self, connector: OutboundConnector, depth: int,
                 metrics=None):
        self.connector = connector
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.dropped = 0
        self.overload_shed = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        if metrics is not None:
            cid = connector.connector_id
            self._m_depth = metrics.gauge(f"outbound.queue_depth.{cid}")
            self._m_ack = metrics.histogram("outbound.ack_latency_s")
            # per connector: one shared gauge would be last-write-wins,
            # letting a fast connector mask a lagging one's watermark
            self._m_e2e = metrics.gauge(
                f"pipeline.ingest_to_outbound_ack_latency_s.{cid}")
            self._m_dropped = metrics.counter("outbound.batches_dropped")
            self._m_shed = metrics.counter(
                f"outbound.overload_shed.{cid}")
        else:
            self._m_depth = self._m_ack = self._m_e2e = None
            self._m_dropped = self._m_shed = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"outbound-{self.connector.connector_id}", daemon=True
        )
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            try:
                self.q.put_nowait(None)  # wake; a full queue still wakes the
            except queue.Full:           # worker on its next get()
                pass
            self._thread.join(timeout=5)
            self._thread = None

    def offer(self, item) -> None:
        try:
            self.q.put_nowait(item)
        except queue.Full:
            self.dropped += 1
            if self._m_dropped is not None:
                self._m_dropped.inc()
        if self._m_depth is not None:
            self._m_depth.set(self.q.qsize())

    def drain(self, timeout: float) -> None:
        # unfinished_tasks only reaches 0 after task_done() — i.e. after the
        # in-flight batch has fully processed, not merely been dequeued.
        # Wait on the queue's all_tasks_done condition (what Queue.join
        # waits on) instead of polling: task_done() notifies it, so the
        # drain wakes exactly when work completes and the deadline is
        # honored precisely, with zero CPU burned in between.
        deadline = time.monotonic() + timeout
        with self.q.all_tasks_done:
            while self.q.unfinished_tasks:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self.q.all_tasks_done.wait(remaining)

    def _loop(self) -> None:
        while not self._stop.is_set():
            item = self.q.get()
            try:
                if item is None:
                    continue
                cols, mask, trace, ingest_t0, t_submit = item
                delivered = False
                try:
                    with trace.span("outbound.deliver") as span:
                        span.tag("connector", self.connector.connector_id)
                        self.connector.process_batch(cols, mask)
                    delivered = True
                except Exception:
                    # isolation only: process_batch already counted the
                    # error and informed the connector's breaker
                    logger.exception("connector %s failed on batch",
                                     self.connector.connector_id)
                now = time.monotonic()
                if self._m_ack is not None:
                    if delivered:
                        # a failed batch is NOT an ack — recording it
                        # would make an outage read as healthy delivery.
                        # Exemplar is best-effort: a tail-candidate trace
                        # flips sampled at the dispatcher's end(), which
                        # an idle worker's fast ack can precede — such an
                        # ack carries no exemplar even when the trace is
                        # later retained (the e2e histogram's exemplar,
                        # recorded post-decision, is the authoritative
                        # bucket→trace link).
                        self._m_ack.observe(
                            now - t_submit,
                            trace_id=(trace.trace_id if trace.sampled
                                      else None))
                        if ingest_t0 is not None:
                            self._m_e2e.set(now - ingest_t0)
                    self._m_depth.set(self.q.qsize())
            finally:
                self.q.task_done()
