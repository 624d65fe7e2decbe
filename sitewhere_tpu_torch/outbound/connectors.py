"""Outbound connectors: deliver filtered event batches to external systems.

Counterpart of ``sitewhere_tpu/outbound/connectors.py``:

- :class:`CallbackConnector` — any Python callable;
- :class:`FileConnector` — JSON lines appended to a file;
- :class:`HttpConnector` — one JSON-array POST per batch to a webhook,
  keep-alive with one reconnect retry, :class:`DeliveryFailed` on a
  non-2xx answer;
- :class:`MqttOutboundConnector` — MQTT publish with a pluggable
  multicaster and route builder (over
  :class:`~sitewhere_tpu_torch.ingest.mqtt.MqttClient` or any client
  with ``publish``);
- :class:`IndexPushConnector` — bulk pushes to a search index, retained
  and retried with backoff on failure.

Connectors receive column batches and a surviving-row mask and marshal
rows (:func:`marshal_row`, the same JSON as the reference's, byte for
byte) only after filtering, so the host cost scales with delivered
events, not stream volume.
"""

from __future__ import annotations

import json
import logging
import os
import time
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from sitewhere_tpu_torch.outbound.filters import apply_filters
from sitewhere_tpu_torch.runtime import faults
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.resilience import (
    Backoff,
    CircuitBreaker,
    RetriesExhausted,
    RetryPolicy,
    call_with_retry,
    dead_letter,
)
from sitewhere_tpu_torch.schema import EventType

# One immediate retry on a fresh connection: a keep-alive socket the
# server already closed fails the first write/read, not the request.
_RECONNECT_RETRY = RetryPolicy(initial_s=0.0, max_s=0.0, max_attempts=1)

logger = logging.getLogger("sitewhere_tpu_torch.outbound")

Columns = Dict[str, np.ndarray]

def _camel(snake: str) -> str:
    head, *rest = snake.lower().split("_")
    return head + "".join(p.capitalize() for p in rest)


# camelCase display names derived from the schema enum — the single source
# of event-type codes stays sitewhere_tpu_torch.schema.EventType.
_EVENT_TYPE_NAMES = {int(et): _camel(et.name) for et in EventType}


def marshal_row(cols: Columns, row: int, identity=None) -> dict:
    """One event row → JSON-able dict (REST/export marshaling).

    With an :class:`~sitewhere_tpu_torch.ids.IdentityMap`, dense handles resolve
    back to tokens (host-side only — the reverse of the ingest edge).
    """
    etype = int(cols["event_type"][row])
    doc = {
        "eventType": _EVENT_TYPE_NAMES.get(etype, etype),
        "deviceId": int(cols["device_id"][row]),
        "tenantId": int(cols["tenant_id"][row]),
        "ts_s": int(cols["ts_s"][row]),
        "ts_ns": int(cols["ts_ns"][row]),
    }
    if identity is not None:
        token = identity.device.token_of(doc["deviceId"])
        if token is not None:
            doc["device"] = token
    if etype == EventType.MEASUREMENT:
        doc["mtypeId"] = int(cols["mtype_id"][row])
        doc["value"] = float(cols["value"][row])
    elif etype == EventType.LOCATION:
        doc.update(
            lat=float(cols["lat"][row]),
            lon=float(cols["lon"][row]),
            elevation=float(cols["elevation"][row]),
        )
    elif etype == EventType.ALERT:
        doc.update(
            alertCode=int(cols["alert_code"][row]),
            alertLevel=int(cols["alert_level"][row]),
        )
    elif etype in (EventType.COMMAND_INVOCATION, EventType.COMMAND_RESPONSE):
        doc["commandId"] = int(cols["command_id"][row])
    for name in ("area_id", "customer_id", "asset_id", "assignment_id", "device_type_id"):
        if name in cols:
            doc[_camel(name)] = int(cols[name][row])
    return doc


class OutboundConnector(LifecycleComponent):
    """Base: filter chain + batch delivery + failure counters.

    Reference: ``FilteredOutboundConnector`` + the per-connector metrics of
    ``OutboundConnector.java``.

    With a :class:`~sitewhere_tpu_torch.runtime.resilience.CircuitBreaker`
    attached, a connector whose ``deliver`` keeps RAISING trips the
    breaker and subsequent batches are SHED (counted in ``shed``,
    summarized to ``dead_letters``) instead of queueing behind a dead
    sink — the worker queue stays drained and the half-open probe
    re-admits traffic once the sink recovers.  Only exceptions that
    escape ``deliver`` count as failures: connectors that swallow their
    own errors keep their existing semantics.
    """

    def __init__(self, connector_id: str, filters=None,
                 breaker: Optional[CircuitBreaker] = None,
                 dead_letters=None, priority: bool = False):
        super().__init__(f"connector-{connector_id}")
        self.connector_id = connector_id
        self.filters = list(filters or [])
        self.breaker = breaker
        self.dead_letters = dead_letters
        # Overload ladder contract: priority connectors (alert
        # notifiers, command bridges) keep receiving batches in
        # SHEDDING/EMERGENCY; non-priority fan-out (search indexers,
        # bulk exporters, analytics taps) sheds first.
        self.priority = bool(priority)
        self._lock = threading.Lock()
        self.processed = 0
        self.errors = 0
        self.shed = 0

    def process_batch(self, cols: Columns, mask: np.ndarray) -> int:
        """Filter and deliver one column batch; returns rows delivered."""
        try:
            surviving = apply_filters(self.filters, cols, mask)
        except Exception:
            # a crashing filter is a connector error too (the manager
            # only logs); it says nothing about the SINK, so the
            # breaker's outcome window is left alone
            with self._lock:
                self.errors += 1
            raise
        n = int(surviving.sum())
        if not n:
            return 0
        if self.breaker is not None and not self.breaker.allow():
            with self._lock:
                self.shed += n
            dead_letter(self.dead_letters, {
                "kind": "connector-shed",
                "connector": self.connector_id,
                "rows": n,
            })
            return 0
        try:
            faults.fire("outbound.deliver")
            self.deliver(cols, surviving)
        except Exception:
            # the connector owns its error count (the manager only
            # isolates + logs); the breaker sees every escaped failure
            with self._lock:
                self.errors += 1
            if self.breaker is not None:
                self.breaker.record_failure()
            raise
        if self.breaker is not None:
            self.breaker.record_success()
        with self._lock:
            self.processed += n
        return n

    def deliver(self, cols: Columns, mask: np.ndarray) -> None:  # override
        raise NotImplementedError


class CallbackConnector(OutboundConnector):
    """Deliver through any callable (the Groovy-connector analog)."""

    def __init__(self, connector_id: str, fn: Callable[[Columns, np.ndarray], None],
                 filters=None, **kw):
        super().__init__(connector_id, filters, **kw)
        self.fn = fn

    def deliver(self, cols: Columns, mask: np.ndarray) -> None:
        self.fn(cols, mask)


class FileConnector(OutboundConnector):
    """Append surviving events as JSON lines (external-indexer analog)."""

    def __init__(self, connector_id: str, path: str, identity=None,
                 filters=None, **kw):
        super().__init__(connector_id, filters, **kw)
        self.path = path
        self.identity = identity
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def deliver(self, cols: Columns, mask: np.ndarray) -> None:
        rows = np.nonzero(mask)[0]
        with open(self.path, "a") as f:
            for row in rows:
                f.write(json.dumps(marshal_row(cols, int(row), self.identity)) + "\n")


class HttpConnector(OutboundConnector):
    """POST surviving events as a JSON array to a webhook URL.

    Reference: the SaaS push connectors — ``InitialStateEventsConnector``
    and ``DweetConnector`` (``service-outbound-connectors/.../initialstate``,
    ``.../dweetio``) are HTTPS POSTs of marshaled events to a per-account
    endpoint.  One generic webhook connector covers the shape; per-service
    envelopes are a ``transform`` away.  Delivery is batched (one request
    per surviving batch, not per event) and reuses the connection
    (keep-alive) until an error forces a reconnect.
    """

    def __init__(
        self,
        connector_id: str,
        url: str,
        identity=None,
        headers: Optional[Dict[str, str]] = None,
        transform: Optional[Callable[[List[dict]], bytes]] = None,
        timeout_s: float = 10.0,
        filters=None,
        **kw,
    ):
        super().__init__(connector_id, filters, **kw)
        from urllib.parse import urlsplit

        parts = urlsplit(url)
        if parts.scheme not in ("http", "https"):
            raise ValueError(f"unsupported webhook scheme: {parts.scheme!r}")
        self._scheme = parts.scheme
        self._netloc = parts.netloc
        self._path = parts.path or "/"
        if parts.query:
            self._path += "?" + parts.query
        self.identity = identity
        self.headers = dict(headers or {})
        self.transform = transform
        self.timeout_s = timeout_s
        self._conn = None

    def _connect(self):
        import http.client

        cls = (http.client.HTTPSConnection if self._scheme == "https"
               else http.client.HTTPConnection)
        return cls(self._netloc, timeout=self.timeout_s)

    def stop(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except Exception:
                pass
            self._conn = None
        super().stop()

    def _post(self, body: bytes, headers: Dict[str, str]) -> int:
        """One POST exchange, returning the status; transport failures
        drop the keep-alive connection and raise (retryable)."""
        if self._conn is None:
            self._conn = self._connect()
        try:
            self._conn.request("POST", self._path, body=body,
                               headers=headers)
            resp = self._conn.getresponse()
            resp.read()
            return resp.status
        except Exception:
            try:
                self._conn.close()
            except Exception:
                pass
            self._conn = None
            raise

    def deliver(self, cols: Columns, mask: np.ndarray) -> None:
        rows = np.nonzero(mask)[0]
        docs = [marshal_row(cols, int(r), self.identity) for r in rows]
        body = (self.transform(docs) if self.transform is not None
                else json.dumps(docs).encode("utf-8"))
        headers = {"Content-Type": "application/json", **self.headers}
        try:
            status = call_with_retry(
                lambda: self._post(body, headers), _RECONNECT_RETRY,
                retry_on=(Exception,),
                name=f"outbound.{self.connector_id}.post")
        except RetriesExhausted as e:
            logger.exception("%s POST %s failed", self.name, self._path)
            # raise so process_batch counts the error and the breaker
            # sees the dead sink (the manager isolates it from siblings)
            raise DeliveryFailed(
                f"POST {self._path} failed: {e.__cause__}") from e.__cause__
        # only 2xx is delivery: http.client does not follow redirects,
        # so a 3xx means the events never arrived — an answered error is
        # NOT retried (the reference webhook connectors likewise treat a
        # rejection as final)
        if not 200 <= status < 300:
            logger.error("%s POST %s rejected (%d)", self.name, self._path,
                         status)
            raise DeliveryFailed(f"webhook returned {status}")


class DeliveryFailed(Exception):
    """Webhook answered with an error status (no reconnect needed)."""


class MqttOutboundConnector(OutboundConnector):
    """Publish surviving events to MQTT topics via multicast routing.

    Reference: ``mqtt/MqttOutboundConnector.java`` with
    ``AllWithSpecificationMulticaster`` (route per matching device-type) and
    a route builder computing the topic.  ``multicaster`` maps an event dict
    → list of route strings; ``route_builder`` maps (route, event) → topic.
    """

    def __init__(
        self,
        connector_id: str,
        client,
        topic: str = "sitewhere/output",
        identity=None,
        multicaster: Optional[Callable[[dict], List[str]]] = None,
        route_builder: Optional[Callable[[str, dict], str]] = None,
        qos: int = 0,
        filters=None,
        **kw,
    ):
        super().__init__(connector_id, filters, **kw)
        self.client = client
        self.topic = topic
        self.identity = identity
        self.multicaster = multicaster
        self.route_builder = route_builder
        self.qos = qos

    def deliver(self, cols: Columns, mask: np.ndarray) -> None:
        rows = np.nonzero(mask)[0]
        for row in rows:
            doc = marshal_row(cols, int(row), self.identity)
            payload = json.dumps(doc).encode("utf-8")
            if self.multicaster is not None:
                routes = self.multicaster(doc)
            else:
                routes = [self.topic]
            for route in routes:
                topic = (
                    self.route_builder(route, doc)
                    if self.route_builder is not None
                    else route
                )
                try:
                    self.client.publish(topic, payload, qos=self.qos)
                except Exception:
                    with self._lock:
                        self.errors += 1
                    logger.exception("%s publish to %s failed", self.name, topic)


class IndexPushConnector(HttpConnector):
    """Push enriched events to an external search index in bulk.

    Reference: ``SolrOutboundConnector``
    (``service-outbound-connectors/.../solr/SolrOutboundConnector.java``)
    indexes every surviving event into an external Solr core — the
    write side of the federated-search story (the repo's own providers
    are query-side over its own store).  This is the batched variant of
    :class:`HttpConnector`:

    - events ACCUMULATE across pipeline batches and flush as ONE bulk
      request when ``bulk_rows`` is reached or ``bulk_interval_s``
      elapses (the Solr client's buffered-add semantics);
    - a failed bulk is RETAINED and retried with exponential backoff —
      backpressure is a bounded buffer (``max_buffer_rows``); beyond it
      the OLDEST docs drop and are counted (``dropped``), never the
      pipeline blocked;
    - the default wire shape is a JSON array POSTed to the URL
      (Solr ``/update`` accepts exactly that); ``bulk_format`` swaps in
      e.g. an Elasticsearch ``_bulk`` NDJSON builder.
    """

    def __init__(
        self,
        connector_id: str,
        url: str,
        identity=None,
        headers: Optional[Dict[str, str]] = None,
        bulk_rows: int = 500,
        bulk_interval_s: float = 1.0,
        max_buffer_rows: int = 50_000,
        backoff_s: float = 0.5,
        max_backoff_s: float = 30.0,
        bulk_format: Optional[Callable[[List[dict]], bytes]] = None,
        timeout_s: float = 10.0,
        filters=None,
        **kw,
    ):
        super().__init__(connector_id, url, identity=identity,
                         headers=headers, timeout_s=timeout_s,
                         filters=filters, **kw)
        self.bulk_rows = bulk_rows
        self.bulk_interval_s = bulk_interval_s
        self.max_buffer_rows = max_buffer_rows
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.bulk_format = bulk_format or (
            lambda docs: json.dumps(docs).encode("utf-8"))
        self._pending: List[dict] = []
        self._inflight: set = set()
        self._last_flush = time.monotonic()
        # failed-bulk retry schedule (was ad-hoc _retry_at/_cur_backoff)
        self._backoff = Backoff(
            RetryPolicy(initial_s=backoff_s, max_s=max_backoff_s),
            name=f"outbound.{connector_id}.bulk")
        self.indexed = 0
        self.dropped = 0
        # serializes whole flushes: the interval timer and a delivery
        # thread passing the due-check together must not post the same
        # docs twice (also guards _conn, which is not thread-safe)
        self._flush_lock = threading.Lock()
        self._timer: Optional[threading.Thread] = None
        self._timer_stop = threading.Event()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        super().start()
        self._timer_stop.clear()
        self._timer = threading.Thread(
            target=self._tick, name=f"{self.name}-flusher", daemon=True)
        self._timer.start()

    def stop(self) -> None:
        self._timer_stop.set()
        if self._timer is not None:
            self._timer.join(timeout=5)
            self._timer = None
        self._flush(force=True)  # best-effort final push
        super().stop()

    def _tick(self) -> None:
        while not self._timer_stop.wait(max(0.05, self.bulk_interval_s / 2)):
            try:
                self._flush()
            except Exception:
                logger.exception("%s interval flush failed", self.name)

    # -- delivery ------------------------------------------------------------

    def deliver(self, cols: Columns, mask: np.ndarray) -> None:
        rows = np.nonzero(mask)[0]
        docs = [marshal_row(cols, int(r), self.identity) for r in rows]
        with self._lock:
            self._pending.extend(docs)
            overflow = len(self._pending) - self.max_buffer_rows
            if overflow > 0:
                # drop OLDEST (the index is a derived view; newest data
                # wins when the sink cannot keep up) — but never a doc
                # an in-flight bulk is carrying: it is being indexed,
                # not dropped, and the post-send identity delete must
                # find it in place
                keep: List[dict] = []
                dropped = 0
                for d in self._pending:
                    if dropped < overflow and id(d) not in self._inflight:
                        dropped += 1
                        continue
                    keep.append(d)
                self._pending = keep
                self.dropped += dropped
        self._flush()

    def _flush(self, force: bool = False) -> None:
        with self._flush_lock:
            self._flush_locked(force)

    def _flush_locked(self, force: bool) -> None:
        now = time.monotonic()
        with self._lock:
            n = len(self._pending)
            due = force or n >= self.bulk_rows or (
                n > 0 and now - self._last_flush >= self.bulk_interval_s)
            if not due or n == 0 or (not force
                                     and not self._backoff.due(now)):
                return
            batch = self._pending[:]
            self._inflight = {id(d) for d in batch}
        ok = False
        try:
            body = self.bulk_format(batch)
            ok = self._post_bulk(body)
        finally:
            if ok:
                with self._lock:
                    # remove exactly the docs this flush sent, BY
                    # IDENTITY: deliveries that landed mid-request stay
                    # pending (a head-count delete would eat them)
                    sent = self._inflight
                    self._pending = [d for d in self._pending
                                     if id(d) not in sent]
                    self._inflight = set()
                    self.indexed += len(batch)
                    self._last_flush = now
                    self._backoff.reset()
            else:
                with self._lock:
                    self._inflight = set()
                    self.errors += 1
                    self._backoff.defer(now)

    def _post_bulk(self, body: bytes) -> bool:
        headers = {"Content-Type": "application/json", **self.headers}
        try:
            status = call_with_retry(
                lambda: self._post(body, headers), _RECONNECT_RETRY,
                retry_on=(Exception,),
                name=f"outbound.{self.connector_id}.bulk-post")
        except RetriesExhausted:
            logger.exception("%s bulk POST %s failed", self.name,
                             self._path)
            return False
        if not 200 <= status < 300:
            logger.error("%s bulk POST %s rejected (%d)",
                         self.name, self._path, status)
            return False
        return True
