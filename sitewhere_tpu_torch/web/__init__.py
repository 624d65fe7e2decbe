"""Web surface: REST gateway + JWT auth + topology WebSocket feed.

TPU-new implementation of the reference ``service-web-rest`` (controllers,
JWT filter, Swagger-era REST shapes, STOMP topology broadcast).

Counterpart of ``sitewhere_tpu/web/__init__.py``, whole, over the port
``Instance``.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import List, Optional

from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.web.controllers import register_routes
from sitewhere_tpu_torch.web.http import RawResponse, Request, RestGateway, jsonable

logger = logging.getLogger("sitewhere_tpu_torch.web")


class TopologyBroadcaster:
    """Push topology snapshots to connected WebSocket admin clients.

    Reference: ``web/ws/components/TopologyBroadcaster.java`` — live
    microservice/tenant-engine state from ``TopologyStateAggregator``
    pushed over STOMP; here plain JSON frames on ``/ws/topology``.
    """

    def __init__(self, inst, interval_s: float = 5.0):
        self.inst = inst
        self.interval_s = interval_s
        self._clients: List[object] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def attach(self, ws) -> None:
        """WS route handler: greet with a snapshot, then keep the socket
        until the client drops (runs on the connection thread)."""
        ws.send_text(json.dumps(jsonable(self.inst.topology())))
        with self._lock:
            self._clients.append(ws)
        try:
            while ws.recv() is not None:
                pass  # client messages are ignored (feed is one-way)
        except (ConnectionError, OSError):
            pass
        finally:
            with self._lock:
                if ws in self._clients:
                    self._clients.remove(ws)

    def broadcast(self) -> int:
        payload = json.dumps(jsonable(self.inst.topology()))
        with self._lock:
            clients = list(self._clients)
        sent = 0
        for ws in clients:
            try:
                ws.send_text(payload)
                sent += 1
            except (ConnectionError, OSError):
                with self._lock:
                    if ws in self._clients:
                        self._clients.remove(ws)
        return sent

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="topology-broadcaster", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.broadcast()
            except Exception:
                logger.exception("topology broadcast failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


class WebServer(LifecycleComponent):
    """The assembled web surface over one Instance."""

    def __init__(self, inst, host: str = "127.0.0.1", port: int = 0,
                 topology_interval_s: float = 5.0):
        super().__init__("web-rest")
        self.inst = inst
        self.gateway = RestGateway(host, port, token_management=inst.tokens)
        register_routes(self.gateway, inst)
        self.topology = TopologyBroadcaster(inst, topology_interval_s)
        self.gateway.add_ws("/ws/topology", self.topology.attach)

    @property
    def port(self) -> int:
        return self.gateway.port

    def start(self) -> None:
        super().start()
        self.gateway.start()
        self.topology.start()

    def stop(self) -> None:
        self.topology.stop()
        self.gateway.stop()
        super().stop()


__all__ = [
    "RawResponse",
    "Request",
    "RestGateway",
    "TopologyBroadcaster",
    "WebServer",
    "register_routes",
]
