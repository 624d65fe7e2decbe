"""Typed configuration tree with env overrides.

Counterpart of ``sitewhere_tpu/runtime/config.py``, whole: the same
keys, defaults and ``SW_TPU_<PATH>`` env overrides
(``SW_TPU_PIPELINE__WIDTH=65536`` -> ``pipeline.width``), so one config
file drives either package.  Load from JSON file(s), overlay per-tenant
fragments, and ``reload()`` to re-read and notify listeners.  The
port's :class:`~sitewhere_tpu_torch.instance.Instance` says which keys
it honours and refuses the others.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import threading
from typing import Any, Callable, Dict, List, Optional

ENV_PREFIX = "SW_TPU_"


def _coerce(value: str) -> Any:
    low = value.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    if value.startswith(("[", "{")):
        try:
            return json.loads(value)
        except ValueError:
            pass
    return value


DEFAULTS: Dict[str, Any] = {
    "instance": {"id": "sitewhere-tpu", "data_dir": "./data"},
    "pipeline": {
        "width": 65536,
        "registry_capacity": 1 << 20,
        "mtype_slots": 8,
        "deadline_ms": 5.0,
        "n_shards": 1,
        # overlapped host pipeline (README "Performance"): adaptive
        # emission window around deadline_ms, and egress fan-out on a
        # supervised offload worker instead of the dispatch thread.
        # egress_offload null = backend-adaptive: on for accelerator
        # backends (egress fetches release the GIL, overlap is real),
        # off on CPU (the GIL serializes the stages anyway)
        "adaptive_deadline": True,
        "egress_offload": None,
    },
    # decode worker pool: wire payloads decode off the receiver/dispatch
    # threads (per-source lanes keep delivery ordered); 0 = synchronous
    "ingest": {"decode_workers": 2, "decode_max_pending": 128},
    # prune_after_checkpoint reclaims journal segments below the
    # pipeline's committed offset after each snapshot (everything under
    # it is re-derivable from checkpoint + event store)
    "journal": {"fsync_every": 256, "segment_bytes": 64 << 20,
                "prune_after_checkpoint": False},
    # events.retention_s: event-time retention window for the columnar
    # store, enforced segment-at-a-time (0 = keep forever).  The
    # log-structured segment store (store/segmented.py): shards =
    # tenant/device shard count (parallel seal lanes), seal_workers =
    # background seal pool size, hot_bytes = packed-column hot-tier
    # budget, compact_interval_s = background compaction cadence
    # (<=0 disables).
    "events": {"retention_s": 0, "resident_bytes": 256 << 20,
               "shards": 4, "seal_workers": 2, "hot_bytes": 64 << 20,
               "compact_interval_s": 30.0},
    # overload control (runtime/overload.py): watermark-driven state
    # machine (NORMAL→DEGRADED→SHEDDING→EMERGENCY) over the exported
    # pressure signals, with priority-class admission at ingest and a
    # degradation ladder downstream.  "watermarks" overrides per-signal
    # [degraded, shedding, emergency] enter thresholds, e.g.
    # {"batcher_backlog": [1.0, 4.0, 16.0]}.  retry_after_s seeds the
    # 429 Retry-After / CoAP Max-Age hint (scaled by severity).
    "overload": {
        "enabled": True,
        "cooldown_s": 2.0,
        "hysteresis": 0.7,
        # a watermark must hold for confirm_samples consecutive samples
        # before escalation — one slow plan pinning a last-value gauge
        # is a spike, not sustained overload
        "confirm_samples": 2,
        "sample_interval_s": 0.1,
        "retry_after_s": 1.0,
        "degraded_telemetry_rate_per_s": 10_000.0,
        "degraded_telemetry_burst": 20_000.0,
        "watermarks": {},
    },
    # streaming analytics & CEP (analytics/): registered queries compile
    # once and run live (dispatcher egress) + retrospectively (event
    # store).  queue_depth bounds the live eval queue; max_matches the
    # per-query match ring; fanout_matches re-publishes matches through
    # the outbound connector path as STATE_CHANGE rows.
    "analytics": {
        "enabled": True,
        "max_queries": 32,
        "max_matches": 1024,
        "queue_depth": 64,
        "fanout_matches": True,
    },
    "presence": {"scan_interval_s": 600.0, "missing_after_s": 8 * 3600.0},
    "api": {"host": "127.0.0.1", "port": 8080, "jwt_ttl_s": 3600},
    "metrics": {"report_interval_s": 20.0},
    # cross-host fabric (sitewhere-grpc-client analog; rpc/ package).
    # "peers" lists every process's RPC endpoint in process-id order —
    # a 2+ entry list turns on keyed event forwarding, with this
    # process at index "process_id".  Multi-host REQUIRES a shared
    # security.jwt_secret (the reference shares its instance JWT secret
    # across microservices the same way).
    # heartbeat_interval_s drives the fleet health plane (rpc/health.py:
    # failure detection windows + probe pacing scale with it; <=0
    # disables the loop); call_timeout_s is the per-forward-call budget
    # propagated as the deadline-ms header so owners drop stale work.
    "rpc": {
        "server": {"enabled": False, "host": "127.0.0.1", "port": 0},
        "process_id": 0,
        "peers": [],
        "forward_deadline_ms": 25.0,
        "heartbeat_interval_s": 0.5,
        "call_timeout_s": 10.0,
    },
    "security": {"jwt_secret": None},
}


class Config:
    """Nested config with dotted-path access and env overrides."""

    def __init__(self, tree: Optional[Dict[str, Any]] = None,
                 apply_env: bool = True):
        self._tree = copy.deepcopy(DEFAULTS)
        if tree:
            _deep_merge(self._tree, tree)
        if apply_env:
            self._apply_env()
        self._listeners: List[Callable[["Config"], None]] = []
        self._lock = threading.Lock()
        self._sources: List[str] = []

    @classmethod
    def load(cls, *paths: str, apply_env: bool = True) -> "Config":
        tree: Dict[str, Any] = {}
        for path in paths:
            with open(path) as f:
                _deep_merge(tree, json.load(f))
        cfg = cls(tree, apply_env=apply_env)
        cfg._sources = list(paths)
        return cfg

    def _apply_env(self) -> None:
        for key, value in os.environ.items():
            if not key.startswith(ENV_PREFIX):
                continue
            path = key[len(ENV_PREFIX):].lower().split("__")
            node = self._tree
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = _coerce(value)

    # -- access -------------------------------------------------------------

    def set(self, dotted: str, value: Any) -> None:
        """In-process override at a dotted path (does NOT persist to the
        config file and does NOT fire change listeners — the runtime
        adopting state it already applied, e.g. a membership change)."""
        parts = dotted.split(".")
        node = self._tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def get(self, dotted: str, default: Any = None) -> Any:
        node: Any = self._tree
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def __getitem__(self, dotted: str) -> Any:
        value = self.get(dotted, _MISSING)
        if value is _MISSING:
            raise KeyError(dotted)
        return value

    def section(self, dotted: str) -> Dict[str, Any]:
        value = self.get(dotted, {})
        if not isinstance(value, dict):
            raise TypeError(f"{dotted} is not a section")
        return copy.deepcopy(value)

    def as_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._tree)

    # -- tenant overlays (per-tenant engine config analog) -------------------

    def for_tenant(self, overrides: Dict[str, Any]) -> "Config":
        merged = self.as_dict()
        _deep_merge(merged, overrides)
        return Config(merged, apply_env=False)

    # -- live reload ---------------------------------------------------------

    def on_change(self, listener: Callable[["Config"], None]) -> None:
        self._listeners.append(listener)

    def remove_listener(self, listener: Callable[["Config"], None]) -> None:
        """Deregister (components MUST call this on terminate — a Config
        can outlive the Instance built from it, and a stale listener
        would hold the whole object graph and act on a dead instance)."""
        try:
            self._listeners.remove(listener)
        except ValueError:
            pass

    def reload(self) -> None:
        """Re-read source files + env; notify listeners (dynamic restart
        analog, ``MultitenantMicroservice.java:342``)."""
        with self._lock:
            tree: Dict[str, Any] = {}
            for path in self._sources:
                with open(path) as f:
                    _deep_merge(tree, json.load(f))
            self._tree = copy.deepcopy(DEFAULTS)
            _deep_merge(self._tree, tree)
            self._apply_env()
        # snapshot: listeners may deregister concurrently (terminate),
        # and one raising listener must not starve the rest
        for listener in list(self._listeners):
            try:
                listener(self)
            except Exception:   # noqa: BLE001
                logging.getLogger("sitewhere_tpu_torch.config").exception(
                    "config listener %r failed", listener)


class _Missing:
    pass


_MISSING = _Missing()


def _deep_merge(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for key, value in src.items():
        if isinstance(value, dict) and isinstance(dst.get(key), dict):
            _deep_merge(dst[key], value)
        else:
            dst[key] = copy.deepcopy(value)
