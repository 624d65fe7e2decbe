"""Always-on flight recorder: the last N batches, dumped on anomaly.

Counterpart of ``sitewhere_tpu/runtime/flightrec.py``, copied with the
imports renamed: the port's dispatcher and ``Instance`` feed it.

Coarse metrics tell an operator THAT the pipeline misbehaved; they
cannot say what the last two thousand batches were doing when it did.
The flight recorder is the black box between the two: a bounded,
lock-light ring of structured per-batch records the dispatcher appends
to on every egress (sequence number, ring slot, per-host-stage
timings, overload state, trace id, commit outcome), snapshotted to a
JSONL file when an anomaly fires —

- an SLO burn-rate alert (``runtime/metrics.py BurnRateEngine``),
- an egress-worker crash / supervisor restart,
- an overload state transition,
- an operator's explicit request (REST).

Snapshots are rate-limited (an anomaly storm produces one dump per
``min_snapshot_interval_s``, not one per batch) and pruned to
``max_snapshots`` so the recorder can run forever.  ``record`` is a
dict build + deque append under a lock, which is what "always-on"
requires.

Reference framing: the reference's microservices log per-record
processing at DEBUG and rely on Kafka retention as the replay record;
here the journal owns replay and the flight recorder owns *forensics*
— the structured "what was each batch doing" trail that coarse
chain-granularity latency cannot attribute (PAPERS.md 1807.07724: the
dominant costs hide in stages end-to-end numbers can't see).
"""

from __future__ import annotations

import collections
import json
import logging
import os
import re
import threading
import time
from typing import Dict, List, Optional

logger = logging.getLogger("sitewhere_tpu_torch.flightrec")

from sitewhere_tpu_torch.analysis.markers import hot_path  # noqa: E402

_REASON_RE = re.compile(r"[^a-z0-9_-]")


def _safe_reason(reason: str) -> str:
    """Reason → filename fragment (anomaly reasons embed operator/config
    strings; they must never mint a path)."""
    out = _REASON_RE.sub("-", str(reason).lower())[:48]
    return out or "anomaly"


class FlightRecorder:
    """Bounded per-batch record ring with anomaly-triggered snapshots.

    - ``capacity``: records retained in memory (the forensic window).
    - ``data_dir``: where snapshots land (``<data_dir>/flightrec/``);
      None keeps the recorder memory-only (snapshots disabled — the
      bench/overhead harness form).
    - ``min_snapshot_interval_s``: anomaly-dump rate limit, PER REASON —
      the first anomaly of an episode dumps and the storm that follows
      increments counters only, but an egress crash is never suppressed
      because an unrelated overload transition dumped moments earlier.
      Explicit :meth:`snapshot` calls bypass it.
    - ``max_snapshots``: oldest snapshot files pruned beyond this
      (``<= 0`` disables pruning — unlimited retention).

    Thread-safe; ``record`` is the only hot-path entry and does no I/O.
    """

    def __init__(self, data_dir: Optional[str] = None,
                 capacity: int = 2048,
                 min_snapshot_interval_s: float = 5.0,
                 max_snapshots: int = 32,
                 metrics=None,
                 clock=time.monotonic):
        self.capacity = int(capacity)
        self.min_snapshot_interval_s = float(min_snapshot_interval_s)
        self.max_snapshots = int(max_snapshots)
        self._clock = clock
        self._records: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._snap_lock = threading.Lock()
        # per-reason rate-limit stamps (reasons are code-authored and
        # enum-bounded; the cap guards a pathological caller)
        self._last_by_reason: Dict[str, float] = {}
        self._snap_seq = 0
        self.dir = None
        if data_dir is not None:
            self.dir = os.path.join(os.path.abspath(data_dir), "flightrec")
            os.makedirs(self.dir, exist_ok=True)
            # resume the file sequence so a restart never overwrites a
            # prior crash's evidence
            for name in os.listdir(self.dir):
                try:
                    self._snap_seq = max(self._snap_seq,
                                         int(name.split("-", 1)[0]) + 1)
                except (ValueError, IndexError):
                    continue
        if metrics is None:
            from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry

            metrics = MetricsRegistry()
        self._m_records = metrics.counter("flightrec.records")
        self._m_anomalies = metrics.counter("flightrec.anomalies")
        self._m_snapshots = metrics.counter("flightrec.snapshots")
        self._m_suppressed = metrics.counter("flightrec.suppressed_dumps")

    # -- hot path ------------------------------------------------------------

    @hot_path
    def record(self, **fields) -> None:
        """Append one per-batch record (O(1), no I/O — always-on)."""
        fields["ts"] = round(time.time(), 6)
        with self._lock:
            self._records.append(fields)
        self._m_records.inc()

    # -- anomaly / snapshot --------------------------------------------------

    def anomaly(self, reason: str, detail: Optional[str] = None
                ) -> Optional[str]:
        """One anomaly observed: count it, and dump the ring unless a
        dump FOR THIS REASON landed within the rate-limit window (a
        crash must never lose its evidence because an unrelated
        transition dumped first).  Returns the snapshot path (None when
        suppressed or snapshots are disabled)."""
        self._m_anomalies.inc()
        now = self._clock()
        key = _safe_reason(reason)
        with self._snap_lock:
            last = self._last_by_reason.get(key, float("-inf"))
            if now - last < self.min_snapshot_interval_s:
                self._m_suppressed.inc()
                return None
            if len(self._last_by_reason) >= 64:
                self._last_by_reason.clear()
            self._last_by_reason[key] = now
        path = self.snapshot(reason, detail)
        if path is None and self.dir is not None:
            # the write FAILED (disk full, permissions): give the slot
            # back, or one bad write would suppress the whole episode's
            # evidence while later dumps might succeed
            with self._snap_lock:
                self._last_by_reason.pop(key, None)
        return path

    def snapshot(self, reason: str = "manual",
                 detail: Optional[str] = None) -> Optional[str]:
        """Dump the current ring to a JSONL file: one header line
        (kind/reason/ts/detail/record count) then one record per line.
        Explicit calls are never rate-limited.  Returns the path, or
        None when the recorder is memory-only."""
        if self.dir is None:
            return None
        with self._lock:
            records = list(self._records)
        with self._snap_lock:
            seq = self._snap_seq
            self._snap_seq += 1
        name = f"{seq:06d}-{_safe_reason(reason)}.jsonl"
        path = os.path.join(self.dir, name)
        header = {"kind": "flightrec-snapshot", "reason": str(reason),
                  "ts": round(time.time(), 6), "records": len(records)}
        if detail:
            header["detail"] = str(detail)[:512]
        try:
            with open(path, "w") as f:
                f.write(json.dumps(header) + "\n")
                for rec in records:
                    f.write(json.dumps(rec, default=str) + "\n")
        except OSError:
            logger.exception("flight-recorder snapshot %s failed", name)
            return None
        self._m_snapshots.inc()
        logger.warning("flight recorder dumped %d records to %s (%s)",
                       len(records), name, reason)
        self._prune()
        return path

    def _prune(self) -> None:
        if self.max_snapshots <= 0:
            return   # <= 0 means unlimited retention, never "delete all"
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if n.endswith(".jsonl"))
            for name in names[:-self.max_snapshots]:
                os.unlink(os.path.join(self.dir, name))
        except OSError:
            logger.debug("snapshot prune failed", exc_info=True)

    # -- read side -----------------------------------------------------------

    def recent(self, limit: int = 100) -> List[dict]:
        limit = max(0, int(limit))
        if limit == 0:
            return []   # records[-0:] would be the WHOLE ring
        with self._lock:
            records = list(self._records)
        return records[-limit:]

    def snapshots(self) -> List[Dict[str, object]]:
        """Snapshot inventory, oldest first (name + header fields)."""
        if self.dir is None:
            return []
        out: List[Dict[str, object]] = []
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if n.endswith(".jsonl"))
        except OSError:
            return []
        for name in names:
            entry: Dict[str, object] = {"name": name}
            try:
                with open(os.path.join(self.dir, name)) as f:
                    entry.update(json.loads(f.readline()))
            except (OSError, ValueError):
                entry["corrupt"] = True
            out.append(entry)
        return out

    def read_snapshot(self, name: str) -> bytes:
        """Raw JSONL bytes of one snapshot (REST download surface).
        Raises ``KeyError`` for unknown/invalid names — the name must be
        exactly one the inventory listed (no path components)."""
        if self.dir is None or os.path.basename(name) != name \
                or not name.endswith(".jsonl"):
            raise KeyError(name)
        path = os.path.join(self.dir, name)
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError:
            raise KeyError(name)

    def stats(self) -> dict:
        with self._lock:
            buffered = len(self._records)
        return {
            "records_buffered": buffered,
            "capacity": self.capacity,
            "records_total": int(self._m_records.value),
            "anomalies": int(self._m_anomalies.value),
            "snapshots_written": int(self._m_snapshots.value),
            "suppressed_dumps": int(self._m_suppressed.value),
            "snapshot_dir": self.dir,
        }


def parse_snapshot(data: bytes) -> Dict[str, object]:
    """Parse one snapshot's JSONL back into ``{"header": ...,
    "records": [...]}`` — the scrape-side validator the smoke tooling
    and the timeline renderer share.  Raises ``ValueError`` on a
    malformed header/record or a record-count mismatch (it VALIDATES,
    it doesn't best-effort skip)."""
    lines = data.decode("utf-8").splitlines()
    if not lines:
        raise ValueError("empty snapshot")
    header = json.loads(lines[0])
    if header.get("kind") != "flightrec-snapshot":
        raise ValueError(f"not a flight-recorder snapshot: {header!r}")
    records = [json.loads(line) for line in lines[1:] if line]
    if len(records) != int(header.get("records", -1)):
        raise ValueError(
            f"record count mismatch: header says {header.get('records')}, "
            f"file holds {len(records)}")
    return {"header": header, "records": records}


__all__ = ["FlightRecorder", "parse_snapshot"]
