"""Batch analytics over event history, and the streaming query runner.

Counterpart of ``sitewhere_tpu/analytics/runner.py`` on one card, without
its sharded half (``detect_anomalies_window_sharded``,
``build_window_grid_sharded``, ``route_events_by_shard`` and their mesh
functions wait for the multi-device slice).

- :func:`build_window_grid` and :func:`detect_anomalies`: per-(device,
  window) statistics of stored measurements and the windows deviating
  from their trailing per-device baseline; :class:`AnalyticsJob` runs
  them over an event store.  Float sums are segmented reductions over
  rows sorted by cell (:mod:`.windows`), deterministic on the card.
- :class:`QueryRunner`: registered Window/Session/Pattern queries
  evaluated live on the dispatcher's accepted batches (a bounded
  non-blocking offer onto the runner's own worker thread) and
  retrospectively over the sealed event store with fresh state.

Streams and threads (the rule engine's design, ``rules/engine.py``):

- the worker launches on the card while the dispatcher steps, so the
  runner has its own CUDA stream, and every tensor it owns (operator
  state, staged batches, a flush's outputs) is made and used on it;
- a batch is staged on the card once for all queries, and each query
  ends the batch with one host copy (:class:`~.query.CompiledQuery`);
- in torch the current stream is per thread, and nothing the worker
  calls while on its stream reaches back into the dispatcher: match
  fan-out goes to ``outbound``, after the worker has left its stream.

The ``Instance`` wires ``outbound`` (match fan-out as STATE_CHANGE
rows, ``fanout_matches``), ``overload`` (shed from SHEDDING as a
non-priority consumer), ``usage_ledger`` (eval seconds billed by row
share) and ``quotas`` (the metered-quota row gate, pure host work).
:class:`EventTap` accumulates enriched batches from an outbound
callback connector for the batch job.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sitewhere_tpu_torch.analytics import checkpoint as _ckpt
from sitewhere_tpu_torch.analytics.query import (
    WindowQuery,
    compile_query,
    describe_query,
    parse_query,
    stage_columns,
)
from sitewhere_tpu_torch.analytics.windows import f32, segment_sum, sqrt_rn
from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.ids import NULL_ID
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import (
    MetricsRegistry,
    sanitize_metric_name,
)
from sitewhere_tpu_torch.runtime.tracing import _NOOP_TRACE
from sitewhere_tpu_torch.schema import EventType
from sitewhere_tpu_torch.services.common import EntityNotFound, ValidationError

_LOG = logging.getLogger("sitewhere_tpu_torch.analytics")


@dataclasses.dataclass
class WindowGrid:
    """Dense per-(device, window) measurement statistics."""

    counts: torch.Tensor     # int32[D, W]
    means: torch.Tensor      # float32[D, W] (0 where empty)
    variances: torch.Tensor  # float32[D, W]

    @property
    def n_devices(self) -> int:
        return self.counts.shape[0]

    @property
    def n_windows(self) -> int:
        return self.counts.shape[1]


def build_window_grid(device_id: torch.Tensor, window_idx: torch.Tensor,
                      value: torch.Tensor, valid: torch.Tensor,
                      n_devices: int, n_windows: int) -> WindowGrid:
    """N events into the [D, W] stats grid; the variance is two-pass (each
    event's residual from its window mean), which avoids the float32
    cancellation of ``sumsq/n - mean^2``."""
    cells = n_devices * n_windows
    in_range = (valid & (device_id >= 0) & (device_id < n_devices)
                & (window_idx >= 0) & (window_idx < n_windows))
    flat = torch.where(in_range, device_id.to(torch.int64) * n_windows
                       + window_idx.to(torch.int64), cells)
    order = torch.argsort(flat, stable=True)
    lengths = torch.bincount(flat, minlength=cells + 1)
    sums = segment_sum(torch.where(in_range, value, 0.0)[order], lengths)
    counts = lengths[:cells].to(torch.int32)
    safe = torch.clamp(counts, min=1).to(torch.float32)
    means_flat = sums[:cells] / safe
    event_mean = torch.cat([means_flat, means_flat.new_zeros(1)])[flat]
    resid = torch.where(in_range, value - event_mean, 0.0)
    m2 = segment_sum((resid * resid)[order], lengths)
    shape = (n_devices, n_windows)
    return WindowGrid(counts=counts.reshape(shape),
                      means=means_flat.reshape(shape),
                      variances=(m2[:cells] / safe).reshape(shape))


def detect_anomalies(grid: WindowGrid, baseline_windows: int = 8,
                     z_threshold: float = 3.0, min_baseline_count: int = 8,
                     std_floor: float = 1e-3):
    """Flag windows deviating from their trailing per-device baseline
    (windows [w-L, w), from shifted cumulative sums).  Returns
    ``(anomalous bool[D, W], z_scores float32[D, W])``."""
    counts = grid.counts.to(torch.float32)
    sums = grid.means * counts
    m2 = grid.variances * counts
    b = int(baseline_windows)

    def trailing(x):
        c = torch.cumsum(x, dim=1)
        lagged = F.pad(c, (b, 0))[:, :-b]
        prev = F.pad(c, (1, 0))[:, :-1]
        prev_lagged = F.pad(lagged, (1, 0))[:, :-1]
        return prev - prev_lagged

    return _flag_from_trailing(
        counts, grid.means, grid.variances,
        trailing(counts), trailing(sums),
        trailing(counts * grid.means * grid.means), trailing(m2),
        z_threshold, min_baseline_count, std_floor)


def _flag_from_trailing(counts, means, variances, base_n, base_sum,
                        base_msq, base_m2, z_threshold, min_baseline_count,
                        std_floor):
    """z-scores given the four trailing-baseline sums."""
    safe_n = torch.clamp(base_n, min=1.0)
    base_mean = base_sum / safe_n
    # total variance = within-window residuals + between-window spread
    between = base_msq - base_n * base_mean * base_mean
    base_var = torch.clamp((base_m2 + between) / safe_n, min=0.0)
    # Welch-style: the candidate window's own spread counts too
    base_std = torch.maximum(sqrt_rn(base_var + variances),
                             f32(float(std_floor), counts.device))
    z = (means - base_mean) / base_std
    ready = (base_n >= min_baseline_count) & (counts > 0)
    anomalous = ready & (torch.abs(z) > z_threshold)
    return anomalous, torch.where(ready, z, 0.0)


@dataclasses.dataclass
class Anomaly:
    device_id: int
    device_token: Optional[str]
    window: int
    window_start_s: int
    z_score: float
    mean: float
    count: int


class AnalyticsJob:
    """One batch analytics run over stored event history: the host
    slices the store (measurements of one ``mtype``), computes window
    indices and centers the values in float64, and the grid and anomaly
    passes run on ``device`` (the card unless named)."""

    def __init__(self, window_s: int = 3600, baseline_windows: int = 8,
                 z_threshold: float = 3.0, min_baseline_count: int = 8,
                 min_std: float = 1e-3, min_std_fraction: float = 0.05,
                 device: DeviceLike = None):
        self.window_s = window_s
        self.baseline_windows = baseline_windows
        self.z_threshold = z_threshold
        self.min_baseline_count = min_baseline_count
        # baseline-std floor: max(min_std, min_std_fraction * global std)
        self.min_std = min_std
        self.min_std_fraction = min_std_fraction
        self.device = resolve_device(device)

    def columns_from_store(self, store, mtype_id: Optional[int] = None
                           ) -> Dict[str, np.ndarray]:
        """Measurement columns out of an event store (host-side gather)."""
        device_id: List[np.ndarray] = []
        ts_s: List[np.ndarray] = []
        value: List[np.ndarray] = []
        for cols in store.iter_chunks():
            mask = cols["event_type"] == int(EventType.MEASUREMENT)
            if mtype_id is not None:
                mask &= cols["mtype_id"] == mtype_id
            device_id.append(cols["device_id"][mask])
            ts_s.append(cols["ts_s"][mask])
            value.append(cols["value"][mask])
        if not device_id:
            return {"device_id": np.zeros(0, np.int32),
                    "ts_s": np.zeros(0, np.int32),
                    "value": np.zeros(0, np.float32)}
        return {"device_id": np.concatenate(device_id),
                "ts_s": np.concatenate(ts_s),
                "value": np.concatenate(value)}

    def run_columns(self, device_id: np.ndarray, ts_s: np.ndarray,
                    value: np.ndarray, n_devices: int,
                    t0_s: Optional[int] = None,
                    n_windows: Optional[int] = None,
                    token_of=None) -> Dict[str, object]:
        if len(ts_s) == 0:
            return {"anomalies": [], "windows": 0, "events": 0,
                    "devices_seen": 0}
        t0 = int(ts_s.min()) if t0_s is None else t0_s
        win = ((ts_s.astype(np.int64) - t0) // self.window_s).astype(np.int32)
        if n_windows is None:
            # a multiple of 64, as the reference buckets it
            n_windows = (int(win.max()) // 64 + 1) * 64
        values64 = value.astype(np.float64)
        center = float(values64.mean())
        global_std = float(values64.std())
        centered = (values64 - center).astype(np.float32)
        dev = self.device
        grid = build_window_grid(
            torch.from_numpy(device_id.astype(np.int32)).to(dev),
            torch.from_numpy(win).to(dev),
            torch.from_numpy(centered).to(dev),
            torch.ones(len(ts_s), dtype=torch.bool, device=dev),
            n_devices=n_devices, n_windows=n_windows)
        anomalous, z = detect_anomalies(
            grid, baseline_windows=self.baseline_windows,
            z_threshold=self.z_threshold,
            min_baseline_count=self.min_baseline_count,
            std_floor=float(np.float32(max(
                self.min_std, self.min_std_fraction * global_std))))
        host_anom = anomalous.cpu().numpy()
        host_z = z.cpu().numpy()
        host_means = grid.means.cpu().numpy()
        host_counts = grid.counts.cpu().numpy()
        anomalies = [
            Anomaly(device_id=int(d),
                    device_token=token_of(int(d)) if token_of else None,
                    window=int(w),
                    window_start_s=t0 + int(w) * self.window_s,
                    z_score=float(host_z[d, w]),
                    mean=float(host_means[d, w]) + center,
                    count=int(host_counts[d, w]))
            for d, w in zip(*np.nonzero(host_anom))]
        return {"anomalies": anomalies, "windows": int(n_windows),
                "events": int(len(ts_s)),
                "devices_seen": int((host_counts.sum(axis=1) > 0).sum())}

    def run(self, store, n_devices: int, mtype_id: Optional[int] = None,
            token_of=None) -> Dict[str, object]:
        """Full job: store -> columns -> windowed anomaly detection."""
        cols = self.columns_from_store(store, mtype_id)
        return self.run_columns(cols["device_id"], cols["ts_s"],
                                cols["value"], n_devices=n_devices,
                                token_of=token_of)


class _LiveQuery:
    """One registered query: spec + compiled live operator + stats."""

    __slots__ = ("spec", "compiled", "matches", "live_matches",
                 "retro_runs", "created_s", "timer", "retro_timer",
                 "counter")

    def __init__(self, spec, compiled, max_matches: int, timer,
                 retro_timer, counter):
        self.spec = spec
        self.compiled = compiled
        self.matches: "collections.deque" = collections.deque(
            maxlen=max_matches)
        self.live_matches = 0
        self.retro_runs = 0
        self.created_s = int(time.time())
        self.timer = timer              # live per-batch eval
        self.retro_timer = retro_timer  # whole-scan retrospective runs
        self.counter = counter


def _new_stream(device: torch.device):
    """The runner's own stream on a card; None on the CPU."""
    if device.type == "cuda":
        return torch.cuda.Stream(device=device)
    return None


class QueryRunner(LifecycleComponent):
    """Registered streaming queries: live evaluation + retrospective runs.

    The dispatcher's egress hands every accepted enriched batch to
    :meth:`submit_live` with its committed journal offset;
    :meth:`run_retrospective` streams the same compiled operator over the
    sealed event store with fresh state: identical matches on identical
    data.

    Crash recovery (the reference's offset contract): ``applied_upto`` is
    the committed journal offset stamped on the latest evaluated batch,
    below which every record has fully evaluated; ``_applied_partial``
    counts the applied rows of each record at or above it (the batcher
    may split one record across plans).  A snapshot stores both; a
    restore sets ``replay_floor`` and ``_replay_partial``, and
    :meth:`submit_live` drops the replayed rows already inside the
    restored state, row-exactly (``analytics.replay_rows_skipped``).
    """

    _LIVE_COLS = ("device_id", "ts_s", "event_type", "mtype_id", "value",
                  "payload_ref")

    def __init__(self, capacity: int, resolve_mtype=None, event_store=None,
                 outbound=None, overload=None, metrics=None, tracer=None,
                 max_queries: int = 32, max_matches: int = 1024,
                 queue_depth: int = 64, fanout_matches: bool = True,
                 name: str = "analytics-queries",
                 device: DeviceLike = None):
        super().__init__(name)
        self.device = resolve_device(device)
        self.capacity = int(capacity)
        self.resolve_mtype = resolve_mtype
        self.event_store = event_store
        self.outbound = outbound
        self.overload = overload
        self.tracer = tracer
        self.max_queries = int(max_queries)
        self.max_matches = int(max_matches)
        self.fanout_matches = bool(fanout_matches)
        if metrics is None:
            metrics = MetricsRegistry()
        self.metrics = metrics
        self._stream = _new_stream(self.device)
        self._m_queries = metrics.gauge("analytics.queries")
        self._m_batches = metrics.counter("analytics.live_batches")
        self._m_dropped = metrics.counter("analytics.live_dropped")
        self._m_shed = metrics.counter("analytics.live_shed")
        self._m_retro_rows = metrics.counter("analytics.retro_rows")
        self._m_retro_runs = metrics.counter("analytics.retro_runs")
        self._m_occupancy = metrics.gauge("analytics.window_occupancy")
        self._m_replay_skipped = metrics.counter(
            "analytics.replay_rows_skipped")
        self.applied_upto: Optional[int] = None
        self.replay_floor = 0
        self._applied_partial: Dict[int, int] = {}
        self._replay_partial: Dict[int, int] = {}
        self._lock = threading.RLock()
        # serializes mutation of compiled live state: the worker's eval
        # against flush_live and checkpoint snapshots/restores
        self._eval_mutex = threading.Lock()
        self._queries: Dict[str, _LiveQuery] = {}
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # metering hooks (instance-wired): None without the ledger
        self.usage_ledger = None
        self.quotas = None

    def _on_stream(self):
        """The runner's stream as the current one (nothing on the CPU)."""
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            self._stream.synchronize()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        super().start()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._worker, name=f"{self.name}-eval", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        # drain BEFORE signalling: the dispatcher (stopped first) has just
        # offered its final accepted batches
        if self._thread is not None:
            self.drain(timeout_s=5.0)
        self._stop.set()
        if self._thread is not None:
            try:
                self._q.put_nowait(None)
            except queue.Full:
                pass
            self._thread.join(timeout=5)
            self._thread = None
        super().stop()

    # -- registry -----------------------------------------------------------

    def _compile(self, spec):
        """Compile on the runner's stream; the state is complete when this
        returns, so the worker may read it on that stream."""
        with self._on_stream():
            compiled = compile_query(spec, self.capacity,
                                     resolve_mtype=self.resolve_mtype,
                                     device=self.device)
            self._sync()
        return compiled

    def register(self, doc: Dict[str, object]) -> Dict[str, object]:
        """Register (or replace) a query from its REST doc; compiles the
        operator at once, so a bad spec fails here, not on a batch."""
        try:
            spec = parse_query(doc, resolve_mtype=self.resolve_mtype)
            compiled = self._compile(spec)
        except ValueError as e:
            raise ValidationError(str(e)) from e
        entry = self._make_entry(spec, compiled)
        with self._lock:
            # distinct names must not share metric instruments through
            # name sanitization ("temp high" vs "temp-high")
            for other in self._queries.values():
                if other.spec.name != spec.name \
                        and other.counter is entry.counter:
                    raise ValidationError(
                        f"query name {spec.name!r} collides with "
                        f"{other.spec.name!r} after metric-name "
                        "sanitization; pick a distinct name")
            if (spec.name not in self._queries
                    and len(self._queries) >= self.max_queries):
                raise ValidationError(
                    f"query limit {self.max_queries} reached")
            self._queries[spec.name] = entry
            self._m_queries.set(len(self._queries))
        return self.describe(spec.name)

    def _make_entry(self, spec, compiled) -> _LiveQuery:
        tag = sanitize_metric_name(f"analytics.q.{spec.name}").split(
            ".", 2)[-1]
        return _LiveQuery(
            spec, compiled, self.max_matches,
            timer=self.metrics.timer(f"analytics.eval_s.{tag}"),
            retro_timer=self.metrics.timer(f"analytics.retro_s.{tag}"),
            counter=self.metrics.counter(f"analytics.matches.{tag}"))

    # -- checkpoint integration (runtime/checkpoint.py StateProvider) -------

    def snapshot_state(self):
        """Checkpoint payload (the reference's layout): every registered
        spec, its doc and its operator state, plus the journal offset the
        state is consistent as of and the partially applied records.
        Drains the queue first (bounded)."""
        self.drain(timeout_s=2.0)
        with self._eval_mutex, self._on_stream():
            with self._lock:
                entries = [self._queries[n] for n in sorted(self._queries)]
            queries = [{
                "spec": e.spec,
                "doc": describe_query(e.spec),
                "state_version": int(e.compiled.STATE_VERSION),
                "arrays": e.compiled.export_state(),
            } for e in entries]
            as_of = self.applied_upto
            partial = dict(self._applied_partial)
        return (_ckpt.dumps({"queries": queries, "partial": partial}),
                {"as_of": as_of, "queries": len(queries)})

    def restore_state(self, header, payload) -> int:
        """Re-register every snapshotted query and adopt its operator
        state; a query whose state no longer fits re-registers with fresh
        state (logged).  Returns the number of queries restored."""
        doc = _ckpt.loads(payload)
        restored = 0
        for q in doc.get("queries", []):
            spec = q.get("spec")
            try:
                compiled = self._compile(spec)
            except Exception:
                _LOG.exception("restored query %s no longer compiles; "
                               "dropped", getattr(spec, "name", "?"))
                continue
            if int(q.get("state_version", 1)) != compiled.STATE_VERSION:
                _LOG.warning("query %s snapshot state version %s != %s; "
                             "state reset (open windows lost)", spec.name,
                             q.get("state_version"), compiled.STATE_VERSION)
            else:
                with self._on_stream():
                    adopted = compiled.import_state(q.get("arrays") or {})
                    self._sync()
                if not adopted:
                    _LOG.warning("query %s operator shape changed since "
                                 "the snapshot; state reset (open windows "
                                 "lost)", spec.name)
            entry = self._make_entry(spec, compiled)
            with self._lock:
                self._queries[spec.name] = entry
                self._m_queries.set(len(self._queries))
            restored += 1
        as_of = (header or {}).get("as_of")
        if as_of is not None:
            self.replay_floor = int(as_of)
            self.applied_upto = int(as_of)
        partial = {int(k): int(v)
                   for k, v in (doc.get("partial") or {}).items()}
        self._replay_partial = dict(partial)
        self._applied_partial = dict(partial)
        return restored

    def describe(self, name: str) -> Dict[str, object]:
        with self._lock:
            entry = self._queries.get(name)
        if entry is None:
            raise EntityNotFound(f"no query {name!r}")
        return {"query": describe_query(entry.spec),
                "liveMatches": entry.live_matches,
                "retrospectiveRuns": entry.retro_runs,
                "created_s": entry.created_s}

    def list_queries(self) -> List[Dict[str, object]]:
        with self._lock:
            entries = [self._queries[n] for n in sorted(self._queries)]
            return [{"query": describe_query(e.spec),
                     "liveMatches": e.live_matches,
                     "retrospectiveRuns": e.retro_runs,
                     "created_s": e.created_s} for e in entries]

    def remove(self, name: str) -> Dict[str, object]:
        """Deregister a query (its metric instruments stay)."""
        with self._lock:
            entry = self._queries.pop(name, None)
            self._m_queries.set(len(self._queries))
        if entry is None:
            raise EntityNotFound(f"no query {name!r}")
        return {"removed": name}

    def recent_matches(self, name: str,
                       limit: int = 100) -> List[Dict[str, object]]:
        with self._lock:
            entry = self._queries.get(name)
            if entry is None:
                raise EntityNotFound(f"no query {name!r}")
            out = list(entry.matches)[-max(1, int(limit)):]
        return [m.to_dict() for m in out]

    # -- live mode ----------------------------------------------------------

    def submit_live(self, cols, mask: np.ndarray, trace=None,
                    committed: Optional[int] = None) -> None:
        """Offer one accepted enriched batch (non-blocking; called from
        dispatcher egress with its committed journal offset).  Sheds from
        SHEDDING up; drops (counted) when the eval queue is full; drops
        replayed rows already inside restored state, row-exactly."""
        with self._lock:
            if not self._queries:
                return
        if self.overload is not None \
                and not self.overload.allow_fanout(priority=False):
            self._m_shed.inc()
            return
        mask = np.asarray(mask)
        # the five event columns stay mandatory; payload_ref is made up
        # for synthetic batches
        batch = {k: np.asarray(cols[k])[mask] for k in self._LIVE_COLS
                 if k != "payload_ref"}
        if self.usage_ledger is not None and "tenant_id" in cols:
            batch["tenant_id"] = np.asarray(cols["tenant_id"])[mask]
        if "payload_ref" in cols:
            batch["payload_ref"] = np.asarray(cols["payload_ref"])[mask]
        else:
            batch["payload_ref"] = np.full(
                len(batch["device_id"]), NULL_ID, np.int32)
        refs = batch["payload_ref"]
        journaled = refs != NULL_ID
        stale = np.zeros(len(refs), bool)
        if self.replay_floor > 0:
            stale |= journaled & (refs < self.replay_floor)
        if self._replay_partial:
            # drop the first `remaining` re-offered rows of each partially
            # applied record (they replay in the order they applied in)
            for ref in np.unique(refs[journaled & ~stale]):
                remaining = self._replay_partial.get(int(ref))
                if not remaining:
                    continue
                idx = np.nonzero(refs == ref)[0][:remaining]
                stale[idx] = True
                if remaining > len(idx):
                    self._replay_partial[int(ref)] = remaining - len(idx)
                else:
                    del self._replay_partial[int(ref)]
        n_stale = int(stale.sum())
        if n_stale:
            self._m_replay_skipped.inc(n_stale)
            keep = ~stale
            batch = {k: v[keep] for k, v in batch.items()}
            refs = batch["payload_ref"]
            journaled = refs != NULL_ID
            if not len(refs):
                return
        tally = ()
        if journaled.any():
            uniq, counts = np.unique(refs[journaled], return_counts=True)
            tally = tuple(zip(uniq.tolist(), counts.tolist()))
        try:
            self._q.put_nowait((batch, tally, committed))
        except queue.Full:
            self._m_dropped.inc()

    def drain(self, timeout_s: float = 10.0) -> None:
        """Block until every offered batch has been evaluated."""
        deadline = time.monotonic() + timeout_s
        with self._q.all_tasks_done:
            while self._q.unfinished_tasks:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self._q.all_tasks_done.wait(remaining)

    def flush_live(self, name: Optional[str] = None) -> int:
        """Finalize open windows/sessions of live state (drains first).
        Returns the number of matches emitted."""
        self.drain()
        with self._lock:
            entries = [e for n, e in sorted(self._queries.items())
                       if name is None or n == name]
        if name is not None and not entries:
            raise EntityNotFound(f"no query {name!r}")
        emitted = 0
        for entry in entries:
            with self._eval_mutex, self._on_stream():
                matches = entry.compiled.flush()
                self._sync()
            self._record(entry, matches, live=True)
            emitted += len(matches)
        return emitted

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                if item is None:
                    continue
                self._m_batches.inc()
                self._eval_batch(*item)
            except Exception:
                _LOG.exception("live analytics eval failed")
            finally:
                self._q.task_done()

    def _advance(self, tally, committed: Optional[int]) -> None:
        """Count the batch's rows as applied (under the eval mutex)."""
        for ref, count in tally:
            self._applied_partial[ref] = \
                self._applied_partial.get(ref, 0) + count
        if committed is not None and committed > (self.applied_upto or 0):
            self.applied_upto = committed
            for ref in [r for r in self._applied_partial if r < committed]:
                del self._applied_partial[ref]

    def _eval_batch(self, batch: Dict[str, np.ndarray], tally=(),
                    committed: Optional[int] = None) -> None:
        if self.quotas is not None and "tenant_id" in batch:
            # quota gate: over-soft-quota tenants lose their rows here;
            # None when no quota is configured
            try:
                skip = self.quotas.skip_mask(np.asarray(batch["tenant_id"]))
            except Exception:
                _LOG.exception("analytics quota mask failed")
                skip = None
            if skip is not None and skip.any():
                keep = ~skip
                n = len(skip)
                if not keep.any():
                    # consumed (and refused), not lost
                    with self._eval_mutex:
                        self._advance(tally, committed)
                    return
                batch = {k: (np.asarray(v)[keep]
                             if np.ndim(v) >= 1 and len(v) == n else v)
                         for k, v in batch.items()}
        with self._lock:
            entries = list(self._queries.values())
        trace = (self.tracer.trace("analytics.eval")
                 if self.tracer is not None else _NOOP_TRACE)
        results = []
        rows = int(len(batch["device_id"]))
        # ONE mutex hold for the whole batch: every query's state, the
        # applied counts and the watermark advance together
        eval_t0 = time.perf_counter()
        with self._eval_mutex:
            with self._on_stream():
                staged = stage_columns(batch, self.device)
                for entry in entries:
                    with trace.span("analytics.query") as sp:
                        sp.tag("query", entry.spec.name)
                        sp.tag("rows", rows)
                        with entry.timer.time():
                            matches = entry.compiled.eval_staged(staged)
                    occ = entry.compiled.last_occupancy
                    if occ is not None:
                        self._m_occupancy.set(occ)
                    results.append((entry, matches))
            self._advance(tally, committed)
        tenants = batch.get("tenant_id")
        if self.usage_ledger is not None and tenants is not None \
                and len(tenants):
            try:
                per_row = (time.perf_counter() - eval_t0) / len(tenants)
                self.usage_ledger.charge_rows_host(
                    np.asarray(tenants), "eval_s",
                    weights=np.full(len(tenants), per_row))
            except Exception:
                _LOG.exception("analytics usage charge failed")
        # off the runner's stream: fan-out may reach other components
        for entry, matches in results:
            self._record(entry, matches, live=True)
        trace.end()

    def _record(self, entry: _LiveQuery, matches, live: bool) -> None:
        if not matches:
            return
        entry.counter.inc(len(matches))
        with self._lock:
            if live:
                entry.live_matches += len(matches)
                entry.matches.extend(matches)
        if live and self.fanout_matches and self.outbound is not None:
            cols, mask = self._match_columns(matches)
            try:
                self.outbound.submit(cols, mask)
            except Exception:
                _LOG.exception("match fan-out failed")

    def _match_columns(self, matches):
        """Matches as a synthetic enriched column batch (STATE_CHANGE
        rows) for the outbound connector path."""
        n = len(matches)
        null = np.full(n, NULL_ID, np.int32)
        zero_i, zero_f = np.zeros(n, np.int32), np.zeros(n, np.float32)
        cols = {
            "device_id": np.asarray([m.device_id for m in matches],
                                    np.int32),
            "tenant_id": zero_i,
            "event_type": np.full(n, int(EventType.STATE_CHANGE), np.int32),
            "ts_s": np.asarray([m.ts_s for m in matches], np.int32),
            "ts_ns": zero_i,
            "mtype_id": null,
            "value": np.asarray([m.value for m in matches], np.float32),
            "lat": zero_f, "lon": zero_f, "elevation": zero_f,
            "alert_code": null, "alert_level": zero_i, "command_id": null,
            "payload_ref": null, "device_type_id": null,
            "assignment_id": null, "area_id": null, "customer_id": null,
            "asset_id": null,
        }
        return cols, np.ones(n, bool)

    # -- retrospective mode -------------------------------------------------

    def run_retrospective(self, name: str, start_s: Optional[int] = None,
                          end_s: Optional[int] = None,
                          store=None) -> Dict[str, object]:
        """Stream the query's compiled operator over the sealed event
        store (``iter_chunks``: catalog-pruned, row-filtered chunks) with
        FRESH state: the same operator, carry logic and matches as live
        mode over those events."""
        store = store or self.event_store
        if store is None:
            raise EntityNotFound("no event store configured")
        with self._lock:
            entry = self._queries.get(name)
        if entry is None:
            raise EntityNotFound(f"no query {name!r}")
        compiled = compile_query(entry.spec, self.capacity,
                                 resolve_mtype=self.resolve_mtype,
                                 device=self.device)
        filters: Dict[str, object] = {"start_s": start_s, "end_s": end_s}
        if isinstance(entry.spec, WindowQuery):
            # window queries only consume measurements: let the store
            # prune non-measurement chunks via its zone maps
            filters["event_type"] = int(EventType.MEASUREMENT)
            if compiled.mtype_id >= 0:
                filters["mtype_id"] = compiled.mtype_id
        trace = (self.tracer.trace("analytics.retrospective")
                 if self.tracer is not None else _NOOP_TRACE)
        rows = 0
        chunks = 0
        matches = []
        scan_stats: Dict[str, int] = {}
        try:
            chunk_iter = store.iter_chunks(stats=scan_stats, **filters)
        except TypeError:
            scan_stats = None
            chunk_iter = store.iter_chunks(**filters)
        with trace.span("analytics.scan") as sp:
            sp.tag("query", name)
            with entry.retro_timer.time():
                for cols in chunk_iter:
                    n = len(cols["ts_s"])
                    if n == 0:
                        continue
                    rows += n
                    chunks += 1
                    matches.extend(compiled.eval_cols(cols))
                matches.extend(compiled.flush())
            sp.tag("rows", rows)
            sp.tag("chunks", chunks)
            sp.tag("matches", len(matches))
        trace.end()
        entry.counter.inc(len(matches))
        self._m_retro_rows.inc(rows)
        self._m_retro_runs.inc()
        with self._lock:
            entry.retro_runs += 1
        report = {"query": name, "rows": rows, "chunks": chunks,
                  "matches": [m.to_dict() for m in matches]}
        if scan_stats is not None:
            report["scan"] = dict(scan_stats)
        return report



class EventTap:
    """Streaming bridge: accumulate enriched event batches for analytics.

    Register :meth:`connector` (an outbound callback connector) with the
    outbound manager; batches accumulate on the host, at most
    ``max_batches`` (the oldest dropped), until :meth:`drain`."""

    def __init__(self, max_batches: int = 1024):
        self.max_batches = max_batches
        self._batches: List[Dict[str, np.ndarray]] = []
        # on_batch runs on the outbound worker thread, drain on the
        # caller's: the cap check, pop and append, and the drain swap,
        # must be atomic or a concurrent append is lost
        self._lock = threading.Lock()

    def connector(self):
        from sitewhere_tpu_torch.outbound.connectors import CallbackConnector

        def on_batch(cols, mask):
            batch = {k: np.asarray(v)[mask].copy() for k, v in cols.items()}
            with self._lock:
                if len(self._batches) >= self.max_batches:
                    self._batches.pop(0)
                self._batches.append(batch)

        return CallbackConnector(connector_id="analytics-tap", fn=on_batch)

    def drain(self) -> Dict[str, np.ndarray]:
        with self._lock:
            batches, self._batches = self._batches, []
        if not batches:
            return {}
        return {
            key: np.concatenate([b[key] for b in batches])
            for key in batches[0]
        }


__all__ = ["AnalyticsJob", "Anomaly", "EventTap", "QueryRunner",
           "WindowGrid", "build_window_grid", "detect_anomalies"]
