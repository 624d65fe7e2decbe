"""Durable columnar event store: persistence and query for device events.

Counterpart of ``sitewhere_tpu/services/event_store.py``, the base of
:class:`~sitewhere_tpu_torch.store.segmented.SegmentStore`:

- **write buffering**: appended column batches buffer and a flusher
  thread seals them into immutable columnar segments on (rows,
  interval) thresholds;
- **denormalized query paths**: every segment stores the enriched
  context columns (assignment, customer, area, asset ids from the
  step's enrichment gather) with per-segment zone maps, so an index
  query is a vectorized mask over pruned segments, newest first;
- **event ids**: ``(seq << 24) | row`` packed int64, stable across
  restarts.

Segments are numpy struct-of-arrays persisted as ``.npz`` files in the
format of :mod:`~sitewhere_tpu_torch.store.segment`.  The resident set
is bounded: sealed segments keep only their prune metadata in memory
and columns page in through a byte-bounded LRU.  A seal that keeps
failing past its retry budget dead-letters its rows, and the
``crash.mid_seal`` crosspoint marks the write.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from sitewhere_tpu_torch.ids import NULL_ID
from sitewhere_tpu_torch.runtime import faults
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent
from sitewhere_tpu_torch.runtime.metrics import global_registry
from sitewhere_tpu_torch.runtime.resilience import dead_letter

from sitewhere_tpu_torch.services.common import (
    EntityNotFound,
    SearchCriteria,
    SearchResults,
    ValidationError,
)

logger = logging.getLogger("sitewhere_tpu_torch.event_store")

# The storage format — column schema, zone-map/Bloom prune metadata,
# the lazy Segment (né _Chunk) and its byte-bounded column LRU — now
# lives in store/segment.py, the canonical home shared with the
# log-structured segment store (store/segmented.py).  The
# legacy private names stay importable here: this module's chunk
# machinery IS the segment format, single-writer edition.
from sitewhere_tpu_torch.store.segment import (  # noqa: E402
    COLUMNS,
    ROW_BITS as _ROW_BITS,
    ColumnCache as _ColumnCache,
    Segment as _Chunk,
    SegmentPruned as _ChunkPruned,
    bloom_probe as _bloom_probe,
    bloom_member as _bloom_member,
    event_id,
    segment_pruned as _chunk_pruned,
    split_event_id,
)
from sitewhere_tpu_torch.store.segment import (  # noqa: E402
    BLOOM_COLUMNS as _BLOOM_COLUMNS,
    COLUMN_NAMES as _COLUMN_NAMES,
    FILTER_COLUMNS as _FILTER_COLUMNS,
    META_BOUNDS as _META_BOUNDS,
    META_CORE as _META_CORE,
    META_VERSION as _META_VERSION,
)

_CHUNK_RE = re.compile(r"^events-(\d{10})\.npz$")


@dataclasses.dataclass
class EventRecord:
    """One event, host-facing (REST marshaling resolves handles to tokens)."""

    event_id: int
    device_id: int
    tenant_id: int
    event_type: int
    ts_s: int
    ts_ns: int
    mtype_id: int
    value: float
    lat: float
    lon: float
    elevation: float
    alert_code: int
    alert_level: int
    command_id: int
    payload_ref: int
    device_type_id: int
    assignment_id: int
    area_id: int
    customer_id: int
    asset_id: int
    received_s: int


class EventStore(LifecycleComponent):
    """Buffered columnar event persistence with indexed queries.

    ``flush_rows`` / ``flush_interval_s`` mirror the reference buffer's
    (10k, 250ms) thresholds (``DeviceEventBuffer.java:40-46``).
    """

    def __init__(
        self,
        root: str,
        flush_rows: int = 10_000,
        flush_interval_s: float = 0.25,
        retention_s: Optional[int] = None,
        resident_bytes: int = 256 << 20,
        dead_letters=None,
        max_seal_retries: int = 8,
        seal_retry_window_s: float = 30.0,
        name: str = "event-store",
    ):
        super().__init__(name)
        self.dir = os.path.join(root, "events")
        os.makedirs(self.dir, exist_ok=True)
        self.flush_rows = flush_rows
        self.flush_interval_s = flush_interval_s
        # Bounded working set over sealed columns: blooms + zone-map
        # bounds + the write buffer stay resident; everything else pages
        # in through this LRU (the npz files are the
        # memory manager, not just durability).
        self._cache = _ColumnCache(resident_bytes)
        # event-time retention window; 0/None = keep forever.  The
        # reference delegates retention to its datastores (Cassandra
        # hour buckets, CassandraClient.java:47, are exactly
        # prune-whole-bucket); here the flusher enforces it.
        self.retention_s = int(retention_s) if retention_s else 0
        self._last_prune = 0.0
        self._lock = threading.Lock()
        self._buffer: List[Dict[str, np.ndarray]] = []
        self._buffered_rows = 0
        self._last_flush = time.monotonic()
        self._chunks: List[_Chunk] = []
        self._next_seq = 0
        self._flusher: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # Writer→flusher handoff: append_columns signals instead of
        # sealing inline, so the dispatcher's egress thread never pays the
        # npz write + fsyncs (measured up to ~16 ms/seal on the wire-path
        # p99).  The inline safety valve below bounds the buffer if the
        # flusher ever falls behind.
        self._flush_wake = threading.Event()
        # Files sealed with deferred durability (chunks + marker) not yet
        # fsync'd — settled by _sync_durable at explicit flush()/prune
        # points.  Guarded by _lock.
        self._unsynced_paths: set = set()
        # Serializes flush()'s two-phase seal across threads (writer
        # valve, background flusher, commit gate); _lock is only held for
        # the memory-side phases inside it.
        self._flush_io = threading.Lock()
        # Chunks published to _chunks whose npz write failed — columns
        # still attached; retried by the next flush.  Guarded by _lock.
        self._unwritten: List[tuple] = []
        # Seal failures retry (bounded): once a chunk has failed more
        # than max_seal_retries times AND its first failure is at least
        # seal_retry_window_s old, it dead-letters instead of pinning
        # its columns in memory and blocking the commit gate's sync
        # flush forever — the dead-letter record is the durable trace of
        # those rows (see flush()).  The wall-clock window matters: the
        # flusher ticks every flush_interval_s (plus commit-gate sync
        # flushes), so an attempt count alone would burn the whole
        # budget inside ~2 s and drop data over a transient disk blip.
        self.dead_letters = dead_letters
        self.max_seal_retries = int(max_seal_retries)
        self.seal_retry_window_s = float(seal_retry_window_s)
        self._seal_attempts: Dict[int, Tuple[int, float]] = {}
        self.sealed_dead_lettered = 0
        self._load_existing()

    # -- lifecycle ----------------------------------------------------------

    def _load_existing(self) -> None:
        for fname in sorted(os.listdir(self.dir)):
            m = _CHUNK_RE.match(fname)
            if not m:
                continue
            seq = int(m.group(1))
            path = os.path.join(self.dir, fname)
            try:
                chunk = self._open_chunk(seq, path)
            except Exception:
                # A torn chunk file must not stop the store from booting:
                # deferred-fsync seals rename before their content fsync,
                # so a power loss can leave garbage at the canonical name.
                # Quarantine it (keep the bytes for forensics) and move
                # on — the rows are covered by at-least-once journal
                # replay, because the offset covering them can only have
                # committed AFTER a sync flush made the chunk durable.
                logger.exception(
                    "chunk %d unreadable; quarantining %s", seq, path)
                try:
                    os.replace(path, path + ".corrupt")
                except OSError:
                    pass
                self._next_seq = max(self._next_seq, seq + 1)
                continue
            self._chunks.append(chunk)
            self._next_seq = max(self._next_seq, seq + 1)
        # high-water marker: retention may have pruned EVERY chunk file,
        # and seqs must never regress — a re-minted event id would resolve
        # to an unrelated newer event (ids embed the chunk seq)
        marker = os.path.join(self.dir, "next-seq")
        marker_value = -1
        try:
            with open(marker) as f:
                marker_value = int(f.read() or 0)
                self._next_seq = max(self._next_seq, marker_value)
        except (FileNotFoundError, ValueError):
            pass
        if self._next_seq > max(marker_value, 0):
            # Marker absent (store predates it) or stale (crash between a
            # chunk seal and its marker write): bring it up to the
            # chunk-derived value NOW, or an idle store fully pruned by
            # retention would regress seqs on the next boot.
            self._write_marker()

    def _open_chunk(self, seq: int, path: str) -> _Chunk:
        """Open a sealed chunk reading ONLY its prune metadata.

        np.load on an npz reads the zip directory, not the members; the
        metadata arrays written at seal time (``_meta_core``, bounds,
        blooms — ~33 KB/chunk) are the only members touched here.  A
        pre-metadata chunk (older store) falls back to a one-time full
        read to rebuild its metadata, then releases the columns.
        """
        with np.load(path) as data:
            files = set(data.files)
            if _META_CORE in files and _META_BOUNDS in files:
                core = data[_META_CORE]
                bounds_arr = data[_META_BOUNDS]
                if (int(core[0]) == _META_VERSION
                        and len(bounds_arr) == len(_FILTER_COLUMNS)):
                    bounds = {
                        name: (int(bounds_arr[i][0]), int(bounds_arr[i][1]))
                        for i, name in enumerate(_FILTER_COLUMNS)
                    }
                    blooms = {
                        name: data[_bloom_member(name)]
                        for name in _BLOOM_COLUMNS
                        if _bloom_member(name) in files
                    }
                    return _Chunk.lazy(
                        seq, path, self._cache, n=int(core[1]),
                        min_ts=int(core[2]), max_ts=int(core[3]),
                        bounds=bounds, blooms=blooms)
            # metadata absent/unknown-version: rebuild from the columns
            cols = {name: data[name] for name in _COLUMN_NAMES
                    if name in files}
        for name, dtype in COLUMNS:  # forward-compat: absent → default
            if name not in cols:
                cols[name] = np.full(len(cols["ts_s"]), NULL_ID, dtype)
        chunk = _Chunk(seq, cols)
        try:
            # persist the rebuilt metadata so this full read happens ONCE,
            # not on every boot (same atomic seal path flush() uses)
            self._write_chunk_file(path, cols, chunk)
        except OSError:
            logger.exception("could not upgrade chunk %d metadata", seq)
        chunk.detach(path, self._cache)
        return chunk

    def _write_chunk_file(self, path: str, cols: Dict[str, np.ndarray],
                          chunk: _Chunk, sync: bool = True) -> None:
        """Atomically write one sealed chunk: columns + prune metadata.

        ``sync=False`` defers the fsyncs: the write stays atomic (tmp +
        rename) but durability is settled later by :meth:`_sync_durable`.
        Routine seals use this — the at-least-once premise only requires
        a chunk to be DURABLE before the journal offset covering its rows
        is committed (the commit gate's explicit ``flush()``), not at
        seal time, and per-seal fsyncs measured as the single largest
        cost on the wire path (they also stall the ingest journal's
        writes through the filesystem journal)."""
        meta = {
            _META_CORE: np.asarray(
                [_META_VERSION, chunk.n, chunk.min_ts, chunk.max_ts],
                np.int64),
            _META_BOUNDS: np.asarray(
                [chunk.bounds[name] for name in _FILTER_COLUMNS], np.int64),
        }
        for bname, bloom in chunk.blooms.items():
            meta[_bloom_member(bname)] = bloom
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **cols, **meta)
            if sync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if sync:
            self._fsync_dir()
        else:
            self._unsynced_paths.add(path)

    def _write_marker(self, sync: bool = True) -> None:
        """Record the seq high-water mark (the marker is what keeps seqs
        from regressing after retention prunes every chunk).  With
        ``sync=False`` durability is deferred to :meth:`_sync_durable`;
        boot recovers a stale marker from the chunk files themselves, so
        the marker only MUST be durable before a prune unlinks chunks."""
        marker = os.path.join(self.dir, "next-seq")
        tmp = f"{marker}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(self._next_seq))
            if sync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, marker)
        if sync:
            self._fsync_dir()
        else:
            self._unsynced_paths.add(marker)

    def _sync_durable(self) -> None:
        """Settle deferred durability: fsync every async-sealed file, then
        the directory once.  Called under ``_lock``."""
        if not self._unsynced_paths:
            return
        for path in list(self._unsynced_paths):
            try:
                fd = os.open(path, os.O_RDONLY)
            except FileNotFoundError:
                self._unsynced_paths.discard(path)  # pruned before syncing
                continue
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            self._unsynced_paths.discard(path)
        self._fsync_dir()

    def _fsync_dir(self) -> None:
        """Make the latest rename itself durable: fsyncing file CONTENTS
        does not persist the directory entry — without this a power loss
        can vanish a freshly sealed chunk/marker whose journal copy was
        already reclaimed."""
        try:
            fd = os.open(self.dir, os.O_RDONLY)
        except OSError:
            return  # platform without directory fds: best effort
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)

    def start(self) -> None:
        super().start()
        self._stop.clear()
        self._flusher = threading.Thread(
            target=self._flush_loop, name=f"{self.name}-flusher", daemon=True
        )
        self._flusher.start()

    def stop(self) -> None:
        self._stop.set()
        self._flush_wake.set()
        if self._flusher is not None:
            self._flusher.join(timeout=5)
            self._flusher = None
        self.flush()
        super().stop()

    def _flush_loop(self) -> None:
        while not self._stop.is_set():
            self._flush_wake.wait(timeout=self.flush_interval_s / 2)
            self._flush_wake.clear()
            if self._stop.is_set():
                break
            with self._lock:
                due = self._buffered_rows > 0 and (
                    self._buffered_rows >= self.flush_rows
                    or time.monotonic() - self._last_flush >= self.flush_interval_s
                )
            if due:
                try:
                    self.flush(sync=False)
                except Exception:  # transient I/O failure must not kill the
                    # flusher; the buffer is retained and retried next tick.
                    logger.exception("event flush failed; will retry")
            if (self.retention_s
                    and time.monotonic() - self._last_prune >= 60.0):
                self._last_prune = time.monotonic()
                try:
                    self.prune_older_than(int(time.time()) - self.retention_s)
                except Exception:
                    logger.exception(
                        "event retention prune failed; will retry")

    # -- writes -------------------------------------------------------------

    def append_columns(
        self, cols: Dict[str, np.ndarray], mask: Optional[np.ndarray] = None
    ) -> int:
        """Append a column batch (optionally row-masked).  Returns rows added.

        The dispatcher calls this with the post-pipeline batch columns +
        enrichment outputs; REST-created events arrive via :meth:`add_event`.
        """
        n = None
        out: Dict[str, np.ndarray] = {}
        received = np.int32(int(time.time()))
        # One index vector shared by every column: boolean-mask indexing
        # re-scans the mask per column, and the masked take already yields
        # a fresh array, so the defensive astype copy is only needed on
        # the unmasked path (buffered columns must never alias caller
        # arrays the intake may reuse).
        mask_arr = None if mask is None else np.asarray(mask)
        idx = None if mask_arr is None else np.nonzero(mask_arr)[0]
        src_n = None
        for name, dtype in COLUMNS:
            if name == "received_s":
                continue
            if name not in cols:
                raise ValidationError(f"missing event column {name}")
            arr = np.asarray(cols[name])
            if src_n is None:
                src_n = len(arr)
                n = len(idx) if idx is not None else src_n
                if mask_arr is not None and len(mask_arr) != src_n:
                    raise ValidationError(
                        f"mask length {len(mask_arr)} != {src_n}")
            elif len(arr) != src_n:
                raise ValidationError(
                    f"column {name} length {len(arr)} != {src_n}")
            if idx is not None:
                out[name] = arr.take(idx).astype(dtype, copy=False)
            else:
                out[name] = arr.astype(dtype, copy=True)
        if not n:
            return 0
        out["received_s"] = np.full(n, received, np.int32)
        with self._lock:
            self._buffer.append(out)
            self._buffered_rows += n
            rows = self._buffered_rows
        if rows >= self.flush_rows:
            # Seal on the flusher thread — the writer only signals, so the
            # dispatcher's egress never pays the npz write + fsyncs.  The
            # inline flush is a safety valve: past 4× the threshold the
            # writer pays the seal itself, bounding memory if the flusher
            # falls behind (commit-gate callers still flush() explicitly).
            # Without a running flusher (unstarted store) seal inline as
            # before.
            if self._flusher is None or rows >= 4 * self.flush_rows:
                self.flush(sync=False)
            else:
                self._flush_wake.set()
        return n

    def _buffer_chunk_locked(self) -> Optional[_Chunk]:
        """The unsealed buffer viewed as a virtual chunk at ``_next_seq``
        (read paths include it instead of forcing a flush per query)."""
        if not self._buffer:
            return None
        merged = {
            name: np.concatenate([b[name] for b in self._buffer])
            for name in _COLUMN_NAMES
        }
        return _Chunk(self._next_seq, merged, light=True)

    def _buffer_chunks_locked(self) -> List[_Chunk]:
        """Virtual chunk(s) over every unsealed row, newest-last.  The
        single-writer store has exactly one unsealed buffer; the sharded
        segment store overrides this with one virtual segment per open
        shard buffer and queued seal job."""
        chunk = self._buffer_chunk_locked()
        return [] if chunk is None else [chunk]

    def add_event(self, **fields) -> EventRecord:
        """Append one event (REST create path, ``Assignments.java:428-433``).

        The event id is computed from the buffered position under the append
        lock — appends between this call and the sealing flush land *after*
        this row, so the (seq, row) the caller gets back stays correct.
        """
        row = {}
        received = np.int32(int(time.time()))
        for name, dtype in COLUMNS:
            if name == "received_s":
                row[name] = np.asarray([received], dtype)
                continue
            default = NULL_ID if np.issubdtype(dtype, np.integer) else 0.0
            row[name] = np.asarray([fields.get(name, default)], dtype)
        with self._lock:
            seq, base = self._next_seq, self._buffered_rows
            self._buffer.append(row)
            self._buffered_rows += 1
        return EventRecord(
            event_id=event_id(seq, base),
            **{name: row[name][0].item() for name in _COLUMN_NAMES},
        )

    def flush(self, sync: bool = True) -> int:
        """Seal the buffer into chunk(s).  Returns rows sealed.

        Two phases so appends/readers never wait on file IO: under
        ``_lock`` the buffer is merged and turned into _Chunk objects
        (memory-only: zone maps + blooms, columns stay attached) that are
        published to ``_chunks`` immediately — reads serve them from the
        resident columns meanwhile.  The npz writes then happen OUTSIDE
        ``_lock`` (serialized by ``_flush_io``); each written chunk
        detaches to its file, and a write failure parks the chunk on a
        retry list the next flush drains.  ``sync=True`` (explicit
        callers: the dispatcher's commit gate, shutdown) settles every
        deferred fsync before returning and raises if any chunk is still
        unwritten — the durability point the journal-reclaim premise
        needs.  ``sync=False`` (the background flusher) keeps all IO off
        the writer's p99.
        """
        max_rows = (1 << _ROW_BITS) - 1
        with self._flush_io:
            with self._lock:
                new = []
                if self._buffer:
                    merged = {
                        name: np.concatenate([b[name] for b in self._buffer])
                        for name in _COLUMN_NAMES
                    }
                    total = len(merged["ts_s"])
                    done = 0
                    try:
                        for lo in range(0, total, max_rows):
                            part = {k: v[lo : lo + max_rows]
                                    for k, v in merged.items()}
                            # prune metadata computed once, WHILE the
                            # columns are in memory, and persisted with
                            # them — a restart then reads ~33 KB/chunk
                            # instead of the columns
                            chunk = _Chunk(self._next_seq, part)
                            path = os.path.join(
                                self.dir, f"events-{chunk.seq:010d}.npz")
                            self._chunks.append(chunk)
                            # registered as unwritten in the SAME critical
                            # section that publishes the chunk: no failure
                            # below can strand a published chunk off the
                            # retry list (a stranded chunk would let the
                            # commit gate report durable-success for rows
                            # that exist nowhere on disk)
                            self._unwritten.append((chunk, part, path))
                            new.append((chunk, part, path))
                            self._next_seq += 1
                            done += len(part["ts_s"])
                    finally:
                        remainder = {k: v[done:] for k, v in merged.items()}
                        self._buffer = (
                            [remainder] if len(remainder["ts_s"]) else []
                        )
                        self._buffered_rows = total - done
                work = list(self._unwritten)
                if new:
                    # once per flush, not per chunk: boot recovers a stale
                    # marker from the chunk files themselves.  Non-fatal:
                    # a failed marker write must not abort the seal work
                    # queued above (it is itself recoverable from the
                    # chunk files at boot).
                    try:
                        self._write_marker(sync=False)
                    except OSError:
                        logger.exception("next-seq marker write failed")
                self._last_flush = time.monotonic()
            flushed = sum(len(p["ts_s"]) for _, p, _ in new)

            # Phase 2: file IO with _lock released.  Journal reclaim
            # deletes raw records below the committed offset on the
            # premise that sealed chunks are durable by COMMIT time: the
            # commit gate flushes sync=True, which settles the deferred
            # fsyncs (and refuses on any unwritten chunk) first.
            failed = []
            for chunk, part, path in work:
                try:
                    faults.fire("event_store.flush")
                    # chaos kill point: death mid-seal leaves a partial
                    # chunk file; boot must tolerate it and journal
                    # replay must re-derive the chunk's rows
                    faults.crosspoint("crash.mid_seal")
                    self._write_chunk_file(path, part, chunk, sync=False)
                except OSError as e:
                    now = time.monotonic()
                    with self._lock:
                        attempts, first_t = self._seal_attempts.get(
                            id(chunk), (0, now))
                        attempts += 1
                        self._seal_attempts[id(chunk)] = (attempts, first_t)
                    global_registry().counter(
                        "resilience.retries.event_store.seal").inc()
                    if (attempts > self.max_seal_retries
                            and now - first_t >= self.seal_retry_window_s):
                        # Terminal: dead-letter the chunk's rows instead
                        # of retrying forever — bounded memory, and the
                        # commit gate's sync flush can succeed again (the
                        # dead-letter record is the durable trace).
                        logger.error(
                            "chunk %d seal failed %d times; dead-lettering"
                            " %d rows: %s", chunk.seq, attempts, chunk.n, e)
                        if self._dead_letter_chunk(chunk, part, path, e):
                            continue
                        # the durable trace could not be written (often
                        # the same dead disk): dropping the chunk now
                        # would be SILENT loss — keep it resident and
                        # keep the sync flush failing instead
                        failed.append((chunk, part, path))
                        continue
                    logger.exception("chunk %d seal failed; will retry",
                                     chunk.seq)
                    failed.append((chunk, part, path))
                    continue
                with self._lock:
                    self._seal_attempts.pop(id(chunk), None)
                    if any(c is chunk for c in self._chunks):
                        # release the resident columns: reads reload (and
                        # LRU-cache) from the file from here on
                        chunk.detach(path, self._cache)
                    else:
                        # retention pruned it while being written — don't
                        # resurrect the file at next boot
                        self._unsynced_paths.discard(path)
                        try:
                            os.unlink(path)
                        except OSError:
                            pass
            with self._lock:
                # entries stayed registered throughout; release the ones
                # whose files landed (failed ones remain for retry — as
                # do any a concurrent prune already filtered out)
                written = ({id(e[0]) for e in work}
                           - {id(e[0]) for e in failed})
                self._unwritten = [e for e in self._unwritten
                                   if id(e[0]) not in written]
                if sync:
                    self._sync_durable()
            if sync and failed:
                raise OSError(
                    f"{len(failed)} chunk(s) not durably sealed")
            return flushed

    def _dead_letter_chunk(self, chunk, part, path, exc) -> bool:
        """Terminal seal failure: record the chunk's rows to the
        dead-letter sink, then drop it from the store.  The ingest journal
        may reclaim the raw records once commits resume — the dead-letter
        record IS the durable trace of these rows from here on, so the
        chunk is only dropped once that record landed (a configured sink
        that also fails returns False and the caller keeps retrying the
        seal — bounded memory loses to silent loss)."""
        recorded = dead_letter(self.dead_letters, {
            "kind": "event-flush-failed",
            "seq": int(chunk.seq),
            "rows": int(chunk.n),
            "ts_min": int(part["ts_s"].min()) if len(part["ts_s"]) else 0,
            "ts_max": int(part["ts_s"].max()) if len(part["ts_s"]) else 0,
            "error": str(exc),
        })
        if self.dead_letters is not None and not recorded:
            return False
        with self._lock:
            self._seal_attempts.pop(id(chunk), None)
            self._chunks = [c for c in self._chunks if c is not chunk]
            self._unsynced_paths.discard(path)
            self.sealed_dead_lettered += int(chunk.n)
        return True

    # -- reads --------------------------------------------------------------

    @property
    def total_events(self) -> int:
        with self._lock:
            return sum(c.n for c in self._chunks) + self._buffered_rows

    def prune_older_than(self, cutoff_s: int) -> int:
        """Delete whole sealed chunks whose NEWEST row predates
        ``cutoff_s`` (event time).  A chunk straddling the cutoff is
        kept whole — retention is per-bucket, exactly like dropping an
        expired Cassandra hour bucket, never a row-level rewrite.
        Event ids inside pruned chunks become unresolvable, as expired
        ids do in any TTL'd store.  Returns rows removed."""
        with self._lock:
            doomed = {id(c): c for c in self._chunks
                      if c.n and c.max_ts < cutoff_s}
            if not doomed:
                return 0
            # Seqs must never regress: make the high-water marker durable
            # BEFORE any chunk file disappears (boot recovers a stale
            # marker from chunk files — which are about to be gone).
            for chunk in doomed.values():
                self._unsynced_paths.discard(
                    os.path.join(self.dir, f"events-{chunk.seq:010d}.npz"))
            self._write_marker(sync=True)
            removed = 0
            for chunk in doomed.values():
                removed += chunk.n
                self._cache.drop_seq(chunk.seq)
                try:
                    os.unlink(os.path.join(
                        self.dir, f"events-{chunk.seq:010d}.npz"))
                except FileNotFoundError:
                    pass
            self._chunks = [c for c in self._chunks if id(c) not in doomed]
            # an expired chunk still awaiting its npz write must not be
            # rewritten by the next flush
            self._unwritten = [e for e in self._unwritten
                               if id(e[0]) not in doomed]
        return removed

    def get_event(self, eid: int) -> EventRecord:
        seq, row = split_event_id(eid)
        with self._lock:
            candidates = list(self._chunks)
            candidates.extend(self._buffer_chunks_locked())
        for chunk in candidates:
            if chunk.seq == seq:
                if row >= chunk.n:
                    break
                try:
                    return self._record(chunk, row)
                except _ChunkPruned:
                    break  # expired mid-lookup: same as an expired id
        raise EntityNotFound(f"event {eid}")

    def query(self, criteria: Optional[SearchCriteria] = None,
              **kwargs) -> SearchResults[EventRecord]:
        """Indexed event listing, newest-first — see :meth:`_query_once`.

        Retries on a fresh chunk snapshot when retention unlinks a chunk
        file mid-read (each retry's snapshot excludes the pruned chunk,
        so the loop is bounded by the chunk count)."""
        while True:
            try:
                return self._query_once(criteria, **kwargs)
            except _ChunkPruned as e:
                self._discard_vanished(e.seq)
                continue

    def _discard_vanished(self, seq: int) -> None:
        """Drop a chunk whose file is gone but which is still listed —
        a file deleted outside ``prune_older_than`` would otherwise make
        every retry hit the same chunk forever (livelock)."""
        path = os.path.join(self.dir, f"events-{seq:010d}.npz")
        if os.path.exists(path):
            return  # normal retention race: the fresh snapshot excludes it
        with self._lock:
            before = len(self._chunks)
            self._chunks = [c for c in self._chunks if c.seq != seq]
            if len(self._chunks) != before:
                logger.warning(
                    "event chunk %d vanished outside retention; discarded",
                    seq)
        self._cache.drop_seq(seq)

    def _query_once(
        self,
        criteria: Optional[SearchCriteria] = None,
        *,
        tenant_id: Optional[int] = None,
        device_id: Optional[int] = None,
        assignment_id: Optional[int] = None,
        customer_id: Optional[int] = None,
        area_id: Optional[int] = None,
        asset_id: Optional[int] = None,
        event_type: Optional[int] = None,
        mtype_id: Optional[int] = None,
        alert_code: Optional[int] = None,
        command_id: Optional[int] = None,
    ) -> SearchResults[EventRecord]:
        """Indexed event listing, newest-first (reference list* semantics).

        Each keyword mirrors one reference index path: device
        (``listDeviceEventsForIndex`` DeviceEventIndex.Device), assignment,
        customer, area, asset; ``event_type`` narrows to one add/list family
        (e.g. ``listMeasurementsForIndex``).
        """
        criteria = criteria or SearchCriteria()
        active = [
            (name, want)
            for name, want in (
                ("tenant_id", tenant_id), ("device_id", device_id),
                ("assignment_id", assignment_id),
                ("customer_id", customer_id), ("area_id", area_id),
                ("asset_id", asset_id), ("event_type", event_type),
                ("mtype_id", mtype_id), ("alert_code", alert_code),
                ("command_id", command_id))
            if want is not None
        ]
        t0, t1 = criteria.start_s, criteria.end_s
        with self._lock:
            chunks = list(self._chunks)
            chunks.extend(self._buffer_chunks_locked())

        probes = {
            name: _bloom_probe(int(want)) for name, want in active
            if name in _BLOOM_COLUMNS
        }

        def pruned(c: _Chunk) -> bool:
            return _chunk_pruned(c, active, probes, t0, t1)

        def match_mask(c: _Chunk) -> Optional[np.ndarray]:
            """Row mask, or None meaning every row matches (a filterless
            or fully-in-range chunk never touches its columns)."""
            mask = None
            for name, want in active:
                m = c.col(name) == want
                mask = m if mask is None else (mask & m)
            if t0 is not None and c.min_ts < t0:
                m = c.col("ts_s") >= t0
                mask = m if mask is None else (mask & m)
            if t1 is not None and c.max_ts > t1:
                m = c.col("ts_s") <= t1
                mask = m if mask is None else (mask & m)
            return mask

        # Phase 1 — exact total: a zone-map-pruned or filterless chunk
        # counts without touching (or materializing) any row.
        masks: List[Optional[np.ndarray]] = []
        counts: List[int] = []
        for c in chunks:
            if pruned(c):
                masks.append(None)
                counts.append(0)
                continue
            mask = match_mask(c)
            masks.append(mask)
            counts.append(c.n if mask is None else int(np.count_nonzero(mask)))
        total = sum(counts)
        if total == 0:
            return SearchResults(results=[], total=0)

        # Phase 2 — newest-first page WITHOUT sorting every hit: walk
        # chunks newest-max_ts-first and stop once the page's worst
        # candidate is strictly newer than anything a remaining chunk
        # could hold (chunk max_ts bounds its best key).  Only the
        # collected candidates sort; the worst case (fully overlapping
        # time ranges or an unlimited page) degrades to the full sort.
        unlimited = criteria.page_size <= 0
        # max(page, 1): SearchCriteria.slice clamps page<=0 to page 1,
        # so the candidate budget must too (0 would make the kth-newest
        # partition index fall out of bounds)
        needed = total if unlimited else min(
            total, max(criteria.page, 1) * criteria.page_size)
        by_newest = sorted(
            (i for i in range(len(chunks)) if counts[i]),
            key=lambda i: chunks[i].max_ts, reverse=True)
        sel_key: List[np.ndarray] = []
        sel_chunk: List[np.ndarray] = []
        sel_row: List[np.ndarray] = []
        collected = 0
        for pos, ci in enumerate(by_newest):
            chunk = chunks[ci]
            mask = masks[ci]
            rows = (np.arange(chunk.n, dtype=np.int64) if mask is None
                    else np.nonzero(mask)[0])
            # one int64 key: ts_s fits 2^31, ns < 1e9 → ts*1e9+ns < 2^63
            key = (chunk.col("ts_s")[rows].astype(np.int64)
                   * 1_000_000_000 + chunk.col("ts_ns")[rows])
            sel_key.append(key)
            sel_chunk.append(np.full(rows.size, ci, np.int32))
            sel_row.append(rows.astype(np.int32))
            collected += rows.size
            if collected >= needed and pos + 1 < len(by_newest):
                # kth-newest collected key vs the best key any remaining
                # chunk could hold; > (not >=) so equal-key rows in older
                # chunks keep their stable tie order
                kth = np.partition(
                    np.concatenate(sel_key), collected - needed
                )[collected - needed]
                next_best = (chunks[by_newest[pos + 1]].max_ts
                             * 1_000_000_000 + 999_999_999)
                if int(kth) > next_best:
                    break

        key = np.concatenate(sel_key)
        cidx = np.concatenate(sel_chunk)
        rix = np.concatenate(sel_row)
        # newest-first; ties keep chunk/insertion order (stable, matching
        # the previous full sort)
        order = np.lexsort((rix, cidx, -key))
        page = criteria.slice(order)
        # one column fetch per (chunk, column) for the whole page — not
        # per row: col() takes the cache lock, and a 100-row page over
        # lazy chunks would otherwise pay 2000 locked lookups
        cols_by_chunk: Dict[int, Dict[str, np.ndarray]] = {}
        results = []
        for i in page:
            ci, row = int(cidx[i]), int(rix[i])
            cols = cols_by_chunk.get(ci)
            if cols is None:
                cols = cols_by_chunk[ci] = chunks[ci].materialize()
            results.append(EventRecord(
                event_id=event_id(chunks[ci].seq, row),
                **{name: cols[name][row].item()
                   for name in _COLUMN_NAMES}))
        return SearchResults(results=results, total=total)

    def iter_chunks(
        self,
        *,
        event_type: Optional[int] = None,
        mtype_id: Optional[int] = None,
        device_id: Optional[int] = None,
        tenant_id: Optional[int] = None,
        start_s: Optional[int] = None,
        end_s: Optional[int] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Sealed chunks oldest-first — the analytics scan API.

        Lazy chunks materialize through the column cache, so a scan over
        a store far larger than ``resident_bytes`` streams (the LRU
        evicts behind the scan) instead of accumulating.

        Optional exact-match/time filters make this the retrospective
        query path: a chunk whose zone-map bounds (or Bloom, for
        device_id) exclude the wanted key is skipped without touching
        its columns — the same pruning the indexed ``query`` API uses —
        and surviving chunks yield row-filtered column dicts with
        relative order preserved (append order, i.e. the order live
        evaluation saw the events).  The filter/straddle rules are the
        SHARED scan-lane helpers (store/scan.py), so this path and the
        catalog edition can never disagree about which rows match."""
        from sitewhere_tpu_torch.store.scan import filters_active, row_mask

        self.flush()
        with self._lock:
            chunks = list(self._chunks)
        active = filters_active(event_type, mtype_id, device_id,
                                tenant_id)
        probes = {
            name: _bloom_probe(want) for name, want in active
            if name in _BLOOM_COLUMNS
        }
        for chunk in chunks:
            if _chunk_pruned(chunk, active, probes, start_s, end_s):
                continue
            try:
                cols = chunk.materialize()
            except _ChunkPruned:
                continue  # expired mid-scan: same as scanning after it
            mask = row_mask(chunk, cols, active, start_s, end_s)
            if mask is None or mask.all():
                yield cols
            elif mask.any():
                yield {k: v[mask] for k, v in cols.items()}

    def cache_stats(self) -> Dict[str, int]:
        """Resident-set accounting (observability + tests)."""
        c = self._cache
        return {"bytes": c.bytes, "max_bytes": c.max_bytes,
                "loads": c.loads, "hits": c.hits, "evictions": c.evictions}

    def _record(self, chunk: _Chunk, row: int) -> EventRecord:
        return EventRecord(
            event_id=event_id(chunk.seq, row),
            **{name: chunk.col(name)[row].item()
               for name in _COLUMN_NAMES},
        )
