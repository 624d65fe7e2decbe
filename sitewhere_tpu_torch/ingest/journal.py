"""Durable append-only event journal with offsets — the Kafka analog.

The reference gets durability + replay from Kafka: producers append protobuf
records to partitioned topics, consumers track offsets with manual commit
and resume after a crash (``MicroserviceKafkaConsumer.java:94,116-139``;
README: "events stack up in Kafka… resume where it left off").  Here the
boundary durability lives in a host-side segmented journal:

- records are length-prefixed, CRC-checked blobs appended to segment files;
- every record has a monotonically increasing offset;
- consumers (:class:`JournalReader`) poll batches from a committed offset
  and commit back — replay after crash = reopen at the committed offset;
- dead-letter streams (failed-decode, unregistered, undelivered — the
  reference's ``KafkaTopicNaming.java:48-78`` topics) are just more journals.

Segment format: ``[u32 len][u32 crc32][len bytes]*``.  Offsets are logical
record indices; a sparse index maps offsets to (segment, file position).
"""

from __future__ import annotations

import bisect
import json
import os
import struct
import threading
import time
import zlib
from typing import Iterator, List, Optional, Tuple

_HEADER = struct.Struct("<II")  # (length, crc32)
_INDEX_EVERY = 64  # sparse-index granularity (records)


class CorruptJournal(Exception):
    pass


class Journal:
    """A named, durable, append-only record log.

    ``fsync_every`` trades durability for throughput the same way the
    reference's Mongo event buffer trades flush interval
    (``DeviceEventBuffer.java:40-46``): 0 = fsync on every append (safest),
    N = fsync every N appends and on close/rotate.
    """

    def __init__(
        self,
        root: str,
        name: str = "events",
        segment_bytes: int = 64 << 20,
        fsync_every: int = 256,
        index_every: int = _INDEX_EVERY,
    ):
        self.dir = os.path.join(root, name)
        os.makedirs(self.dir, exist_ok=True)
        self.segment_bytes = segment_bytes
        self.fsync_every = fsync_every
        # 1 = dense index (O(1) point reads — e.g. large media chunks);
        # higher = sparser index, less memory, scans seek then roll forward.
        self.index_every = max(1, index_every)
        self._lock = threading.Lock()
        self._unsynced = 0
        # duration of the most recent fsync — an overload pressure
        # signal (a saturated disk shows up here before queues fill)
        self.last_fsync_s = 0.0
        # Offset index: (offset, segment path, byte pos) every
        # index_every records, so scans seek instead of replaying segments.
        self._index: List[Tuple[int, str, int]] = []
        # segments: sorted list of (base_offset, path)
        self._segments: List[Tuple[int, str]] = self._scan_segments()
        if not self._segments:
            self._segments = [(0, self._segment_path(0))]
        # Index EVERY segment on open so point reads into older segments
        # keep their granularity.  Rotated segments are immutable: their
        # index is persisted in a sidecar at rotation, so reopen cost is
        # O(sidecar) not O(segment bytes); a missing/stale sidecar falls
        # back to a scan (which also rebuilds it).  Only the final segment
        # may carry a torn tail (rotation fsyncs + closes the others).
        for base, path in self._segments[:-1]:
            if not self._load_sidecar(base, path):
                self._count_records(path, base, truncate_tail=False)
                self._write_sidecar(base, path)
        base, path = self._segments[-1]
        self._next_offset = base + self._count_records(path, base)
        self._file = open(path, "ab")

    # -- segment bookkeeping ------------------------------------------------

    def _segment_path(self, base_offset: int) -> str:
        return os.path.join(self.dir, f"{base_offset:020d}.log")

    def _sidecar_path(self, path: str) -> str:
        return path[:-4] + ".idx"

    def _load_sidecar(self, base: int, path: str) -> bool:
        """Load a rotated segment's persisted index; False on miss/stale."""
        try:
            with open(self._sidecar_path(path)) as f:
                doc = json.load(f)
        except (FileNotFoundError, ValueError):
            return False
        if doc.get("index_every") != self.index_every \
                or doc.get("size") != os.path.getsize(path):
            return False
        self._index.extend((base + off, path, pos)
                           for off, pos in doc.get("entries", []))
        return True

    def _write_sidecar(self, base: int, path: str) -> None:
        entries = [[off - base, pos] for off, ipath, pos in self._index
                   if ipath == path]
        tmp = self._sidecar_path(path) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"index_every": self.index_every,
                       "size": os.path.getsize(path),
                       "entries": entries}, f)
        os.replace(tmp, self._sidecar_path(path))

    def _scan_segments(self) -> List[Tuple[int, str]]:
        segs = []
        for fname in sorted(os.listdir(self.dir)):
            if fname.endswith(".log"):
                segs.append((int(fname[:-4]), os.path.join(self.dir, fname)))
        return segs

    def _count_records(self, path: str, base: int = 0,
                       truncate_tail: bool = True) -> int:
        """Count (and index) a segment's records on open.

        ``truncate_tail=True`` (final segment only): a torn tail from a
        crash mid-append is truncated.  ``False`` (rotated segments): any
        invalid record is real corruption → :class:`CorruptJournal`.
        """
        n = 0
        try:
            size = os.path.getsize(path)
        except FileNotFoundError:
            return 0
        with open(path, "rb") as f:
            pos = 0
            while True:
                if pos + _HEADER.size > size:
                    if pos < size:
                        if not truncate_tail:
                            raise CorruptJournal(f"{path} @ byte {pos}")
                        # Stray partial header from a crash mid-append:
                        # truncate so later appends stay readable.
                        with open(path, "ab") as tf:
                            tf.truncate(pos)
                    break
                length, crc = _HEADER.unpack(f.read(_HEADER.size))
                payload = f.read(length)
                if len(payload) < length:
                    if not truncate_tail:
                        raise CorruptJournal(f"{path} @ byte {pos}")
                    # Ran past EOF: torn tail from a crash mid-append.
                    with open(path, "ab") as tf:
                        tf.truncate(pos)
                    break
                if zlib.crc32(payload) != crc:
                    if truncate_tail and pos + _HEADER.size + length >= size:
                        # Final record, bad checksum: torn tail — truncate.
                        with open(path, "ab") as tf:
                            tf.truncate(pos)
                        break
                    # Corruption with valid data after it: not a crash
                    # artifact — refuse to silently drop records.
                    raise CorruptJournal(f"{path} @ byte {pos}")
                if (base + n) % self.index_every == 0:
                    self._index.append((base + n, path, pos))
                pos += _HEADER.size + length
                n += 1
        return n

    # -- producer side ------------------------------------------------------

    def append(self, payload: bytes) -> int:
        """Append one record; returns its offset."""
        with self._lock:
            offset = self._next_offset
            if offset % self.index_every == 0:
                self._index.append((offset, self._file.name, self._file.tell()))
            self._file.write(_HEADER.pack(len(payload), zlib.crc32(payload)))
            self._file.write(payload)
            self._next_offset += 1
            self._unsynced += 1
            if self.fsync_every == 0 or self._unsynced >= self.fsync_every:
                self._file.flush()
                t0 = time.perf_counter()
                os.fsync(self._file.fileno())
                self.last_fsync_s = time.perf_counter() - t0
                self._unsynced = 0
            if self._file.tell() >= self.segment_bytes:
                self._rotate()
            return offset

    def append_json(self, obj) -> int:
        return self.append(json.dumps(obj, separators=(",", ":")).encode())

    def _rotate(self) -> None:
        self._file.flush()
        os.fsync(self._file.fileno())
        self._unsynced = 0
        self._file.close()
        # persist the finished segment's index (it is immutable from here)
        finished_base, finished_path = self._segments[-1]
        self._write_sidecar(finished_base, finished_path)
        path = self._segment_path(self._next_offset)
        self._segments.append((self._next_offset, path))
        self._file = open(path, "ab")

    def flush(self) -> None:
        with self._lock:
            self._file.flush()
            t0 = time.perf_counter()
            os.fsync(self._file.fileno())
            self.last_fsync_s = time.perf_counter() - t0
            self._unsynced = 0

    def close(self) -> None:
        self.flush()
        self._file.close()

    def prune(self, upto: int) -> int:
        """Delete whole segments every record of which is below ``upto``.

        The Kafka retention analog, applied at the commit frontier
        instead of by wall-clock: callers prune only below a durably
        committed consumer offset (e.g. the forward spool after the peer
        acked).  The active segment is never deleted; reads below the
        new first base become invalid by contract.  Returns the number
        of segments removed."""
        removed = 0
        with self._lock:
            while len(self._segments) > 1 and self._segments[1][0] <= upto:
                _base, path = self._segments.pop(0)
                first_base = self._segments[0][0]
                self._index = [e for e in self._index if e[0] >= first_base]
                for victim in (path, self._sidecar_path(path)):
                    try:
                        os.unlink(victim)
                    except FileNotFoundError:
                        pass
                removed += 1
        return removed

    @property
    def end_offset(self) -> int:
        """Offset one past the last appended record."""
        return self._next_offset

    # -- random access (host payload_ref resolution) ------------------------

    def read_one(self, offset: int) -> bytes:
        """Read the record at ``offset`` (used to resolve ``payload_ref``)."""
        for rec_offset, payload in self.scan(offset, offset + 1):
            return payload
        raise KeyError(f"offset {offset} not in journal")

    def scan(self, start: int, stop: Optional[int] = None) -> Iterator[Tuple[int, bytes]]:
        """Yield ``(offset, payload)`` for offsets in ``[start, stop)``."""
        with self._lock:
            # Make appended bytes visible to readers of the same files;
            # durability (fsync) stays on the append policy.  Segments
            # snapshot under the lock so a concurrent prune() can't pull
            # the list out from under the iteration.
            self._file.flush()
            index = list(self._index)
            segments = list(self._segments)
            next_offset = self._next_offset
        for i, (base, path) in enumerate(segments):
            nxt = (
                segments[i + 1][0]
                if i + 1 < len(segments)
                else next_offset
            )
            if nxt <= start:
                continue
            offset, seek_pos = base, 0
            # Binary-search the index for the newest entry in THIS segment
            # at or before max(start, base).
            target = max(start, base)
            lo = bisect.bisect_right(index, (target, chr(0x10FFFF), 0)) - 1
            while lo >= 0:
                ioff, ipath, ipos = index[lo]
                if ioff < base:
                    break
                if ipath == path:
                    offset, seek_pos = ioff, ipos
                    break
                lo -= 1
            try:
                f = open(path, "rb")
            except FileNotFoundError:
                continue   # pruned between snapshot and open
            with f:
                f.seek(seek_pos)
                while True:
                    header = f.read(_HEADER.size)
                    if len(header) < _HEADER.size:
                        break
                    length, crc = _HEADER.unpack(header)
                    payload = f.read(length)
                    if len(payload) < length:
                        break
                    if zlib.crc32(payload) != crc:
                        raise CorruptJournal(f"{path} @ record {offset}")
                    if offset >= start:
                        if stop is not None and offset >= stop:
                            return
                        yield offset, payload
                    offset += 1


class JournalReader:
    """A named consumer with a committed offset (consumer-group analog).

    Commit semantics match the reference's manual Kafka commit: records are
    redelivered after a crash unless committed
    (``MicroserviceKafkaConsumer.java:94``) — at-least-once.
    """

    def __init__(self, journal: Journal, group: str):
        self.journal = journal
        self.group = group
        self._offset_path = os.path.join(journal.dir, f"{group}.offset")
        # Cached: the file changes only through this object's commit(), and
        # callers poll `committed` on every idle dispatch cycle.
        self._committed = self._load_committed()
        self.position = self._committed

    def _load_committed(self) -> int:
        try:
            with open(self._offset_path) as f:
                return int(f.read().strip() or 0)
        except FileNotFoundError:
            return 0

    @property
    def committed(self) -> int:
        return self._committed

    @property
    def lag(self) -> int:
        return self.journal.end_offset - self.position

    def poll(self, max_records: int) -> List[Tuple[int, bytes]]:
        """Fetch up to ``max_records`` from the current (uncommitted) position."""
        out = list(
            self.journal.scan(self.position, self.position + max_records)
        )
        if out:
            self.position = out[-1][0] + 1
        return out

    def commit(self, upto: Optional[int] = None) -> None:
        """Durably record progress (``upto`` = offset one past last processed)."""
        value = self.position if upto is None else upto
        tmp = f"{self._offset_path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(value))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._offset_path)
        self._committed = value

    def seek(self, offset: int) -> None:
        """Rewind/replay from an arbitrary offset (reprocess-topic analog,
        reference ``KafkaTopicNaming.java:172-174``)."""
        self.position = offset
