"""Segment catalog: the queryable manifest over sealed segments.

Counterpart of ``sitewhere_tpu/store/catalog.py``.  With parallel seal
workers, background compaction and retention all changing the segment
set, the catalog holds the invariants:

- the segment list stays sorted by ``order_key`` (seq for a freshly
  sealed segment, the minimum replaced seq for a compacted one), so
  scans stream rows in per-shard append order;
- retention goes through the catalog: only committed segments are
  prunable, so a retention pass never races a seal worker into a
  dangling entry;
- compaction swaps are atomic under the store lock, with provenance in
  the merged file (crash recovery) and in the live ``remap`` (old event
  ids keep resolving);
- the catalog snapshots as a checkpoint section
  (:func:`catalog_state_provider`), and restore cross-checks the
  manifest against the directory scan and reports the drift as the
  ``store.catalog_drift`` gauge.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

from sitewhere_tpu_torch.store.segment import (
    Segment,
    resolve_tombstones,
)

logger = logging.getLogger("sitewhere_tpu_torch.store.catalog")

CATALOG_SECTION = "store-catalog"
CATALOG_VERSION = 1


class SegmentCatalog:
    """Coordinator over the store's segment list.

    The list itself lives on the store (``store._chunks`` — shared with
    the inherited indexed-query machinery); the catalog owns every
    MUTATION of it plus the id remap, all under ``store._lock``.
    """

    def __init__(self, store):
        self._store = store
        # old_seq -> (segment, row_base, rows): event ids inside
        # compacted-away segments resolve through here
        self.remap: Dict[int, Tuple[Segment, int, int]] = {}
        #: manifest restored from the last checkpoint generation (set by
        #: the state provider's restore_fn; verification material)
        self.restored_manifest: Optional[dict] = None
        self.tombstones_resolved = 0

    # -- boot ----------------------------------------------------------------

    def adopt_loaded(self) -> None:
        """Reconcile the freshly scanned segment set: resolve compaction
        tombstones (a crash between the merged write and the input
        unlink leaves both on disk), rebuild the id remap, and restore
        scan order.  Runs once from ``SegmentStore.__init__`` — single
        threaded, no lock needed."""
        store = self._store
        live, dead = resolve_tombstones(store._chunks)
        for seg in dead:
            path = os.path.join(store.dir, f"events-{seg.seq:010d}.npz")
            try:
                os.unlink(path)
            except OSError:
                pass
            store._cache.drop_seq(seg.seq)
            self.tombstones_resolved += 1
            logger.info("segment %d tombstoned by a compacted successor; "
                        "removed", seg.seq)
        live.sort(key=lambda c: (c.order_key, c.seq))
        store._chunks[:] = live
        self._rebuild_remap_locked()

    def _rebuild_remap_locked(self) -> None:
        self.remap.clear()
        for seg in self._store._chunks:
            if seg.replaces:
                for src_seq, base, rows in seg.replaces:
                    self.remap[int(src_seq)] = (seg, int(base), int(rows))

    # -- mutation (all under store._lock) ------------------------------------

    def add_locked(self, seg: Segment) -> None:
        """Publish one sealed segment at its scan position (binary
        search over the already-sorted list — this runs under the
        contended store lock on every seal-worker commit)."""
        chunks = self._store._chunks
        key = (seg.order_key, seg.seq)
        lo, hi = 0, len(chunks)
        while lo < hi:
            mid = (lo + hi) // 2
            if (chunks[mid].order_key, chunks[mid].seq) < key:
                lo = mid + 1
            else:
                hi = mid
        chunks.insert(lo, seg)

    def swap_compacted_locked(self, inputs: List[Segment],
                              merged: Segment) -> bool:
        """Atomically replace ``inputs`` with ``merged``.  Returns False
        (caller discards the merged file) when any input is no longer
        listed — retention won the race, and resurrecting pruned rows
        through a merge would violate the retention contract."""
        chunks = self._store._chunks
        ids = {id(c) for c in inputs}
        if sum(1 for c in chunks if id(c) in ids) != len(inputs):
            return False
        chunks[:] = [c for c in chunks if id(c) not in ids]
        self.add_locked(merged)
        # re-point ids: merged.replaces carries the TRANSITIVE
        # provenance (the compactor folds each input's own replaces
        # in), so this single pass re-points every remap entry that
        # pointed at an input — direct or through an earlier merge
        if merged.replaces:
            for src_seq, base, rows in merged.replaces:
                self.remap[int(src_seq)] = (merged, int(base), int(rows))
        return True

    def prune_locked(self, cutoff_s: int) -> List[Segment]:
        """Select + delist whole segments whose NEWEST row predates
        ``cutoff_s``.  Only COMMITTED segments are candidates: a seal
        job still queued or mid-write is not in the catalog, so
        retention can never leave a worker publishing into a pruned
        entry or a catalog entry pointing at an unlinked file.
        Segments that are inputs of an in-flight compaction merge are
        skipped too — pruning one mid-merge and then crashing before
        the swap aborts would resurrect its rows through the merged
        file's provenance at the next boot.  The caller (the store)
        handles marker durability and file unlinking."""
        store = self._store
        compacting = getattr(store, "_compacting", ())
        doomed = [c for c in store._chunks
                  if c.n and c.max_ts < cutoff_s
                  and id(c) not in compacting]
        if not doomed:
            return []
        dead = {id(c) for c in doomed}
        store._chunks[:] = [c for c in store._chunks if id(c) not in dead]
        for seq in [s for s, (seg, _, _) in self.remap.items()
                    if id(seg) in dead]:
            del self.remap[seq]
        return doomed

    # -- lookup --------------------------------------------------------------

    def resolve_remapped(self, seq: int
                         ) -> Optional[Tuple[Segment, int, int]]:
        """(segment, row_base, rows) for a compacted-away seq."""
        with self._store._lock:
            return self.remap.get(int(seq))

    def rows(self) -> int:
        with self._store._lock:
            return sum(c.n for c in self._store._chunks)

    # -- consistency ---------------------------------------------------------

    def verify(self) -> List[str]:
        """Catalog/filesystem consistency check (crash harness + tests).

        Returns a list of problems (empty = consistent): every listed
        segment's file exists, no duplicate seqs, scan order sorted, no
        live segment is tombstoned by another live segment's
        provenance, and the remap only points at listed segments."""
        store = self._store
        problems: List[str] = []
        with store._lock:
            chunks = list(store._chunks)
            remap = dict(self.remap)
        seqs = [c.seq for c in chunks]
        if len(seqs) != len(set(seqs)):
            problems.append("duplicate segment seqs in the catalog")
        keys = [(c.order_key, c.seq) for c in chunks]
        if keys != sorted(keys):
            problems.append("catalog scan order is not sorted")
        live = set(seqs)
        for c in chunks:
            if c._path is not None and not os.path.exists(c._path):
                problems.append(f"segment {c.seq} file missing: {c._path}")
            if c.replaces:
                ghosts = [int(r[0]) for r in c.replaces if r[0] in live]
                if ghosts:
                    problems.append(
                        f"segment {c.seq} tombstones live segments "
                        f"{ghosts} (unresolved compaction)")
        listed = {id(c) for c in chunks}
        for seq, (seg, base, rows) in remap.items():
            if id(seg) not in listed:
                problems.append(
                    f"remap for old seq {seq} points at an unlisted "
                    "segment")
        return problems

    # -- checkpoint section --------------------------------------------------

    def snapshot(self) -> bytes:
        store = self._store
        with store._lock:
            doc = {
                "next_seq": int(store._next_seq),
                "segments": [
                    {
                        "seq": int(c.seq),
                        "order_key": int(c.order_key),
                        "shard": int(c.shard),
                        "shard_count": int(c.shard_count),
                        "n": int(c.n),
                        "min_ts": int(c.min_ts),
                        "max_ts": int(c.max_ts),
                    }
                    for c in store._chunks
                ],
            }
        return json.dumps(doc, separators=(",", ":")).encode()

    def note_restored(self, doc: dict) -> List[str]:
        """Cross-check a restored manifest against the live (directory-
        scanned) catalog.  The files are authoritative — segments seal
        and compact between checkpoint generations, so drift is
        EXPECTED; what drift must never show is a manifest segment that
        is neither live, tombstoned, nor pruned-by-retention while
        retention is off.  Returns the drift report (logged, exported
        as a gauge)."""
        self.restored_manifest = doc
        store = self._store
        with store._lock:
            live = {int(c.seq) for c in store._chunks}
            remapped = set(self.remap)
            next_seq = int(store._next_seq)
        # a segment retention legitimately pruned between the last
        # checkpoint and this boot is not drift — exempting it keeps
        # the gauge meaningful on retention-enabled stores
        cutoff = (int(time.time()) - store.retention_s
                  if getattr(store, "retention_s", 0) else None)
        drift: List[str] = []
        for ent in doc.get("segments", ()):
            seq = int(ent["seq"])
            if seq not in live and seq not in remapped:
                if (cutoff is not None
                        and int(ent.get("max_ts", 1 << 62)) < cutoff):
                    continue  # retention-expired, not lost
                drift.append(f"manifest segment {seq} not on disk")
        if int(doc.get("next_seq", 0)) > next_seq:
            drift.append(
                f"manifest next_seq {doc.get('next_seq')} leads the "
                f"recovered marker {next_seq}")
        for line in drift:
            logger.warning("store catalog drift: %s", line)
        return drift


def catalog_state_provider(store):
    """The catalog's checkpoint section: rides the CRC-framed,
    generation-committed snapshot protocol (runtime/checkpoint.py), so
    a restored boot can verify its rebuilt catalog against the last
    committed generation's view."""
    from sitewhere_tpu_torch.runtime.checkpoint import StateProvider

    def snapshot_fn():
        return store.catalog.snapshot(), None

    def restore_fn(header, payload):
        doc = json.loads(payload)
        drift = store.catalog.note_restored(doc)
        metrics = getattr(store, "metrics", None)
        if metrics is not None:
            metrics.gauge("store.catalog_drift").set(len(drift))

    return StateProvider(name=CATALOG_SECTION, snapshot_fn=snapshot_fn,
                         restore_fn=restore_fn, version=CATALOG_VERSION)


__all__ = ["SegmentCatalog", "catalog_state_provider", "CATALOG_SECTION",
           "CATALOG_VERSION"]
