"""Hot tier: recent segments retained in packed-column form.

Counterpart of ``sitewhere_tpu/store/tiering.py``.  Sealed segments are
durable as npz files; the hot tier also keeps the most recently sealed
or scanned segments resident as the packed ``([Ci, n] int32, [Cf, n]
float32)`` block pair, so the scan lane serves their column views with
no file IO and no pivot.

- **adopt**: a seal worker hands the freshly written segment's packed
  block over from the shard buffer (one copy, off the hot path);
- **demote**: byte-budget LRU eviction drops the packed copy and the
  segment falls back to the column cache and its file;
- **promote**: a scan that touches a demoted segment re-packs it.

A demotion and promotion round trip is bit-identical by construction.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Dict, Optional, Tuple

import numpy as np

from sitewhere_tpu_torch.store.segment import COLUMN_NAMES, Segment, pack_cols

_BlockPair = Tuple[np.ndarray, np.ndarray]

# bytes per packed row, derived from the schema (every column is a
# 4-byte int32/float32) — never a hand-maintained constant
_ROW_BYTES = 4 * len(COLUMN_NAMES)


class HotTier:
    """Byte-bounded LRU of packed segment blocks."""

    def __init__(self, max_bytes: int, metrics=None):
        self.max_bytes = int(max_bytes)
        self._od: "OrderedDict[int, _BlockPair]" = OrderedDict()
        # dropped seqs (retention/compaction removed the segment):
        # refuses a promote() racing drop() — a scan that materialized
        # the segment just before it was delisted would otherwise park
        # a dead block at the MRU end, evicting live segments.  Seqs
        # never recycle, so only RECENT tombstones matter (FIFO bound,
        # mirroring ColumnCache._dead).
        self._dead: set = set()
        self._dead_order: "deque" = deque()
        self._lock = threading.Lock()
        self.bytes = 0
        self.adoptions = 0
        self.promotions = 0
        self.demotions = 0
        self.hits = 0
        self._m_promote = self._m_demote = None
        if metrics is not None:
            self._m_promote = metrics.counter("store.tier_promotions")
            self._m_demote = metrics.counter("store.tier_demotions")

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def adopt(self, seq: int, ints: np.ndarray, flts: np.ndarray,
              n: int) -> None:
        """Copy one packed block into the tier (seal-worker hand-off —
        the source views belong to a shard buffer about to recycle)."""
        if self.max_bytes <= 0:
            return
        self._put(seq, ints[:, :n].copy(), flts[:, :n].copy())
        self.adoptions += 1

    def promote(self, seg: Segment, cols: Dict[str, np.ndarray]) -> bool:
        """Re-pack a demoted segment from materialized columns (scan
        re-heat).  Refused when the block alone would blow the budget."""
        if self.max_bytes <= 0:
            return False
        nbytes = seg.n * _ROW_BYTES
        if nbytes > self.max_bytes:
            return False
        ints, flts = pack_cols(cols)
        self._put(seg.seq, ints, flts)
        self.promotions += 1
        if self._m_promote is not None:
            self._m_promote.inc()
        return True

    def _put(self, seq: int, ints: np.ndarray, flts: np.ndarray) -> None:
        with self._lock:
            if seq in self._dead:
                return
            old = self._od.pop(seq, None)
            if old is not None:
                self.bytes -= old[0].nbytes + old[1].nbytes
            self._od[seq] = (ints, flts)
            self.bytes += ints.nbytes + flts.nbytes
            while self.bytes > self.max_bytes and len(self._od) > 1:
                _, (oi, of) = self._od.popitem(last=False)
                self.bytes -= oi.nbytes + of.nbytes
                self.demotions += 1
                if self._m_demote is not None:
                    self._m_demote.inc()

    def get(self, seq: int) -> Optional[_BlockPair]:
        """The packed block for a hot segment (LRU touch), else None —
        the caller falls through to the column cache / file."""
        with self._lock:
            pair = self._od.get(seq)
            if pair is not None:
                self._od.move_to_end(seq)
                self.hits += 1
            return pair

    def drop(self, seq: int) -> None:
        """Retention/compaction removed the segment — a demotion with
        no file left behind (and a tombstone so a racing promote
        can't resurrect the block)."""
        with self._lock:
            if seq not in self._dead:
                self._dead.add(seq)
                self._dead_order.append(seq)
                while len(self._dead_order) > 1024:
                    self._dead.discard(self._dead_order.popleft())
            pair = self._od.pop(seq, None)
            if pair is not None:
                self.bytes -= pair[0].nbytes + pair[1].nbytes

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "segments": len(self._od),
                "bytes": self.bytes,
                "max_bytes": self.max_bytes,
                "adoptions": self.adoptions,
                "promotions": self.promotions,
                "demotions": self.demotions,
                "hits": self.hits,
            }


__all__ = ["HotTier"]
