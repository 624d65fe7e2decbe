"""Retrospective scan lane: stream sealed segments in scan order.

Counterpart of ``sitewhere_tpu/store/scan.py``: the oldest-first,
zone-map/Bloom-pruned, row-filtered column stream of
``SegmentStore.iter_chunks``, served from the segment catalog:

- **hot-tier fast path**: a segment resident in the hot tier yields its
  column dict as zero-copy views over the packed block;
- **promote-on-scan**: a demoted segment a selective scan materialized
  is re-packed into the tier (budget permitting);
- **packed scan** (:func:`scan_packed`): the raw ``([Ci, n] int32,
  [Cf, n] float32)`` block pairs, the form a batch is staged to the card
  in, so a retrospective query can copy a sealed segment over exactly as
  the live dispatcher stages a batch.

Segments stream in catalog scan order (``order_key``: append order,
stable under compaction), so per-device row order matches what live
evaluation saw.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from sitewhere_tpu_torch.store.segment import (
    BLOOM_COLUMNS,
    Segment,
    SegmentPruned,
    bloom_probe,
    pack_cols,
    segment_pruned,
    unpack_cols,
)


def _segment_cols(store, seg):
    """Materialize ``seg``'s columns, following the compaction remap if
    the file vanished mid-scan.

    A scan snapshots the segment list, and background compaction may
    swap snapshotted inputs for a merged segment (unlinking the input
    files) before the scan reaches them.  The merged segment is NOT in
    this scan's snapshot — treating the vanished input as "expired"
    would silently lose its rows, so they are served from the merged
    segment's recorded row range instead.  Returns ``(cols, remapped)``
    or ``(None, False)`` when the rows are genuinely gone (retention).
    """
    try:
        return seg.materialize(), False
    except SegmentPruned:
        entry = store.catalog.resolve_remapped(seg.seq)
        if entry is None:
            return None, False  # retention: the rows really expired
        merged, base, rows = entry
        try:
            cols = merged.materialize()
        except SegmentPruned:
            return None, False
        return {k: v[base:base + rows] for k, v in cols.items()}, True


def filters_active(event_type, mtype_id, device_id, tenant_id):
    return [
        (name, int(want))
        for name, want in (
            ("event_type", event_type), ("mtype_id", mtype_id),
            ("device_id", device_id), ("tenant_id", tenant_id))
        if want is not None
    ]


def row_mask(seg: Segment, cols: Dict[str, np.ndarray], active,
              start_s, end_s) -> Optional[np.ndarray]:
    """Row-filter mask (None = every row passes) — the legacy scan's
    rule: time masks only when the segment STRADDLES a bound."""
    mask = None
    for name, want in active:
        m = cols[name] == want
        mask = m if mask is None else (mask & m)
    if start_s is not None and seg.min_ts < start_s:
        m = cols["ts_s"] >= start_s
        mask = m if mask is None else (mask & m)
    if end_s is not None and seg.max_ts > end_s:
        m = cols["ts_s"] <= end_s
        mask = m if mask is None else (mask & m)
    return mask


def iter_segment_cols(
    store,
    *,
    event_type: Optional[int] = None,
    mtype_id: Optional[int] = None,
    device_id: Optional[int] = None,
    tenant_id: Optional[int] = None,
    start_s: Optional[int] = None,
    end_s: Optional[int] = None,
    promote: bool = True,
    stats: Optional[Dict[str, int]] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Pruned, row-filtered column dicts in scan order (the
    ``iter_chunks`` contract, catalog edition).  The caller has already
    flushed, so every row lives in a committed segment.

    ``stats`` (optional dict) collects THIS scan's accounting —
    ``segments_scanned`` / ``segments_pruned`` / ``hot_tier_hits`` —
    so a caller can report per-query numbers without racing other
    scans on the shared ``store.scan_*`` counters."""
    with store._lock:
        segments = list(store._chunks)
    active = filters_active(event_type, mtype_id, device_id, tenant_id)
    probes = {
        name: bloom_probe(want) for name, want in active
        if name in BLOOM_COLUMNS
    }
    if stats is not None:
        stats.setdefault("segments_scanned", 0)
        stats.setdefault("segments_pruned", 0)
        stats.setdefault("hot_tier_hits", 0)
    m_rows = store.metrics.counter("store.scan_rows")
    m_hot = store.metrics.counter("store.scan_hot_hits")
    m_pruned = store.metrics.counter("store.scan_pruned")
    for seg in segments:
        if segment_pruned(seg, active, probes, start_s, end_s):
            m_pruned.inc()
            if stats is not None:
                stats["segments_pruned"] += 1
            continue
        pair = store.hot.get(seg.seq)
        if pair is not None:
            cols = unpack_cols(pair[0], pair[1])
            m_hot.inc()
            if stats is not None:
                stats["hot_tier_hits"] += 1
        else:
            cols, remapped = _segment_cols(store, seg)
            if cols is None:
                continue  # retention expired it mid-scan
            # promote-on-scan only for SELECTIVE scans: an unfiltered
            # whole-history pass would cycle the byte-bounded LRU and
            # evict the recently sealed live window for blocks no
            # windowed query is likely to re-ask for
            selective = bool(active) or start_s is not None \
                or end_s is not None
            if promote and selective and not remapped:
                store.hot.promote(seg, cols)
        if stats is not None:
            stats["segments_scanned"] += 1
        mask = row_mask(seg, cols, active, start_s, end_s)
        if mask is None or mask.all():
            m_rows.inc(seg.n)
            yield cols
        elif mask.any():
            m_rows.inc(int(mask.sum()))
            yield {k: v[mask] for k, v in cols.items()}


def scan_packed(
    store,
    *,
    event_type: Optional[int] = None,
    mtype_id: Optional[int] = None,
    device_id: Optional[int] = None,
    tenant_id: Optional[int] = None,
    start_s: Optional[int] = None,
    end_s: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray, Segment]]:
    """Pruned segments as packed ``(ints, flts, segment)`` blocks, the
    staging form.  A hot segment no row filter touches yields its
    resident block as is (no copy); a filtered or cold segment is packed
    on the fly from the rows that survive the filters only."""
    store.flush()
    with store._lock:
        segments = list(store._chunks)
    active = filters_active(event_type, mtype_id, device_id, tenant_id)
    probes = {
        name: bloom_probe(want) for name, want in active
        if name in BLOOM_COLUMNS
    }
    for seg in segments:
        if segment_pruned(seg, active, probes, start_s, end_s):
            continue
        pair = store.hot.get(seg.seq)
        if pair is not None:
            cols = unpack_cols(pair[0], pair[1])
        else:
            cols, _remapped = _segment_cols(store, seg)
            if cols is None:
                continue  # retention expired it mid-scan
        mask = row_mask(seg, cols, active, start_s, end_s)
        if mask is None or mask.all():
            if pair is not None:
                yield pair[0], pair[1], seg
            else:
                ints, flts = pack_cols(cols)
                yield ints, flts, seg
        elif mask.any():
            ints, flts = pack_cols({k: v[mask] for k, v in cols.items()})
            yield ints, flts, seg


__all__ = ["iter_segment_cols", "scan_packed", "filters_active", "row_mask"]
