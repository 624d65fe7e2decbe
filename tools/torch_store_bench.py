#!/usr/bin/env python
"""Segment-store benchmark of the PyTorch port: seal throughput +
retrospective scan lane.

Counterpart of ``tools/store_bench.py`` over ``sitewhere_tpu_torch.store``.
The segment store is host code (numpy columns, segment files and their
catalog), so the bench takes no device.  Two phases, matching the
segment store's two claims:

1. **seal** — sustained ``append_columns`` throughput into the sharded
   segment store with the background worker pool live, vs the legacy
   single-writer ``EventStore``.  The number that matters is the
   PERCEIVED per-batch append cost (the hot path's whole seal bill:
   shard-routed packed row copy + O(1) job enqueue) next to the
   measured background seal time per segment (``store.seal_s``).

2. **retro** — a retrospective windowed query over the stored history,
   two ways over the SAME segment files:

   - *legacy row scan*: materialize every segment's columns from disk
     and row-filter — the pre-catalog behavior (no zone-map/Bloom
     segment pruning, no hot tier);
   - *scan lane*: ``SegmentStore.iter_chunks`` — catalog-pruned,
     hot-tier-served, the same packed pipeline the live path feeds.

   Results must be BIT-IDENTICAL (every column compared, after a
   canonical row sort — catalog scan order interleaves shards
   differently than raw seq order, which is immaterial to a windowed
   query's result set).

Usage::

    python tools/torch_store_bench.py                  # 10M rows
    python tools/torch_store_bench.py --rows 2000000
    python tools/torch_store_bench.py --smoke          # ~100k rows
    python tools/torch_store_bench.py --json out.json

Exit status 0 = ran + bit-identical; 1 = result divergence.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

T0 = 1_754_000_000
N_DEVICES = 512
N_TENANTS = 4


def _batch(lo: int, n: int, rng: np.random.Generator) -> dict:
    """One append batch of n rows, event time increasing with index."""
    from sitewhere_tpu_torch.ids import NULL_ID

    dev = rng.integers(0, N_DEVICES, n, dtype=np.int64).astype(np.int32)
    return {
        "device_id": dev,
        "tenant_id": (dev % N_TENANTS).astype(np.int32),
        "event_type": (rng.random(n) < 0.9).astype(np.int32),
        "ts_s": (T0 + (lo + np.arange(n)) // 100).astype(np.int32),
        "ts_ns": ((lo + np.arange(n)) % 100).astype(np.int32) * 1000,
        "mtype_id": (dev % 4).astype(np.int32),
        "value": rng.random(n).astype(np.float32) * 100.0,
        "lat": np.zeros(n, np.float32),
        "lon": np.zeros(n, np.float32),
        "elevation": np.zeros(n, np.float32),
        "alert_code": np.full(n, NULL_ID, np.int32),
        "alert_level": np.zeros(n, np.int32),
        "command_id": np.full(n, NULL_ID, np.int32),
        "payload_ref": np.full(n, NULL_ID, np.int32),
        "device_type_id": np.zeros(n, np.int32),
        "assignment_id": dev,
        "area_id": np.zeros(n, np.int32),
        "customer_id": np.zeros(n, np.int32),
        "asset_id": np.zeros(n, np.int32),
    }


def _fill(store, rows: int, batch_rows: int, seed: int = 7,
          append_samples: list | None = None) -> float:
    """Append ``rows`` rows; returns wall seconds to fully durable.
    ``append_samples`` (optional) collects per-append wall seconds —
    the PERCEIVED ingest cost, where "gated on seal" shows up as p99
    spikes."""
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    lo = 0
    while lo < rows:
        n = min(batch_rows, rows - lo)
        batch = _batch(lo, n, rng)
        ta = time.perf_counter()
        store.append_columns(batch)
        if append_samples is not None:
            append_samples.append(time.perf_counter() - ta)
        lo += n
    store.flush(sync=True)
    return time.perf_counter() - t0


def _pctl(samples: list, q: float) -> float:
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[min(len(s) - 1, int(q * len(s)))]


def _row_key(cols: dict) -> np.ndarray:
    """Canonical sort order for result comparison (time, then device,
    then sub-second) — windowed-query results are row SETS; scan order
    across shards is an implementation detail."""
    return np.lexsort((cols["ts_ns"], cols["device_id"],
                       cols["ts_s"]))


def _concat(parts: list) -> dict:
    from sitewhere_tpu_torch.store.segment import COLUMN_NAMES

    if not parts:
        return {name: np.zeros(0, np.int32) for name in COLUMN_NAMES}
    return {name: np.concatenate([p[name] for p in parts])
            for name in COLUMN_NAMES}


def _legacy_row_scan(store, **filters) -> list:
    """The pre-catalog retrospective path: EVERY segment's columns come
    off disk and every row is mask-filtered — no zone-map/Bloom segment
    pruning, no hot tier.  (This is what ``iter_chunks`` did before the
    segment catalog, modulo the time-bound chunk skip it shared with
    the query path — withheld here to represent the plain row scan the
    H-STREAM comparison argues against.)"""
    from sitewhere_tpu_torch.store.segment import SegmentPruned

    store.flush()
    with store._lock:
        segments = list(store._chunks)
    out = []
    for seg in segments:
        try:
            cols = seg.materialize()
        except SegmentPruned:
            continue
        mask = np.ones(seg.n, bool)
        for name in ("event_type", "mtype_id", "device_id", "tenant_id"):
            want = filters.get(name)
            if want is not None:
                mask &= cols[name] == want
        if filters.get("start_s") is not None:
            mask &= cols["ts_s"] >= filters["start_s"]
        if filters.get("end_s") is not None:
            mask &= cols["ts_s"] <= filters["end_s"]
        if mask.all():
            out.append(cols)
        elif mask.any():
            out.append({k: v[mask] for k, v in cols.items()})
    return out


def _bit_identical(a: dict, b: dict) -> bool:
    from sitewhere_tpu_torch.store.segment import COLUMN_NAMES

    if len(a["ts_s"]) != len(b["ts_s"]):
        return False
    ia, ib = _row_key(a), _row_key(b)
    return all(np.array_equal(a[name][ia], b[name][ib])
               for name in COLUMN_NAMES)


def run(rows: int = 10_000_000, batch_rows: int = 65_536,
        flush_rows: int = 65_536, seal_workers: int = 2,
        n_shards: int = 4, keep_dir: str | None = None) -> dict:
    from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry
    from sitewhere_tpu_torch.services.event_store import EventStore
    from sitewhere_tpu_torch.store.segmented import SegmentStore

    results: dict = {"rows": rows, "batch_rows": batch_rows,
                     "flush_rows": flush_rows,
                     "seal_workers": seal_workers, "n_shards": n_shards}
    root = keep_dir or tempfile.mkdtemp(prefix="store-bench-")
    try:
        # -- phase 1: seal throughput ------------------------------------
        seal_rows = min(rows, 2_000_000)
        legacy = EventStore(os.path.join(root, "legacy-seal"),
                            flush_rows=flush_rows)
        legacy.start()
        legacy_appends: list = []
        try:
            dt = _fill(legacy, seal_rows, batch_rows,
                       append_samples=legacy_appends)
        finally:
            legacy.stop()
        results["seal_rows"] = seal_rows
        results["legacy_seal_s"] = dt
        results["legacy_seal_rows_per_s"] = seal_rows / dt
        results["legacy_append_p50_s"] = _pctl(legacy_appends, 0.50)
        results["legacy_append_p99_s"] = _pctl(legacy_appends, 0.99)

        metrics = MetricsRegistry()
        seg = SegmentStore(os.path.join(root, "segmented-seal"),
                           flush_rows=flush_rows, n_shards=n_shards,
                           seal_workers=seal_workers,
                           compact_interval_s=0.0, metrics=metrics)
        seg.sealer.start()
        seg_appends: list = []
        try:
            dt = _fill(seg, seal_rows, batch_rows,
                       append_samples=seg_appends)
        finally:
            seg.sealer.stop()
        results["store_seal_s"] = dt
        results["store_seal_rows_per_s"] = seal_rows / dt
        results["store_append_p50_s"] = _pctl(seg_appends, 0.50)
        results["store_append_p99_s"] = _pctl(seg_appends, 0.99)
        hist = metrics.histogram("store.seal_s")
        results["store_seal_bg_s_per_segment"] = (
            hist.total / hist.count if hist.count else 0.0)
        results["store_seal_segments"] = int(hist.count)
        results["seal_speedup"] = (results["store_seal_rows_per_s"]
                                   / results["legacy_seal_rows_per_s"])
        results["append_p99_speedup"] = (
            results["legacy_append_p99_s"]
            / results["store_append_p99_s"]
            if results["store_append_p99_s"] else 0.0)

        # -- phase 2: retrospective windowed query -----------------------
        data_dir = os.path.join(root, "retro")
        metrics2 = MetricsRegistry()
        store = SegmentStore(data_dir, flush_rows=flush_rows,
                             n_shards=n_shards, seal_workers=seal_workers,
                             compact_interval_s=0.0, metrics=metrics2)
        store.sealer.start()
        try:
            results["retro_fill_s"] = _fill(store, rows, batch_rows)
        finally:
            store.sealer.stop()

        # the window: the central ~1% of event time, measurements only —
        # a "what happened around the incident" retrospective query
        # (the 100 h slice of a ~1-year history)
        span = rows // 100
        mid = T0 + (rows // 100) // 2
        filters = {"event_type": 1, "start_s": int(mid - span // 200),
                   "end_s": int(mid + span // 200)}
        results["retro_filters"] = dict(filters)

        # legacy pass on a COLD store instance (empty column cache)
        cold = SegmentStore(data_dir, flush_rows=flush_rows,
                            n_shards=n_shards, seal_workers=seal_workers,
                            compact_interval_s=0.0,
                            metrics=MetricsRegistry())
        t0 = time.perf_counter()
        legacy_parts = _legacy_row_scan(cold, **filters)
        legacy_dt = time.perf_counter() - t0
        legacy_res = _concat(legacy_parts)

        # scan lane on a second cold instance (fair: same cache state)
        lane_metrics = MetricsRegistry()
        lane = SegmentStore(data_dir, flush_rows=flush_rows,
                            n_shards=n_shards, seal_workers=seal_workers,
                            compact_interval_s=0.0, metrics=lane_metrics)
        t0 = time.perf_counter()
        lane_parts = list(lane.iter_chunks(**filters))
        lane_dt = time.perf_counter() - t0
        lane_res = _concat(lane_parts)

        n_match = int(len(lane_res["ts_s"]))
        results["retro_matched_rows"] = n_match
        results["retro_legacy_scan_s"] = legacy_dt
        results["retro_lane_scan_s"] = lane_dt
        results["retro_legacy_events_per_s"] = rows / legacy_dt
        results["retro_lane_events_per_s"] = rows / lane_dt
        results["retro_speedup"] = legacy_dt / lane_dt if lane_dt else 0.0
        results["retro_segments_pruned"] = int(
            lane_metrics.counter("store.scan_pruned").value)
        results["retro_hot_hits"] = int(
            lane_metrics.counter("store.scan_hot_hits").value)
        results["bit_identical"] = _bit_identical(legacy_res, lane_res)

        # a second lane pass: promote-on-scan has heated the window
        t0 = time.perf_counter()
        for _ in lane.iter_chunks(**filters):
            pass
        results["retro_lane_warm_s"] = time.perf_counter() - t0
    finally:
        if keep_dir is None:
            shutil.rmtree(root, ignore_errors=True)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="segment-store seal + retrospective-scan benchmark")
    parser.add_argument("--rows", type=int, default=10_000_000)
    parser.add_argument("--batch-rows", type=int, default=65_536)
    parser.add_argument("--flush-rows", type=int, default=65_536)
    parser.add_argument("--seal-workers", type=int, default=2)
    parser.add_argument("--shards", type=int, default=4)
    parser.add_argument("--smoke", action="store_true",
                        help="CI scale: ~100k rows")
    parser.add_argument("--json", dest="json_out")
    args = parser.parse_args(argv)

    rows = 100_000 if args.smoke else args.rows
    flush_rows = 8_192 if args.smoke else args.flush_rows
    batch_rows = min(args.batch_rows, flush_rows)
    r = run(rows=rows, batch_rows=batch_rows, flush_rows=flush_rows,
            seal_workers=args.seal_workers, n_shards=args.shards)
    print(f"seal ({r['seal_rows']:,} rows): "
          f"legacy {r['legacy_seal_rows_per_s']:,.0f} rows/s | "
          f"segmented {r['store_seal_rows_per_s']:,.0f} rows/s "
          f"({r['seal_speedup']:.2f}x; background "
          f"{r['store_seal_bg_s_per_segment'] * 1e3:.1f} ms/segment "
          f"x {r['store_seal_segments']} segments)")
    print(f"  perceived append (ingest gated on seal?): legacy "
          f"p50 {r['legacy_append_p50_s'] * 1e3:.2f} / p99 "
          f"{r['legacy_append_p99_s'] * 1e3:.2f} ms | segmented "
          f"p50 {r['store_append_p50_s'] * 1e3:.2f} / p99 "
          f"{r['store_append_p99_s'] * 1e3:.2f} ms "
          f"({r['append_p99_speedup']:.1f}x at p99)")
    print(f"retro ({r['rows']:,} rows, {r['retro_matched_rows']:,} "
          f"matched): legacy row scan {r['retro_legacy_scan_s']:.3f} s "
          f"({r['retro_legacy_events_per_s']:,.0f} events/s) | scan "
          f"lane {r['retro_lane_scan_s']:.3f} s "
          f"({r['retro_lane_events_per_s']:,.0f} events/s) -> "
          f"{r['retro_speedup']:.1f}x  "
          f"[{r['retro_segments_pruned']} segments pruned, warm rescan "
          f"{r['retro_lane_warm_s']:.3f} s]")
    print(f"bit-identical: {r['bit_identical']}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(r, f, indent=2)
    return 0 if r["bit_identical"] else 1


if __name__ == "__main__":
    sys.exit(main())
