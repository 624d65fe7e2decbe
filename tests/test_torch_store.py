"""The port's segment store against the JAX package's, on the CPU.

The same seeded columns go through both packages' store modules:
``pack_cols`` / ``unpack_cols``, ``write_segment_file`` / ``open_segment``
(each package opens the other's file), the Bloom and zone-map pruning
predicate, the scan lane's filters, seal and compaction through
``SegmentStore``, retention, newest-first paging and the dead-letter path
of a terminal seal failure.  A store directory written by each package
is opened by the other and yields the same rows.  Last, the dispatcher
parity of ``tests/test_torch_dispatcher.py`` with a real
``SegmentStore`` on both sides: the same NDJSON through both
dispatchers, and the stored rows equal column by column (ints exact,
floats bitwise).  The receive-time column is stamped from one fixed
clock in both.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from sitewhere_tpu.services import event_store as ref_es
from sitewhere_tpu.store import scan as ref_scan
from sitewhere_tpu.store import segment as ref_seg
from sitewhere_tpu.store.segmented import SegmentStore as RefStore
from sitewhere_tpu_torch.runtime import faults
from sitewhere_tpu_torch.services import event_store as port_es
from sitewhere_tpu_torch.store import scan as port_scan
from sitewhere_tpu_torch.store import segment as port_seg
from sitewhere_tpu_torch.store.segmented import SegmentStore as PortStore
from torch_parity import WIRE_TS0_MS, wire_payload, wire_world

torch.set_num_threads(1)

SEED = 20261016
NOW_S = 1_760_000_000
STORES = {"jax": RefStore, "torch": PortStore}
SEGS = {"jax": ref_seg, "torch": port_seg}


@pytest.fixture(autouse=True)
def fixed_clock(monkeypatch):
    """One receive time for every appended row, in both packages."""
    monkeypatch.setattr(time, "time", lambda: float(NOW_S))


def make_cols(rng, n, devices=200, ts0=1_700_000_000):
    """``n`` stored rows with every column of the schema."""
    cols = {}
    for name, dtype in port_seg.COLUMNS:
        if dtype is np.float32:
            cols[name] = rng.normal(0, 50, n).astype(np.float32)
        else:
            cols[name] = rng.integers(-1, 40, n).astype(np.int32)
    cols["device_id"] = rng.integers(0, devices, n).astype(np.int32)
    cols["tenant_id"] = rng.integers(0, 3, n).astype(np.int32)
    cols["event_type"] = rng.integers(0, 3, n).astype(np.int32)
    cols["ts_s"] = (ts0 + rng.integers(0, 10_000, n)).astype(np.int32)
    cols["ts_ns"] = rng.integers(0, 10**9, n).astype(np.int32)
    cols["received_s"] = np.full(n, NOW_S, np.int32)
    return cols


def assert_cols_equal(a, b, names=None):
    names = names or port_seg.COLUMN_NAMES
    for name in names:
        x, y = np.asarray(a[name]), np.asarray(b[name])
        assert x.dtype == y.dtype, name
        assert x.tobytes() == y.tobytes(), name


def stored_rows(store):
    """Every stored row, concatenated in scan order."""
    chunks = list(store.iter_chunks())
    if not chunks:
        return {n: np.zeros(0) for n in port_seg.COLUMN_NAMES}
    return {n: np.concatenate([np.asarray(c[n]) for c in chunks])
            for n in port_seg.COLUMN_NAMES}


# -- the format ---------------------------------------------------------------


def test_schema_and_layout_match_the_reference():
    for name in ("COLUMNS", "INT_COLUMNS", "FLOAT_COLUMNS", "FILTER_COLUMNS",
                 "BLOOM_COLUMNS", "BLOOM_BITS", "ROW_BITS", "NULL_SHARD",
                 "META_CORE", "META_BOUNDS", "META_SHARD", "META_REPLACES",
                 "META_VERSION"):
        assert getattr(port_seg, name) == getattr(ref_seg, name), name


@pytest.mark.parametrize("n", [0, 1, 777])
def test_pack_unpack_cols(n):
    cols = make_cols(np.random.default_rng(SEED + n), n)
    ri, rf = ref_seg.pack_cols(cols)
    pi, pf = port_seg.pack_cols(cols)
    assert ri.tobytes() == pi.tobytes() and rf.tobytes() == pf.tobytes()
    assert ri.dtype == pi.dtype and rf.dtype == pf.dtype
    assert_cols_equal(ref_seg.unpack_cols(ri, rf), port_seg.unpack_cols(pi, pf))
    assert_cols_equal(cols, port_seg.unpack_cols(pi, pf))


@pytest.mark.parametrize("eid", [0, 1, (5 << 24) | 77, (1 << 40) | 3])
def test_event_ids(eid):
    assert port_seg.split_event_id(eid) == ref_seg.split_event_id(eid)
    seq, row = port_seg.split_event_id(eid)
    assert port_seg.event_id(seq, row) == ref_seg.event_id(seq, row) == eid


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
@pytest.mark.parametrize("replaces", [False, True])
def test_segment_file_opens_in_the_other_package(tmp_path, writer, reader,
                                                  replaces):
    cols = make_cols(np.random.default_rng(SEED), 1500)
    w, r = SEGS[writer], SEGS[reader]
    seg = w.Segment(7, cols, shard=2, shard_count=4)
    if replaces:
        seg.replaces = ((3, 0, 700), (4, 700, 800))
    path = str(tmp_path / "events-0000000007.npz")
    w.write_segment_file(path, cols, seg)
    got = r.open_segment(7, path, r.ColumnCache(1 << 20))
    assert (got.n, got.min_ts, got.max_ts) == (seg.n, seg.min_ts, seg.max_ts)
    assert got.bounds == seg.bounds
    assert (got.shard, got.shard_count) == (2, 4)
    assert got.replaces == (seg.replaces if replaces else None)
    assert got.order_key == (3 if replaces else 7)
    for name in w.BLOOM_COLUMNS:
        assert got.blooms[name].tobytes() == seg.blooms[name].tobytes()
    assert_cols_equal(got.materialize(), cols)
    # the same metadata whichever package computed it
    other = r.Segment(7, cols)
    assert other.bounds == seg.bounds
    for name in w.BLOOM_COLUMNS:
        assert other.blooms[name].tobytes() == seg.blooms[name].tobytes()


@pytest.mark.parametrize("column", ["device_id", "assignment_id", "tenant_id",
                                    "event_type", "mtype_id"])
def test_pruning_predicate_matches_the_reference(column):
    rng = np.random.default_rng(SEED + 3)
    cols = make_cols(rng, 400, devices=5000)
    segs = {pkg: SEGS[pkg].Segment(1, cols) for pkg in SEGS}
    t_lo, t_hi = int(cols["ts_s"].min()), int(cols["ts_s"].max())
    pruned_any = kept_any = False
    for want in list(range(-3, 60)) + [4000, 4999, 10**6]:
        for t0, t1 in ((None, None), (t_hi + 1, None), (None, t_lo - 1),
                       (t_lo, t_hi)):
            out = []
            for pkg, seg in segs.items():
                mod = SEGS[pkg]
                active = [(column, want)]
                probes = ({column: mod.bloom_probe(want)}
                          if column in mod.BLOOM_COLUMNS else {})
                out.append(mod.segment_pruned(seg, active, probes, t0, t1))
            assert out[0] == out[1], (want, t0, t1)
            # never a false negative: a present key is never pruned
            if want in set(cols[column].tolist()) and t0 is None \
                    and t1 is None:
                assert not out[1]
            pruned_any |= out[1]
            kept_any |= not out[1]
    assert pruned_any and kept_any


@pytest.mark.parametrize("filters", [
    {}, {"device_id": 7}, {"event_type": 1, "tenant_id": 2},
    {"mtype_id": 3, "start_s": 1_700_003_000},
    {"end_s": 1_700_004_000}, {"start_s": 1_700_002_000,
                               "end_s": 1_700_008_000, "tenant_id": 0},
])
def test_scan_filters_match_the_reference(filters):
    cols = make_cols(np.random.default_rng(SEED + 4), 600, devices=20)
    keys = ("event_type", "mtype_id", "device_id", "tenant_id")
    args = [filters.get(k) for k in keys]
    active = port_scan.filters_active(*args)
    assert active == ref_scan.filters_active(*args)
    start, end = filters.get("start_s"), filters.get("end_s")
    masks = [mod.row_mask(SEGS[pkg].Segment(0, cols), cols, active, start,
                          end)
             for pkg, mod in (("jax", ref_scan), ("torch", port_scan))]
    if masks[0] is None:
        assert masks[1] is None and not filters
    else:
        np.testing.assert_array_equal(masks[0], masks[1])


# -- the store ------------------------------------------------------------------


def fill_store(cls, root, batches, **kw):
    """A store over ``root`` fed ``batches`` of (cols, mask), flushed,
    compacted until quiescent, flushed again."""
    store = cls(str(root), flush_rows=kw.pop("flush_rows", 120),
                n_shards=kw.pop("n_shards", 4), hot_bytes=1 << 16,
                compact_min_rows=kw.pop("compact_min_rows", 400),
                compact_interval_s=0, **kw)
    for cols, mask in batches:
        store.append_columns(cols, mask=mask)
    store.flush()
    merged = store.compactor.drain()
    store.flush()
    return store, merged


def seeded_batches(seed=SEED, n=6):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cols = make_cols(rng, int(rng.integers(50, 400)), devices=300)
        mask = rng.random(len(cols["ts_s"])) < 0.8 if i % 2 else None
        out.append((cols, mask))
    return out


@pytest.fixture(scope="module")
def batches():
    return seeded_batches()


@pytest.mark.parametrize("n_shards", [1, 4])
def test_seal_and_compaction_match_the_reference(tmp_path, batches,
                                                 monkeypatch, n_shards):
    monkeypatch.setattr(time, "time", lambda: float(NOW_S))
    stores = {}
    for pkg, cls in STORES.items():
        stores[pkg] = fill_store(cls, tmp_path / pkg, batches,
                                 n_shards=n_shards)
    (ref, ref_merged), (got, got_merged) = stores["jax"], stores["torch"]
    assert got_merged == ref_merged > 0
    assert got.store_stats()["segments"] == ref.store_stats()["segments"]
    assert got.verify_catalog() == ref.verify_catalog() == []
    assert_cols_equal(stored_rows(ref), stored_rows(got))
    expected = sum(int(m.sum()) if m is not None else len(c["ts_s"])
                   for c, m in batches)
    assert got.total_events == expected
    # the same files on disk, byte for byte
    names = sorted(os.listdir(got.dir))
    assert names == sorted(os.listdir(ref.dir))
    for name in names:
        if name.endswith(".npz"):
            a = np.load(os.path.join(ref.dir, name))
            b = np.load(os.path.join(got.dir, name))
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].tobytes() == b[k].tobytes(), (name, k)
    for s in (ref, got):
        s.sealer.stop()


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_store_directory_opens_in_the_other_package(tmp_path, batches,
                                                    writer, reader):
    store, merged = fill_store(STORES[writer], tmp_path, batches)
    assert merged > 0
    rows = stored_rows(store)
    ids = [r.event_id for r in store.query(
        ref_es.SearchCriteria(page_size=0)).results]
    store.sealer.stop()
    other = STORES[reader](str(tmp_path), flush_rows=120, n_shards=4,
                           compact_interval_s=0)
    try:
        assert other.verify_catalog() == []
        assert_cols_equal(stored_rows(other), rows)
        got = other.query(ref_es.SearchCriteria(page_size=0)).results
        assert [r.event_id for r in got] == ids
        # an id survives compaction through the recorded provenance
        seg = other._chunks[0]
        rec = other.get_event(port_seg.event_id(seg.seq, 0))
        assert rec.ts_s == int(np.asarray(seg.col("ts_s"))[0])
    finally:
        other.sealer.stop()


@pytest.mark.parametrize("criteria,filters", [
    ({"page": 1, "page_size": 25}, {}),
    ({"page": 3, "page_size": 40}, {"tenant_id": 1}),
    ({"page": 1, "page_size": 10, "start_s": 1_700_004_000}, {"device_id": 5}),
    ({"page": 2, "page_size": 7, "end_s": 1_700_006_000},
     {"event_type": 2, "mtype_id": 3}),
])
def test_newest_first_paging_matches_the_reference(tmp_path, batches,
                                                   criteria, filters):
    results = []
    for pkg, cls in STORES.items():
        store, _ = fill_store(cls, tmp_path / pkg, batches)
        crit = (ref_es if pkg == "jax" else port_es).SearchCriteria(
            **criteria)
        page = store.query(crit, **filters)
        results.append((page.total, [dataclass_tuple(r) for r in page]))
        store.sealer.stop()
    assert results[0] == results[1]
    assert results[1][0] > 0


def dataclass_tuple(rec):
    return tuple(getattr(rec, f) for f in rec.__dataclass_fields__)


def test_retention_prunes_like_the_reference(tmp_path, batches):
    out = []
    for pkg, cls in STORES.items():
        store, _ = fill_store(cls, tmp_path / pkg, batches, flush_rows=150,
                              compact_min_rows=-1)
        cutoff = int(np.median([c.max_ts for c in store._chunks]))
        removed = store.prune_older_than(cutoff)
        out.append((removed, store.total_events,
                    [c.seq for c in store._chunks]))
        assert store.verify_catalog() == []
        store.sealer.stop()
    assert out[0] == out[1] and out[1][0] > 0


@pytest.mark.parametrize("sync", [True, False])
def test_single_writer_event_store_matches_the_reference(tmp_path, batches,
                                                         sync):
    """The base class alone (one buffer, sealed by ``flush``): the same
    segments, rows and newest-first page as the reference's."""
    out = []
    for pkg, mod in (("jax", ref_es), ("torch", port_es)):
        store = mod.EventStore(str(tmp_path / pkg), flush_rows=10**6)
        for cols, mask in batches[:3]:
            store.append_columns(cols, mask=mask)
        rec = store.add_event(device_id=3, tenant_id=1, event_type=0,
                              ts_s=1_700_009_999, value=1.5)
        store.flush(sync=sync)
        for cols, mask in batches[3:]:
            store.append_columns(cols, mask=mask)
        store.flush()
        page = store.query(mod.SearchCriteria(page_size=30), tenant_id=1)
        out.append((dataclass_tuple(rec), store.total_events,
                    [c.seq for c in store._chunks], page.total,
                    [dataclass_tuple(r) for r in page],
                    dataclass_tuple(store.get_event(rec.event_id))))
        rows = stored_rows(store)
        out[-1] += (tuple(rows[n].tobytes() for n in rows),)
    assert out[0] == out[1]
    assert out[1][2] == [0, 1]


def test_terminal_seal_failure_dead_letters(tmp_path):
    """A seal that fails past its retry budget dead-letters its rows as
    ``event-flush-failed``; the flush then succeeds again (the record is
    the durable trace).  One failure is enough with a zero budget."""
    from sitewhere_tpu_torch.ingest.journal import Journal

    dl = Journal(str(tmp_path), name="dead-letters")
    store = PortStore(str(tmp_path), flush_rows=1000, n_shards=1,
                      dead_letters=dl, max_seal_retries=0,
                      seal_retry_window_s=0.0, compact_interval_s=0)
    cols = make_cols(np.random.default_rng(SEED), 64)
    store.append_columns(cols)
    with faults.injected("event_store.seal", OSError("disk gone")):
        store.flush()
    assert store.sealed_dead_lettered == 64
    docs = [json.loads(p) for _, p in dl.scan(0)]
    assert [d["kind"] for d in docs] == ["event-flush-failed"]
    assert docs[0]["rows"] == 64 and docs[0]["error"] == "disk gone"
    assert docs[0]["ts_min"] == int(cols["ts_s"].min())
    store.append_columns(cols)
    assert store.flush() == 64 and store.total_events == 64
    store.sealer.stop()
    dl.close()


def test_parked_seal_keeps_the_commit_gate_closed(tmp_path):
    """With retry budget left, a failed seal parks its job and the sync
    flush raises (no offset may commit past rows that exist nowhere);
    the next flush retries and succeeds."""
    store = PortStore(str(tmp_path), flush_rows=1000, n_shards=2,
                      compact_interval_s=0)
    store.append_columns(make_cols(np.random.default_rng(SEED), 100))
    with faults.injected("event_store.seal", OSError("transient"), times=1):
        with pytest.raises(OSError, match="not durably sealed"):
            store.flush()
    assert store.sealer.parked_count() == 1
    store.flush()
    assert store.sealer.parked_count() == 0 and store.total_events == 100
    store.sealer.stop()


# -- the dispatcher over a real store ---------------------------------------------


def make_wire_payloads():
    rng = np.random.default_rng(SEED + 9)
    t = WIRE_TS0_MS
    return [wire_payload(rng, 90, t, nan=True), wire_payload(rng, 60, t + 1_000),
            wire_payload(rng, 64, t + 2_000, kinds=("m",), p=(1.0,)),
            wire_payload(rng, 70, t + 65_000)]


@pytest.mark.parametrize("ring_depth", [2, 0])
def test_dispatcher_stores_the_reference_rows(tmp_path, ring_depth):
    payloads = make_wire_payloads()
    worlds = {}
    for pkg, cls in STORES.items():
        world = wire_world(pkg, tmp_path / pkg, ring_depth)
        store = cls(str(tmp_path / pkg), flush_rows=40, n_shards=4,
                    compact_interval_s=0)
        world.disp.event_store = store
        for p in payloads:
            world.disp.ingest_wire_lines(p)
        world.disp.flush()
        worlds[pkg] = (world, store)
    (rw, rs), (gw, gs) = worlds["jax"], worlds["torch"]
    ref_rows, got_rows = stored_rows(rs), stored_rows(gs)
    assert_cols_equal(ref_rows, got_rows)
    totals = gw.disp.metrics_snapshot()
    assert len(got_rows["ts_s"]) == totals["accepted"] > 0
    assert totals["derived_alerts"] > 0
    assert gw.reader.committed == rw.reader.committed == len(payloads)
    assert gs.sealer.parked_count() == 0
    for _, s in worlds.values():
        s.sealer.stop()
