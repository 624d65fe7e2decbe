"""The port's pipeline dispatcher against the JAX reference, on the CPU.

The same seeded NDJSON payloads go through a bare ``sitewhere_tpu``
dispatcher and the port's (the composition of ``torch_parity.wire_world``:
real RegistryMirror, RuleManager, DeviceStateManager, packed Batcher, a
Journal and a recording store), with the ring at depth 2 and off, and
the native wire tier on in both.  Two traffics: the mixed one carries
measurements, locations and alerts (the C event-family scanners),
unregistered tokens, a NaN value, tenant-mismatched and unassigned
devices, rows that fire derived alerts, timestamp ties, and a deadline
partial that drains a ring-held plan through the single-step path
between two rings; the measurement-only one (``meas``) carries
full-width payloads that decode fill-direct into batcher reservations
and are adopted as plans, and a partial one.  Compared: every egress
append (host columns and the five enrichment columns exact), the metrics
totals with ``steps``, ``ring_chains`` and ``host_syncs``, the bytes
copied by decode and batch, every device's state (ints exact, EWMAs
within 4 ULPs of the value scale), the committed offset, the journal
files byte for byte, and each package's replay of the other's journal
(through the C resolved scanner where it takes the record).

The single-chip cases of the reference's ``TestDeviceResidentRing`` and
``TestEgressOffload`` (``tests/test_host_pipeline.py:329-565``) run
against the port with a stubbed packed step and chain; the last tests
cover the state manager's tenant lookup and ``read_epoch`` commit.
"""

import functools
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.ingest.batcher import Batcher
from sitewhere_tpu_torch.pipeline.packed import (
    METRIC_SCALARS,
    packed_metric_entries,
)
from sitewhere_tpu_torch.runtime import faults
from sitewhere_tpu_torch.runtime.dispatcher import PipelineDispatcher
from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry
from torch_parity import (
    WIRE_CAP,
    WIRE_TS0_MS,
    WIRE_WIDTH,
    assert_packed_state_equal,
    journal_files,
    wire_payload,
    wire_world,
)

torch.set_num_threads(1)

SEED = 20261016
LATENCY_KEYS = ("latency_p50_ms", "latency_p99_ms")


def make_payloads():
    rng = np.random.default_rng(SEED)
    t = WIRE_TS0_MS
    return {
        "p0": wire_payload(rng, 90, t, nan=True),
        "p1": wire_payload(rng, 60, t + 1_000),
        "p2": wire_payload(rng, 50, t + 2_000, kinds=("m",), p=(1.0,)),
        "p3": wire_payload(rng, 70, t + 65_000),
        "p4": wire_payload(rng, 70, t + 66_000),
    }


def make_meas_payloads():
    """Measurement-only traffic: full-width payloads (fill-direct,
    adopted while nothing else is pending) around a 20-line one."""
    rng = np.random.default_rng(SEED + 1)
    t = WIRE_TS0_MS
    meas = {"kinds": ("m",), "p": (1.0,)}
    sizes = (WIRE_WIDTH, WIRE_WIDTH, WIRE_WIDTH, 20, WIRE_WIDTH, WIRE_WIDTH)
    return {f"m{i}": wire_payload(rng, n, t + 1_000 * i, **meas)
            for i, n in enumerate(sizes)}


# the order each traffic ingests its payloads in; POLL: the pending rows
# pass the deadline and the batcher is polled
POLL = "poll"
ORDER = {"mixed": ("p0", "p1", "p2", POLL, "p3", "p4"),
         "meas": ("m0", "m1", "m2", "m3", POLL, "m4", "m5")}


def drive(world, payloads, order=ORDER["mixed"]):
    """Two rings (at depth 2), a ring-held plan drained by a deadline
    partial between them, then a flush."""
    d = world.disp
    for key in order:
        if key == POLL:
            world.clock.t += 61.0
            d._run_plans(d._take(d.batcher.poll))
        else:
            d.ingest_wire_lines(payloads[key])
    d.flush()


def count_adopted(world):
    """Count the batcher's zero-copy (adopted) emissions."""
    b = world.batcher
    emit_adopted = b._emit_adopted
    world.adopted = 0

    def counted(*args, **kw):
        world.adopted += 1
        return emit_adopted(*args, **kw)

    b._emit_adopted = counted


def snapshot(world):
    snap = world.disp.metrics_snapshot()
    for key in LATENCY_KEYS:
        snap.pop(key, None)
    snap.pop("device_fault", None)
    snap.pop("quarantined_devices", None)
    snap.pop("commands", None)
    return snap


def assert_appends_equal(ref, got):
    assert len(ref.appends) == len(got.appends)
    for i, ((rc, rm), (gc, gm)) in enumerate(zip(ref.appends, got.appends)):
        assert list(rc) == list(gc), i
        np.testing.assert_array_equal(rm, gm, err_msg=f"mask {i}")
        for name in rc:
            assert rc[name].dtype == gc[name].dtype, (i, name)
            np.testing.assert_array_equal(rc[name], gc[name],
                                          err_msg=f"append {i} {name}")


def assert_states_equal(ref, got):
    for dev in range(WIRE_CAP):
        assert ref.state.get_device_state_by_id(dev) \
            == got.state.get_device_state_by_id(dev), dev
    assert_packed_state_equal(ref.state.current_packed,
                              got.state.current_packed)


@pytest.fixture(scope="module")
def payloads():
    return make_payloads()


@pytest.fixture(scope="module",
                params=[("mixed", 2), ("mixed", 0), ("meas", 2), ("meas", 0)],
                ids=["ring2", "ring0", "meas-ring2", "meas-ring0"])
def runs(request, payloads, tmp_path_factory):
    traffic, depth = request.param
    if traffic == "meas":
        payloads = make_meas_payloads()
    root = tmp_path_factory.mktemp(f"wire-{traffic}{depth}")
    out = {"traffic": traffic,
           "records": sum(k != POLL for k in ORDER[traffic])}
    for pkg in ("jax", "torch"):
        world = wire_world(pkg, root / pkg, depth)
        count_adopted(world)
        drive(world, payloads, ORDER[traffic])
        out[pkg] = world
    out["root"] = root
    return out


def test_egress_columns_per_plan(runs):
    ref, got = runs["jax"], runs["torch"]
    assert len(ref.store.appends) >= 4
    assert_appends_equal(ref.store, got.store)


def test_metrics_totals(runs):
    ref, got = snapshot(runs["jax"]), snapshot(runs["torch"])
    assert ref == got
    depth = got["ring_depth"]
    assert got["steps"] >= 5 and got["derived_alerts"] > 0
    assert got["unregistered"] > 0 and got["unassigned"] > 0
    if depth:
        assert got["ring_chains"] == 2 and got["ring_flushed_plans"] >= 1
        assert got["host_syncs"] < got["steps"]
    else:
        assert got["host_syncs"] == got["steps"]
    assert runs["torch"].disp.latencies_s


def test_device_state_rows(runs):
    assert_states_equal(runs["jax"], runs["torch"])


def test_bytes_copied_and_adoptions(runs):
    """The decode and batch stages copy the same bytes in both packages,
    and adopt the same plans.  Both traffics decode through fill lanes
    (fill-direct, the event-family fill scanner), which copy nothing;
    full-width measurement payloads are adopted."""
    ref, got = runs["jax"], runs["torch"]

    def copied(world):
        return (world.disp.metrics.counter(
            "pipeline.bytes_copied.decode").value,
            world.batcher.copied_bytes, world.adopted)

    assert copied(got) == copied(ref)
    decode_bytes, batch_bytes, adopted = copied(got)
    assert decode_bytes == 0 and batch_bytes > 0
    assert (adopted >= 2) == (runs["traffic"] == "meas")


def test_committed_offset_and_journal_bytes(runs):
    ref, got = runs["jax"], runs["torch"]
    records = runs["records"]
    assert got.reader.committed == ref.reader.committed == records
    assert got.journal.end_offset == records
    assert got.store.flushes == ref.store.flushes >= 1
    assert journal_files(got.journal) == journal_files(ref.journal)


def test_replay_across_packages(runs, tmp_path):
    """The JAX dispatcher replays the port's journal and the port replays
    the JAX journal: the same rows, plans and state come out, and the
    same records replay through the C resolved scanner
    (``_replay_columnar``): all of them in measurement-only traffic."""
    ring = runs["torch"].disp.ring_depth
    out = {}
    for pkg, other in (("jax", "torch"), ("torch", "jax")):
        src = runs[other].journal
        src.flush()
        dst = tmp_path / f"{pkg}-replays-{other}"
        shutil.copytree(src.dir, dst / "events")
        world = wire_world(pkg, dst, ring, group="replay")
        columnar = world.disp._replay_columnar
        world.fast = []

        def counted(payload, offset, _columnar=columnar, _world=world):
            n = _columnar(payload, offset)
            if n is not None:
                _world.fast.append(offset)
            return n

        world.disp._replay_columnar = counted
        assert world.disp.replay_journal() == 340
        out[pkg] = world
    assert_appends_equal(out["jax"].store, out["torch"].store)
    assert snapshot(out["jax"]) == snapshot(out["torch"])
    assert_states_equal(out["jax"], out["torch"])
    records = runs["records"]
    assert out["torch"].reader.committed == out["jax"].reader.committed \
        == records
    assert out["torch"].fast == out["jax"].fast
    assert len(out["torch"].fast) == (records if runs["traffic"] == "meas"
                                      else 1)


def test_unpacked_plans_match_the_reference(payloads, tmp_path):
    """A batcher without ``emit_packed``: the plan's EventBatch is
    materialized on the dispatcher's device and the unpacked step runs."""
    worlds = {pkg: wire_world(pkg, tmp_path / pkg, 0, emit_packed=False)
              for pkg in ("jax", "torch")}
    for world in worlds.values():
        drive(world, payloads)
    assert_appends_equal(worlds["jax"].store, worlds["torch"].store)
    assert snapshot(worlds["jax"]) == snapshot(worlds["torch"])
    assert_states_equal(worlds["jax"], worlds["torch"])


def test_scalar_intake_edges_match_the_reference(payloads, tmp_path):
    """``ingest`` (one request, its own journal record) and
    ``ingest_many`` (one payload's requests, one record) with per-request
    tenants from ``metadata``."""
    import sitewhere_tpu.ingest.decoders as jdec

    import sitewhere_tpu_torch.ingest.decoders as tdec

    worlds = {pkg: wire_world(pkg, tmp_path / pkg, 2)
              for pkg in ("jax", "torch")}
    for pkg, world in worlds.items():
        dec = (jdec if pkg == "jax" else tdec).JsonLinesDecoder()
        reqs = dec(payloads["p0"]) + dec(payloads["p1"])
        for r in reqs[::7]:
            r.metadata = {"tenant": "acme"}
        for r in reqs[:20]:
            world.disp.ingest(r, payload=b"one request")
        world.disp.ingest_many(reqs[20:], payloads["p1"])
        world.disp.flush()
    ref, got = worlds["jax"], worlds["torch"]
    assert_appends_equal(ref.store, got.store)
    assert snapshot(ref) == snapshot(got)
    assert_states_equal(ref, got)
    assert journal_files(got.journal) == journal_files(ref.journal)
    assert got.reader.committed == 21
    assert {int(t) for c, m in got.store.appends
            for t in c["tenant_id"][m]} == {0, 1}


def test_started_dispatcher_warms_up_and_flushes(payloads, tmp_path):
    """start() runs the all-invalid warm-up (state unchanged), the loop
    thread runs, and stop() flushes every row through egress."""
    world = wire_world("torch", tmp_path, 2, egress_offload=True,
                       name="started-wire-dispatcher")
    before = world.state.current_packed
    world.disp.start()
    try:
        after = world.state.current_packed
        assert after is not before
        assert torch.equal(after.si, before.si)
        assert torch.equal(after.sf, before.sf)
        assert world.disp.steps == 0
        world.disp.ingest_wire_lines(payloads["p0"])
        world.disp.ingest_wire_lines(payloads["p1"])
    finally:
        world.disp.stop()
    assert sum(int(m.sum()) for _, m in world.store.appends) \
        == world.disp.totals["accepted"] > 0
    assert world.reader.committed == 2
    assert not any(t.name.startswith(world.disp.name)
                   for t in threading.enumerate())


def test_quarantine_emits_one_state_change(tmp_path):
    """Three NaN rows of one device cross ``quarantine_after``: one
    STATE_CHANGE with the quarantine code is re-injected and stored."""
    from sitewhere_tpu_torch.state.presence import STATE_CHANGE_QUARANTINED

    world = wire_world("torch", tmp_path, 0)
    d = world.disp
    n = 3
    d.ingest_arrays(device_id=np.full(n, 4, np.int32),
                    event_type=np.zeros(n, np.int32),
                    ts_s=np.arange(n, dtype=np.int32) + 10,
                    mtype_id=np.zeros(n, np.int32),
                    value=np.full(n, np.nan, np.float32))
    d.flush()
    d.flush()
    assert d.metrics_snapshot()["quarantined_devices"] == 1
    rows = [(c["event_type"][m], c["alert_code"][m], c["device_id"][m])
            for c, m in world.store.appends]
    changes = [(et, code, dev) for et, code, dev in rows
               for et, code, dev in zip(et, code, dev) if et == 5]
    assert changes == [(5, STATE_CHANGE_QUARANTINED, 4)]


def test_dispatcher_needs_a_card_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batcher = Batcher(width=8, n_shards=1, registry_capacity=16,
                      resolve_device=lambda t: -1, resolve_mtype=lambda n: 0,
                      resolve_alert=lambda n: 0, emit_packed=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelineDispatcher(batcher, lambda: None, None, lambda: None,
                           lambda: None)
    disp = PipelineDispatcher(batcher, lambda: None, None, lambda: None,
                              lambda: None, device="cpu")
    assert disp.device.type == "cpu"
    assert disp.inflight_depth == 1 and disp.ring_depth == 0
    assert disp.egress_offload is False


def test_backend_switches_on_the_card_follow_the_non_tpu_branch(
        monkeypatch):
    monkeypatch.delenv("SW_TPU_RING_DEPTH", raising=False)
    batcher = Batcher(width=8, n_shards=1, registry_capacity=16,
                      resolve_device=lambda t: -1, resolve_mtype=lambda n: 0,
                      resolve_alert=lambda n: 0, emit_packed=True)
    disp = PipelineDispatcher(batcher, lambda: None, None, lambda: None,
                              lambda: None, device="cuda")
    assert (disp.inflight_depth, disp.ring_depth, disp.egress_offload) \
        == (1, 0, True)
    monkeypatch.setenv("SW_TPU_RING_DEPTH", "8")
    disp = PipelineDispatcher(batcher, lambda: None, None, lambda: None,
                              lambda: None, device="cuda")
    assert disp.ring_depth == 8 and disp.inflight_depth == 16


# ---------------------------------------------------------------------------
# the reference's single-chip ring and offload cases, with a stubbed step
# ---------------------------------------------------------------------------

WIDTH = 8


def _quick_stop(disp):
    """stop() with a short final flush: a test that wedged the commit
    gate on purpose need not wait out the 10 s flush bound."""
    disp.flush = functools.partial(disp.flush, timeout_s=0.2)
    disp.stop()


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.002)
    return cond()


class SlowStore:
    """Event-store stand-in whose append costs ``delay_s`` host time."""

    def __init__(self, delay_s=0.0):
        self.delay_s = delay_s
        self.rows = 0
        self.batches = 0
        self.append_threads = set()
        self.first_ids = []  # first device_id of each appended batch

    def append_columns(self, cols, mask=None):
        self.append_threads.add(threading.current_thread().name)
        if self.delay_s:
            time.sleep(self.delay_s)
        self.rows += int(mask.sum()) if mask is not None \
            else len(cols["device_id"])
        self.batches += 1
        self.first_ids.append(int(np.asarray(cols["device_id"])[0]))

    def flush(self):
        pass


class FakeStateManager:
    current_packed = None

    def commit_packed(self, new_packed, present_now=None,
                      read_epoch=None, lease_token=None):
        pass

    def lease_packed(self):
        return None, None


def make_ring_dispatcher(ring_depth=2, egress_s=0.0, egress_offload=True,
                         inflight_depth=None, step_s=0.0):
    """Dispatcher over packed plans with a stubbed step and K-step chain
    whose outputs accept every valid row: the windowing, commit and
    ordering semantics in isolation."""
    metrics = MetricsRegistry()
    batcher = Batcher(
        width=WIDTH, n_shards=1, registry_capacity=64,
        resolve_device=lambda t: -1, resolve_mtype=lambda n: 0,
        resolve_alert=lambda n: 0, deadline_ms=60_000.0, emit_packed=True)
    store = SlowStore(egress_s)
    disp = PipelineDispatcher(
        batcher=batcher,
        registry_provider=lambda: None,
        state_manager=FakeStateManager(),
        rules_provider=lambda: None,
        zones_provider=lambda: None,
        event_store=store,
        egress_offload=egress_offload,
        inflight_depth=inflight_depth,
        ring_depth=ring_depth,
        metrics=metrics,
        device="cpu",
    )
    disp._tables_packed = lambda: None
    chain_calls = []

    def _step_out(bi):
        valid = (bi[0] != 0).to(torch.int32)
        oi = torch.zeros((10, WIDTH), dtype=torch.int32)
        oi[0] = valid  # flags row: F_ACCEPTED for every valid row
        mets = torch.zeros(packed_metric_entries(), dtype=torch.int32)
        mets[0] = mets[1] = int(valid.sum())  # processed / accepted
        return oi, mets

    def fake_chain(tables, ps, *slots):
        k = len(slots) // 2
        chain_calls.append(k)
        outs = [_step_out(slots[i]) for i in range(k)]
        return (ps, torch.stack([o for o, _ in outs]),
                torch.stack([m for _, m in outs]),
                torch.zeros(64, dtype=torch.bool))

    def fake_packed_step(tables, ps, bi, bf):
        if step_s:
            time.sleep(step_s)
        oi, mets = _step_out(bi)
        return ps, oi, mets, torch.zeros(64, dtype=torch.bool)

    for k in range(1, ring_depth + 1):
        disp._ring_chains[k] = fake_chain
    disp._packed_step = fake_packed_step
    disp._chain_calls = chain_calls
    assert len(METRIC_SCALARS) == 6
    return disp, store, metrics


def ingest_window_at(disp, base):
    """One full-width fill window with device ids base..base+WIDTH-1."""
    disp.ingest_arrays(
        device_id=(base + np.arange(WIDTH)).astype(np.int32))


def make_dispatcher(egress_s=0.0, egress_offload=True, inflight_depth=1,
                    step_s=0.0):
    disp, store, metrics = make_ring_dispatcher(
        ring_depth=0, egress_s=egress_s, egress_offload=egress_offload,
        inflight_depth=inflight_depth, step_s=step_s)
    return disp, store, metrics


def ingest_window(disp):
    disp.ingest_arrays(device_id=np.arange(WIDTH, dtype=np.int32))



def _wire_window(base):
    """NDJSON bytes of one full-width window of measurements."""
    return "\n".join(
        '{"deviceToken":"d-%d","type":"DeviceMeasurements","request":'
        '{"name":"m0","value":1.5,"eventDate":1700000000000}}' % (base + i)
        for i in range(WIDTH)).encode()


@pytest.mark.parametrize("how", ["stamped", "slow_decode"])
@pytest.mark.parametrize("ring_depth", [2, 0], ids=["ring2", "ring0"])
def test_latency_counts_from_the_payload_receipt(monkeypatch, ring_depth,
                                                 how):
    """A plan's latency starts when its oldest row's payload arrived,
    before the decode: an explicit ``received_at`` half a second back, or
    a decode that takes 50 ms, is inside every sample."""
    import sitewhere_tpu_torch.runtime.dispatcher as tdisp

    disp, store, _ = make_ring_dispatcher(ring_depth=ring_depth,
                                          egress_offload=False)
    floor_s = 0.5 if how == "stamped" else 0.05
    if how == "slow_decode":
        real = tdisp.decode_json_lines

        def slow(payload, **kw):
            time.sleep(floor_s)
            return real(payload, **kw)

        monkeypatch.setattr(tdisp, "decode_json_lines", slow)
    for base in (0, WIDTH):
        received = time.monotonic() - floor_s if how == "stamped" else None
        disp.ingest_wire_lines(_wire_window(base), received_at=received)
    disp.flush()
    assert store.rows == 2 * WIDTH
    assert disp.steps == 2 and disp._chain_calls == ([2] if ring_depth
                                                     else [])
    assert len(disp.latencies_s) == 2
    assert min(disp.latencies_s) >= floor_s


class TestEgressOffload:
    def test_flush_drains_the_offload_queue(self):
        disp, store, _ = make_dispatcher(egress_s=0.01)
        disp.start()
        try:
            for _ in range(4):
                ingest_window(disp)
            disp.flush()
            assert store.rows == 4 * WIDTH
            assert not disp._inflight
            with disp._lock:
                assert disp._plans_outstanding == 0
        finally:
            disp.stop()

    def test_egress_runs_off_the_dispatch_thread(self):
        disp, store, _ = make_dispatcher(egress_s=0.0)
        disp.start()
        try:
            ingest_window(disp)
            disp.flush()
            assert store.rows == WIDTH
            assert all("egress" in t for t in store.append_threads)
        finally:
            disp.stop()

    def test_offload_disabled_is_inline_and_needs_no_threads(self):
        disp, store, _ = make_dispatcher(egress_offload=False)
        ingest_window(disp)
        disp.flush()
        assert store.rows == WIDTH
        assert all("egress" not in t for t in store.append_threads)

    def test_unstarted_dispatcher_degrades_to_inline(self):
        disp, store, _ = make_dispatcher(egress_offload=True)
        ingest_window(disp)
        disp.flush()
        assert store.rows == WIDTH

    def test_backpressure_bounds_the_window(self):
        disp, store, _ = make_dispatcher(egress_s=0.05, inflight_depth=1)
        disp.start()
        try:
            for _ in range(6):
                ingest_window(disp)
                assert len(disp._inflight) <= disp.egress_queue_depth
            disp.flush()
            assert store.rows == 6 * WIDTH
        finally:
            disp.stop()

    def test_egress_crash_fails_closed_and_worker_recovers(self):
        faults.clear()
        disp, store, _ = make_dispatcher(egress_s=0.0)
        disp.start()
        try:
            faults.inject("dispatcher.egress", times=1)
            ingest_window(disp)           # this plan's egress dies
            assert _wait(lambda: faults.fired("dispatcher.egress") == 1)
            ingest_window(disp)           # sibling must still egress
            disp.flush(timeout_s=1.0)
            assert store.rows == WIDTH
            assert disp.egress_failures == 1
            assert _wait(lambda: disp._egress_super.restarts >= 1)
            assert not disp._egress_super.escalated
            with disp._lock:
                assert disp._plans_outstanding == 1
        finally:
            faults.clear()
            _quick_stop(disp)

    def test_step_fault_propagates_and_keeps_the_gate_closed(self):
        """No containment in this slice: a failed single step raises to
        the caller and its plan stays outstanding."""
        faults.clear()
        disp, store, _ = make_dispatcher(egress_offload=False)
        try:
            faults.inject("dispatcher.step", times=1)
            with pytest.raises(faults.FaultInjected):
                ingest_window(disp)
            ingest_window(disp)
            disp.flush(timeout_s=0.2)
            assert store.rows == WIDTH
            with disp._lock:
                assert disp._plans_outstanding == 1
        finally:
            faults.clear()


class TestDeviceResidentRing:
    def test_full_windows_chain_k_steps_one_sync_per_chain(self):
        disp, store, metrics = make_ring_dispatcher(ring_depth=2)
        disp.start()
        try:
            for i in range(4):
                ingest_window_at(disp, i * WIDTH % 64)
            disp.flush()
            assert store.rows == 4 * WIDTH
            # first call is the boot-time warm-up (all-invalid ring)
            assert disp._chain_calls == [2, 2, 2]
            assert metrics.counter("pipeline.host_syncs").value == 2
            assert metrics.counter("pipeline.ring_chains").value == 2
            assert not disp._ring
            with disp._lock:
                assert disp._plans_outstanding == 0
        finally:
            disp.stop()

    def test_flush_drains_partial_ring_no_lost_commits(self):
        disp, store, metrics = make_ring_dispatcher(ring_depth=2)
        disp.start()
        try:
            for i in range(3):   # one chain + one plan stranded in ring
                ingest_window_at(disp, i * WIDTH)
            disp.flush()
            assert store.rows == 3 * WIDTH
            assert not disp._ring
            with disp._lock:
                assert disp._plans_outstanding == 0
            assert metrics.counter("pipeline.ring_flushes").value == 1
        finally:
            disp.stop()

    def test_stop_drains_ring(self):
        disp, store, _ = make_ring_dispatcher(ring_depth=4)
        disp.start()
        ingest_window_at(disp, 0)   # sits in the ring, chain never fills
        disp.stop()                 # shutdown flush must not strand it
        assert store.rows == WIDTH
        with disp._lock:
            assert disp._plans_outstanding == 0

    def test_non_ring_plan_drains_ring_first_in_order(self):
        disp, store, _ = make_ring_dispatcher(ring_depth=3)
        disp.start()
        try:
            ingest_window_at(disp, 0)    # ring slot 0
            ingest_window_at(disp, 8)    # ring slot 1 (chain needs 3)
            disp.ingest_arrays(
                device_id=np.full(4, 16, np.int32))  # partial, pending
            disp.flush()                 # emits the partial (reason=flush)
            assert store.rows == 2 * WIDTH + 4
            assert store.first_ids == [0, 8, 16]
        finally:
            disp.stop()

    def test_barrier_drains_only_predecessors_by_seq(self):
        disp, store, _ = make_ring_dispatcher(ring_depth=4)
        disp.start()
        try:
            ingest_window_at(disp, 0)    # seq 0 -> ring
            ingest_window_at(disp, 8)    # seq 1 -> ring
            disp.ingest_arrays(device_id=np.full(4, 16, np.int32))
            partial = disp._take(disp.batcher.flush)[0]   # seq 2
            ingest_window_at(disp, 24)   # seq 3 -> ring (a successor)
            disp._run_plan(partial)
            with disp._step_lock:
                assert [p.seq for p in disp._ring] == [3]
            disp.flush()
            assert store.first_ids == [0, 8, 16, 24]
            assert store.rows == 3 * WIDTH + 4
        finally:
            disp.stop()

    def test_egress_crash_mid_ring_fails_closed_on_dead_step_only(self):
        faults.clear()
        disp, store, _ = make_ring_dispatcher(ring_depth=2)
        disp.start()
        try:
            faults.inject("dispatcher.egress", times=1)
            ingest_window_at(disp, 0)
            ingest_window_at(disp, 8)   # chain of 2 dispatches here
            assert _wait(lambda: faults.fired("dispatcher.egress") == 1)
            disp.flush(timeout_s=1.0)
            assert store.rows == WIDTH          # only the sibling landed
            assert disp.egress_failures == 1
            assert _wait(lambda: disp._egress_super.restarts >= 1)
            assert not disp._egress_super.escalated
            with disp._lock:
                assert disp._plans_outstanding == 1
        finally:
            faults.clear()
            _quick_stop(disp)

    def test_ring_ineligible_plans_take_the_single_step_path(self):
        disp, store, _ = make_ring_dispatcher(ring_depth=2)
        plan = disp._take(lambda: disp.batcher.add_arrays(
            device_id=np.arange(WIDTH, dtype=np.int32)))[0]
        assert not disp._ring_eligible(plan, replay_depth=1)
        assert disp._ring_eligible(plan, replay_depth=0)
        disp._run_plan(plan, replay_depth=1)
        assert not disp._ring   # never waited for a chain
        disp.flush()
        assert store.rows == WIDTH


# ---------------------------------------------------------------------------
# the two repairs: tenant lookup of the presence sweep, read_epoch commit
# ---------------------------------------------------------------------------

def _sweep_worlds(tmp_path):
    return {pkg: wire_world(pkg, tmp_path / pkg, 0)
            for pkg in ("jax", "torch")}


def test_presence_sweep_gives_each_state_change_its_tenant(tmp_path,
                                                           payloads):
    """Devices of two tenants go missing: the presence manager's sweep
    re-injects one STATE_CHANGE per device through the dispatcher, each
    carrying its device's tenant, as the reference's does."""
    import sitewhere_tpu.state.presence as jpresence

    import sitewhere_tpu_torch.state.presence as tpresence

    worlds = _sweep_worlds(tmp_path)
    for pkg, world in worlds.items():
        drive(world, payloads)
        # the wire lands in the default tenant: give two of the second
        # tenant's devices accepted events of their own
        world.disp.ingest_arrays(
            device_id=np.asarray([7, 17], np.int32),
            tenant_id=np.ones(2, np.int32),
            event_type=np.ones(2, np.int32),
            ts_s=np.full(2, 1_700_000_100, np.int32))
        world.disp.flush()
        presence = jpresence if pkg == "jax" else tpresence
        pm = presence.PresenceManager(
            world.state, missing_after_s=60,
            on_state_changes=lambda b, _d=world.disp: _d.inject_batch(
                b, np.ones(b.valid.shape[0], bool)))
        world.marked = pm.sweep_once(1_700_100_000)
        world.disp.flush()
    ref, got = worlds["jax"], worlds["torch"]
    assert got.marked == ref.marked > 0
    assert_appends_equal(ref.store, got.store)
    devs, tenants = [], []
    for cols, mask in got.store.appends:
        change = mask & (cols["event_type"] == 5)
        devs.extend(cols["device_id"][change].tolist())
        tenants.extend(cols["tenant_id"][change].tolist())
    assert len(devs) == got.marked
    assert set(tenants) == {0, 1}
    np.testing.assert_array_equal(tenants, got.mirror.tenant_id[devs])
    assert_states_equal(ref, got)


def test_single_step_commit_after_a_sweep_keeps_its_flags(tmp_path,
                                                          payloads):
    """A sweep lands between a single step's read of the epoch and its
    commit: the commit re-applies the sweep's flags for devices the step
    did not touch (``read_epoch``), in both packages."""
    worlds = _sweep_worlds(tmp_path)
    for pkg, world in worlds.items():
        drive(world, payloads)
        d = world.disp
        step = d._packed_step

        def step_then_sweep(tables, ps, bi, bf, _step=step, _w=world):
            out = _step(tables, ps, bi, bf)
            _w.state.apply_presence_sweep(1_700_100_000, 60)
            return out

        d._packed_step = step_then_sweep
        d.ingest_arrays(device_id=np.asarray([3, 4], np.int32),
                        event_type=np.ones(2, np.int32),
                        ts_s=np.full(2, 1_700_100_001, np.int32),
                        lat=np.ones(2, np.float32),
                        lon=np.ones(2, np.float32))
        d.flush()
    ref, got = worlds["jax"], worlds["torch"]
    assert_states_equal(ref, got)
    missing = got.state.summary()["devices_missing"]
    assert missing > 0
    assert not got.state.get_device_state_by_id(3)["presence_missing"]
