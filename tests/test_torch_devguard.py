"""Device-fault containment in the port against the reference.

- The guards: every non-mesh case of ``tests/test_devguard.py``'s
  breaker and watchdog units runs on both packages' classes under one
  fake clock, and the two traces of observations must be equal.
- The containment protocol on live ``Instance``s (the CPU, width 64):
  the reference's ``tools/devfault_bench.py`` phases ``chain_fault``,
  ``breaker`` and ``poison`` against the port's twin
  (``tools/torch_devfault_bench.py``), report for report; and one
  schedule (a transient step fault, three poison rows, their requeue)
  through both ``Instance``s, compared exactly: the ``device.fault.*``
  counters, the ``device-poison`` letters, the stored rows, the device
  state (ints and bools bitwise, the EWMA within 4 ULPs of the value
  scale) and the ledger's per-tenant row totals.
- The watchdog on a live instance under a fake clock (no wall-time
  stall), on both packages.
- A sticky CUDA error fails closed: the process exits with
  ``STICKY_EXIT_CODE``, nothing is dead-lettered, no step falls back to
  the CPU, and a restart recovers every journaled row.  Any other error
  the CUDA runtime raised about the card fails closed too, without a
  bisection, and so does the breaker's FALLBACK level on a card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from sitewhere_tpu.runtime import devguard as ref_devguard
from sitewhere_tpu.runtime import faults as ref_faults
from sitewhere_tpu_torch.runtime import devguard as port_devguard
from sitewhere_tpu_torch.runtime import faults as port_faults
from sitewhere_tpu_torch.runtime.dispatcher import (
    STICKY_EXIT_CODE,
    is_card_error,
    is_sticky_cuda_error,
)
from torch_parity import assert_state_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import devfault_bench as ref_bench  # noqa: E402
import torch_devfault_bench as port_bench  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
PACKAGES = {"jax": ref_devguard, "torch": port_devguard}


@pytest.fixture(autouse=True)
def _clean_device_faults():
    for f in (ref_faults, port_faults):
        f.device_clear()
    yield
    for f in (ref_faults, port_faults):
        f.device_clear()


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# ---------------------------------------------------------------------------
# the guards: one scenario, both packages, equal traces
# ---------------------------------------------------------------------------

def _breaker_distinct_batches(g):
    clock = FakeClock()
    b = g.DeviceBreaker(threshold=3, clock=clock)
    for _ in range(10):
        b.record_fault(seq=7)      # the bisection re-faults ONE batch
    out = [b.level, b.trips]
    out.append(b.record_fault(seq=8))
    out.append(b.record_fault(seq=9))   # third distinct batch
    return out + [b.level, b.trips]


def _breaker_window(g):
    clock = FakeClock()
    b = g.DeviceBreaker(threshold=2, window_s=60.0, clock=clock)
    b.record_fault(1)
    clock.advance(61.0)
    b.record_fault(2)              # the first strike expired
    out = [b.level]
    b.record_fault(3)
    return out + [b.level]


def _breaker_ladder_stops(g):
    b = g.DeviceBreaker(threshold=1, clock=FakeClock())
    out = []
    for seq in (1, 2, 3):
        b.record_fault(seq)
        out.append(b.level)
    return out


def _breaker_probe_restores(g):
    clock = FakeClock()
    trips, restores = [], []
    b = g.DeviceBreaker(threshold=1, cooldown_s=30.0, clock=clock,
                        on_trip=trips.append,
                        on_restore=lambda: restores.append(True))
    b.record_fault(1)
    out = [list(trips), b.allow_chain()]
    clock.advance(31.0)
    out.append(b.allow_chain())    # half-open probe
    b.record_success(chained=True)
    return out + [b.level, list(restores), b.allow_chain(), b.snapshot()]


def _breaker_probe_failure(g):
    clock = FakeClock()
    b = g.DeviceBreaker(threshold=1, cooldown_s=30.0, clock=clock)
    b.record_fault(1)
    clock.advance(31.0)
    out = [b.allow_chain()]
    b.record_fault(2)              # the probe chain died
    out += [b.level, b.allow_chain()]
    clock.advance(29.0)
    out.append(b.allow_chain())    # the cooldown restarted
    clock.advance(2.0)
    return out + [b.allow_chain(), b.snapshot()]


def _breaker_single_step_success(g):
    b = g.DeviceBreaker(threshold=1, clock=FakeClock())
    b.record_fault(1)
    b.record_success(chained=False)
    return [b.level, b.snapshot()]


def _breaker_snapshot(g):
    return [g.DeviceBreaker().snapshot(), list(g.BREAKER_LEVELS),
            [g.CHAINED, g.SINGLE_STEP, g.FALLBACK]]


def _watchdog_soft_hard(g):
    clock = FakeClock()
    soft, hard = [], []
    wd = g.DeviceWatchdog(soft_s=1.0, hard_s=5.0, clock=clock,
                          on_soft=lambda r, e: soft.append((r, e)),
                          on_unhealthy=lambda r, e: hard.append((r, e)))
    token = wd.begin("plan-A")
    clock.advance(1.5)
    out = [wd.check(), list(soft)]
    wd.check()
    out.append(len(soft))          # once per entry
    clock.advance(4.0)
    out += [wd.check(), list(hard), wd.unhealthy]
    wd.check()
    out.append(len(hard))          # once per episode
    wd.end(token)
    return out + [wd.unhealthy, wd.snapshot()]


def _watchdog_parts(g):
    clock = FakeClock()
    recovered = []
    wd = g.DeviceWatchdog(soft_s=1.0, hard_s=2.0, clock=clock,
                          on_recovered=lambda: recovered.append(True))
    token = wd.begin(["p1", "p2", "p3"], parts=3)
    clock.advance(3.0)
    out = [wd.check(), wd.unhealthy]
    wd.end(token)
    wd.end(token)
    out.append(wd.unhealthy)       # two of three parts done
    wd.end(token)
    out += [wd.unhealthy, list(recovered)]
    wd.end(token)                  # idempotent
    wd.end(None)                   # None-safe
    return out + [wd.snapshot()]


def _watchdog_opaque(g):
    clock = FakeClock()
    seen = []
    wd = g.DeviceWatchdog(soft_s=0.5, hard_s=9.0, clock=clock,
                          on_soft=lambda r, e: seen.append(r))
    payload = [object(), object()]
    wd.begin(payload, parts=2)
    clock.advance(1.0)
    wd.check()
    return [len(seen), seen[0] is payload]


def _watchdog_calibrate(g):
    wd = g.DeviceWatchdog()
    out = []
    for stage_ms in (0.2, 30.0, 0.0, 1e3):
        wd.calibrate(stage_ms=stage_ms)
        out.append((wd.soft_s, wd.hard_s))
    return out


def _watchdog_snapshot(g):
    clock = FakeClock()
    wd = g.DeviceWatchdog(clock=clock)
    wd.begin("x")
    clock.advance(2.0)
    return [wd.snapshot()]


SCENARIOS = {f.__name__[1:]: f for f in (
    _breaker_distinct_batches, _breaker_window, _breaker_ladder_stops,
    _breaker_probe_restores, _breaker_probe_failure,
    _breaker_single_step_success, _breaker_snapshot, _watchdog_soft_hard,
    _watchdog_parts, _watchdog_opaque, _watchdog_calibrate,
    _watchdog_snapshot)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_guard_scenario_equals_the_reference(name):
    ref = SCENARIOS[name](PACKAGES["jax"])
    got = SCENARIOS[name](PACKAGES["torch"])
    assert got == ref


def test_guard_expectations_hold_in_the_port():
    """The reference's own assertions, on the port's trace."""
    assert _breaker_distinct_batches(port_devguard) == [
        0, 0, False, True, 1, 1]
    assert _breaker_window(port_devguard) == [0, 1]
    assert _breaker_ladder_stops(port_devguard) == [1, 2, 2]
    probe = _breaker_probe_restores(port_devguard)
    assert probe[:6] == [[1], False, True, 0, [True], True]
    assert _breaker_probe_failure(port_devguard)[:5] == [
        True, 2, False, False, True]
    soft_hard = _watchdog_soft_hard(port_devguard)
    assert soft_hard[0] is False and soft_hard[2] == 1
    assert soft_hard[3] is True and soft_hard[6] == 1
    assert soft_hard[7] is False
    assert _watchdog_calibrate(port_devguard)[:2] == [
        (0.25, 2.0), (pytest.approx(1.5), pytest.approx(12.0))]
    # the per-shard bank came with the mesh: the same trace in both
    assert _shard_bank_trace(port_devguard) == _shard_bank_trace(
        ref_devguard)


def _shard_bank_trace(mod):
    """One fault/success/cooldown script through a 4-shard ShardBreakers
    bank: levels, demoted and suspect shards, the callbacks, snapshots."""
    now = [0.0]
    events = []
    bank = mod.ShardBreakers(4, threshold=2, window_s=60.0, cooldown_s=5.0,
                             clock=lambda: now[0],
                             on_trip=lambda s, lv: events.append(
                                 ("trip", s, lv)),
                             on_restore=lambda s: events.append(
                                 ("restore", s)))
    out = []
    for seq in (1, 1, 2):
        out.append(bank.record_fault(seq, shard=2))
    out += [bank.level, bank.level_of(2), bank.demoted_shards(),
            bank.allow_chain(), bank.suspect_shards()]
    out.append(bank.record_fault(3))          # unattributable: every shard
    out += [bank.suspect_shards(), bank.record_fault(4)]
    out += [bank.demoted_shards(), bank.allow_chain()]
    now[0] = 6.0
    out += [bank.demoted_shards(), bank.allow_chain()]
    bank.record_success(chained=True, masked=(2,))
    out += [bank.level_of(2), bank.level, bank.demoted_shards()]
    bank.record_success(chained=True)
    out += [bank.level, bank.trips, bank.restores, events,
            {k: v for k, v in bank.snapshot().items() if k != "shards"}]
    return out


# ---------------------------------------------------------------------------
# the containment protocol: the reference's bench against the port's twin
# ---------------------------------------------------------------------------

def _checker():
    failures = []

    def check(ok, msg):
        if not ok and msg:
            failures.append(msg)

    return check, failures


def _breaker_driven(inst):
    """The ladder moves only where the breaker forces it: its own sampling
    of wall-clock pressure (the seal lag of a loaded test runner) is off,
    as the benches' hour-long ladder cooldown intends."""
    if inst.overload is not None:
        inst.overload.signals_fn = None
    return inst


@pytest.fixture(scope="module")
def benches(tmp_path_factory):
    """The reference's chain_fault, breaker and poison phases and the
    port's, each on its own package, with each breaker run's overload
    transitions."""
    root = tmp_path_factory.mktemp("benches")
    ref_transitions = []
    make, port_make = ref_bench._make_instance, port_bench.make_instance

    def make_driven(data_dir, **overrides):
        return _breaker_driven(make(data_dir, **overrides))

    def make_recorded(data_dir, **overrides):
        inst = make_driven(data_dir, **overrides)
        if inst.overload is not None:
            inst.overload.on_transition(
                lambda old, new, signals: ref_transitions.append(
                    [old.name, new.name, inst.overload.last_driver]))
        return inst

    check, ref_fail = _checker()
    ref_bench._make_instance = make_driven
    try:
        ref = {"chain_fault": ref_bench.phase_chain_fault(
            str(root / "jax"), check)}
        # the breaker phase's instance only, as the port's report holds
        # its own breaker instance's transitions only
        ref_bench._make_instance = make_recorded
        ref["breaker"] = ref_bench.phase_breaker(str(root / "jax"), check)
        ref_bench._make_instance = make_driven
        ref["poison"] = ref_bench.phase_poison(str(root / "jax"), check,
                                               True)
    finally:
        ref_bench._make_instance = make
        ref_faults.device_clear()
    check, port_fail = _checker()
    port_bench.make_instance = lambda *a, **k: _breaker_driven(
        port_make(*a, **k))
    try:
        port = {
            "chain_fault": port_bench.phase_chain_fault(
                str(root / "torch"), check, CPU),
            "breaker": port_bench.phase_breaker(str(root / "torch"), check,
                                                CPU),
        }
        report, inst, letters = port_bench.phase_poison(
            str(root / "torch"), check, CPU)
        report.update(port_bench.phase_quarantine(inst, letters, check))
        port["poison"] = report
    finally:
        port_bench.make_instance = port_make
        port_faults.device_clear()
    return {"jax": ref, "torch": port, "jax_failures": ref_fail,
            "torch_failures": port_fail,
            "jax_transitions": ref_transitions}


@pytest.mark.parametrize("phase", ["chain_fault", "breaker", "poison"])
def test_bench_phase_equals_the_reference(benches, phase):
    ref, got = benches["jax"][phase], benches["torch"][phase]
    common = set(ref) & set(got)
    assert {k: got[k] for k in common} == {k: ref[k] for k in common}
    # every key of the reference's report is in the port's
    assert set(ref) <= set(got)


def test_bench_contracts_hold(benches):
    assert benches["jax_failures"] == []
    assert benches["torch_failures"] == []
    port = benches["torch"]
    assert port["breaker"]["cpu_fallback_steps"] > 0
    for phase in ("chain_fault", "poison"):
        assert port[phase]["cpu_fallback_steps"] == 0


def test_breaker_rides_and_releases_the_ladder_as_the_reference(benches):
    assert benches["torch"]["breaker"]["transitions"] == \
        benches["jax_transitions"]
    assert benches["jax_transitions"] == [
        ["NORMAL", "DEGRADED", "device-breaker"],
        ["DEGRADED", "NORMAL", "device-breaker-recovered"]]


def test_mid_chain_fault_keeps_the_epoch_and_the_result(benches):
    """A fault at slot 1 of the 2-step chain, after slot 0 ran: the held
    epoch is the pre-chain one, bitwise, and the single-step re-dispatch
    leaves the state bitwise a fault-free run's."""
    chain = benches["torch"]["chain_fault"]
    assert chain["mid_chain_faults"] == 1
    assert chain["epoch_kept_bitwise"]
    assert chain["state_equals_fault_free"]
    assert chain["stored_after_mid_chain"] == 4 * 2 * port_bench.WIDTH


# ---------------------------------------------------------------------------
# one schedule through both Instances, compared exactly
# ---------------------------------------------------------------------------

def _instance(pkg, data_dir, **pipeline):
    tree = {
        "instance": {"id": "devguard-parity", "data_dir": str(data_dir)},
        "pipeline": {"width": 64, "registry_capacity": 128,
                     "mtype_slots": 4, "deadline_ms": 5.0, "n_shards": 1,
                     "ring_depth": 0, "quarantine_after": 2, **pipeline},
        "overload": {"cooldown_s": 3600.0},
        "checkpoint": {"interval_s": 0},
        "events": {"compact_interval_s": 0},
    }
    if pkg == "jax":
        from sitewhere_tpu.instance import Instance
        from sitewhere_tpu.runtime.config import Config

        tree["presence"] = {"scan_interval_s": 3600.0,
                            "missing_after_s": 1800}
        return Instance(Config(tree, apply_env=False))
    from sitewhere_tpu_torch.instance import Instance
    from sitewhere_tpu_torch.runtime.config import Config

    return Instance(Config(tree, apply_env=False), device="cpu")


def _lines(values, ts0, token="d-0"):
    return "\n".join(json.dumps({
        "deviceToken": token, "type": "Measurement",
        "request": {"name": "temp", "value": v, "eventDate": ts0 + i},
    }) for i, v in enumerate(values)).encode()


def _stored_rows(store):
    """Stored rows as sortable keys; a quarantine STATE_CHANGE carries the
    wall clock of its emission, so its time is left out."""
    from sitewhere_tpu_torch.schema import EventType

    keys = []
    for c in store.iter_chunks():
        et = np.asarray(c["event_type"], np.int64)
        keys.append(np.stack([
            np.asarray(c["device_id"], np.int64),
            et,
            np.where(et == int(EventType.STATE_CHANGE), 0,
                     np.asarray(c["ts_s"], np.int64)),
            np.asarray(c["mtype_id"], np.int64),
            np.asarray(c["value"], np.float32).view(np.int32).astype(
                np.int64),
            np.asarray(c["tenant_id"], np.int64)], axis=1))
    rows = np.concatenate(keys) if keys else np.zeros((0, 6), np.int64)
    return rows[np.lexsort(rows.T[::-1])]


def _jsonable(doc):
    """A dead-letter document with NaN spelled out, for equality."""
    return json.loads(json.dumps(doc, sort_keys=True,
                                 default=str).replace("NaN", '"NaN"'))


ROW_COUNTERS = ("rows", "state_writes", "nonfinite_rows", "shed_rows",
                "dead_letter_rows", "outbound_rows", "sealed_bytes")


def _run_schedule(pkg, root, faults_mod):
    inst = _instance(pkg, root / pkg)
    inst.start()
    try:
        dm = inst.device_management
        dm.create_device_type(token="sensor", name="S")
        for i in range(4):
            dm.create_device(token=f"d-{i}", device_type="sensor")
            dm.create_device_assignment(device=f"d-{i}")
        d = inst.dispatcher
        # a transient step fault: the full-set retry commits every row
        faults_mod.device_inject("device.dispatch", times=1)
        d.ingest_wire_lines(_lines([1.0, 2.0, 3.0], 1_754_600_000))
        d.flush()
        faults_mod.device_clear()
        # three poison rows among clean ones, on two devices
        faults_mod.device_inject("device.dispatch", times=None,
                                 when_nonfinite=True)
        d.ingest_wire_lines(_lines(
            [4.0, float("nan"), 5.0, float("nan"), 6.0], 1_754_600_100))
        d.ingest_wire_lines(_lines(
            [7.0, float("inf"), 8.0], 1_754_600_200, token="d-1"))
        d.flush()
        faults_mod.device_clear()
        letters = [doc for doc in inst.list_dead_letters(limit=20)
                   if doc.get("kind") == "device-poison"]
        requeues = [inst.requeue_dead_letter(int(doc["offset"]))
                    for doc in letters]
        again = inst.requeue_dead_letter(int(letters[0]["offset"]))
        d.flush()
        inst.event_store.flush()
        snap = inst.metrics.snapshot()
        ledger = inst.usage_ledger.snapshot()
        out = {
            "counters": {k: int(v) for k, v in snap["counters"].items()
                         if k.startswith(("device.fault.",
                                          "pipeline.quarantine."))},
            "quarantined": snap["gauges"].get(
                "pipeline.quarantine.devices"),
            "letters": [_jsonable(doc) for doc in letters],
            "requeues": requeues,
            "again": again,
            "committed": d.journal_reader.committed,
            "device_fault": d.metrics_snapshot()["device_fault"],
            "ledger": {t["tenant_id"]: {c: t["usage"][c]
                                        for c in ROW_COUNTERS}
                       for t in ledger["tenants"]},
            "ledger_totals": {c: ledger["totals"][c] for c in ROW_COUNTERS},
            "state": inst.device_state.current,
        }
        inst.stop()
        out["rows"] = _stored_rows(inst.event_store)
    finally:
        inst.terminate()
    return out


@pytest.fixture(scope="module")
def schedule(tmp_path_factory):
    root = tmp_path_factory.mktemp("schedule")
    return {"jax": _run_schedule("jax", root, ref_faults),
            "torch": _run_schedule("torch", root, port_faults)}


def test_fault_counters_equal_the_reference(schedule):
    ref, got = schedule["jax"], schedule["torch"]
    assert got["counters"] == ref["counters"]
    assert got["counters"]["device.fault.step_faults"] == 2
    assert got["counters"]["device.fault.poison_rows"] == 3
    assert got["quarantined"] == ref["quarantined"] == 1
    assert got["device_fault"] == ref["device_fault"]


def test_poison_letters_equal_the_reference(schedule):
    ref, got = schedule["jax"], schedule["torch"]
    assert got["letters"] == ref["letters"]
    assert sum(doc["count"] for doc in got["letters"]) == 3
    assert got["requeues"] == ref["requeues"]
    assert got["again"] == ref["again"] and got["again"]["already"]


def test_stored_rows_equal_the_reference(schedule):
    ref, got = schedule["jax"], schedule["torch"]
    np.testing.assert_array_equal(got["rows"], ref["rows"])
    # 3 + 3 + 2 clean rows, the 3 requeued poison rows, and d-0's one
    # quarantine STATE_CHANGE (quarantine_after 2; d-1 sent one)
    assert len(got["rows"]) == 12
    assert got["committed"] == ref["committed"]


def test_state_equals_the_reference(schedule):
    assert_state_equal(schedule["jax"]["state"], schedule["torch"]["state"])


def test_ledger_totals_equal_the_reference(schedule):
    ref, got = schedule["jax"], schedule["torch"]
    assert got["ledger"] == ref["ledger"]
    assert got["ledger_totals"] == ref["ledger_totals"]
    assert got["ledger_totals"]["dead_letter_rows"] == 3.0


# ---------------------------------------------------------------------------
# the watchdog on a live instance, under a fake clock
# ---------------------------------------------------------------------------

def _watchdog_run(pkg, root):
    inst = _instance(pkg, root / pkg)
    inst.start()
    try:
        dm = inst.device_management
        dm.create_device_type(token="sensor", name="S")
        dm.create_device(token="d-0", device_type="sensor")
        dm.create_device_assignment(device="d-0")
        d = inst.dispatcher
        clock = FakeClock()
        d.watchdog._clock = clock
        unhealthy = []
        step = d._packed_step

        def wedged(*args):
            # the loop thread's idle tick sees the dispatch in flight
            # past each budget (time moves only here)
            clock.advance(1.5)
            d.watchdog.check()
            clock.advance(10.0)
            d.watchdog.check()
            unhealthy.append(d.device_unhealthy)
            return step(*args)

        d._packed_step = wedged
        d.ingest_wire_lines(_lines([1.0], 1_754_600_000))
        d.flush()
        d._packed_step = step
        snap = d.watchdog.snapshot()
        c = inst.metrics.snapshot()["counters"]
        out = {
            "soft": snap["softTrips"], "hard": snap["hardTrips"],
            "unhealthy_while_wedged": unhealthy,
            "unhealthy_after": snap["unhealthy"],
            "counters": {k: int(v) for k, v in c.items()
                         if k.startswith("device.fault.watchdog")},
            "anomalies": int(c.get("flightrec.anomalies", 0)),
        }
        inst.event_store.flush()
        out["stored"] = inst.event_store.total_events
    finally:
        inst.terminate()
    return out


def test_watchdog_trips_and_recovers_as_the_reference(tmp_path):
    ref = _watchdog_run("jax", tmp_path)
    got = _watchdog_run("torch", tmp_path)
    assert got == ref
    assert got["soft"] == 1 and got["hard"] == 1
    assert got["unhealthy_while_wedged"] == [True]
    assert got["unhealthy_after"] is False
    assert got["anomalies"] >= 2 and got["stored"] == 1


# ---------------------------------------------------------------------------
# sticky CUDA errors fail closed
# ---------------------------------------------------------------------------

class _AcceleratorLike(RuntimeError):
    def __init__(self, msg, code):
        super().__init__(msg)
        self.error_code = code


@pytest.mark.parametrize("exc, sticky", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
    (RuntimeError("CUDA error: device-side assert triggered"), True),
    (RuntimeError("CUDA error: unspecified launch failure"), True),
    (_AcceleratorLike("CUDA error: misaligned address", 716), True),
    (_AcceleratorLike("some driver text", 700), True),
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"), False),
    (RuntimeError("CUDA error: invalid argument"), False),
    (port_faults.FaultInjected("injected device fault"), False),
    (ValueError("device-side assert"), False),
])
def test_sticky_errors_are_classified(exc, sticky):
    assert is_sticky_cuda_error(exc) is sticky


class _FatalExit(BaseException):
    """Stands in for the fail-closed process exit in-process."""


@pytest.fixture
def exits(monkeypatch):
    """Replace the fail-closed exit with an exception carrying its code;
    yields the codes seen."""
    from sitewhere_tpu_torch.runtime import dispatcher as port_dispatcher

    codes = []

    def fake_exit(code):
        codes.append(code)
        raise _FatalExit(code)

    monkeypatch.setattr(port_dispatcher, "_exit_process", fake_exit)
    return codes


@pytest.mark.parametrize("exc, card", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"), True),
    (torch.OutOfMemoryError("CUDA out of memory."), True),
    (RuntimeError("CUDA error: invalid configuration argument"), True),
    (RuntimeError("pip kernel launch failed: CUDA error 9"), True),
    (_AcceleratorLike("out of resources", 701), True),
    (port_faults.FaultInjected("injected device fault"), False),
    (RuntimeError("shape mismatch in step"), False),
    (ValueError("CUDA error: not raised by the runtime"), False),
])
def test_card_errors_are_classified(exc, card):
    assert is_card_error(exc) is card


@pytest.mark.parametrize("exc", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    RuntimeError("CUDA error: invalid configuration argument"),
    RuntimeError("pip kernel launch failed: CUDA error 9"),
], ids=["oom", "launch-config", "kernel-launch"])
def test_card_error_fails_closed_without_bisecting(tmp_path, exits, exc):
    """A step that fails on every subset with a card error: no bisection,
    no poison letter, the fail-closed exit once."""
    inst = port_bench.make_instance(str(tmp_path / "card"), CPU)
    inst.start()
    try:
        port_bench.register(inst)
        d = inst.dispatcher
        step, calls = d._packed_step, []

        def failing(*args):
            calls.append(1)
            raise exc

        d._packed_step = failing
        with pytest.raises(_FatalExit):
            d.ingest_wire_lines(port_bench.Traffic().payload())
        d._packed_step = step
        c = inst.metrics.snapshot()["counters"]
        assert exits == [STICKY_EXIT_CODE]
        assert len(calls) == 1
        assert c.get("device.fault.bisect_rounds", 0) == 0
        assert c.get("device.fault.poison_rows", 0) == 0
        assert not [doc for doc in inst.list_dead_letters(limit=50)
                    if doc.get("kind") == "device-poison"]
    finally:
        inst.terminate()


def test_fallback_level_fails_closed_on_a_card(tmp_path, exits):
    """The breaker's FALLBACK level moves nothing to the CPU on a card:
    it fails closed, uncounted.  On the CPU the dispatcher's own step is
    the CPU step, counted."""
    import types

    inst = port_bench.make_instance(str(tmp_path / "fallback"), CPU)
    try:
        d = inst.dispatcher
        plan = types.SimpleNamespace(seq=7, n_events=64)
        fallback = "device.fault.cpu_fallback_steps"
        assert d._fallback_step(plan) is d._packed_step
        assert inst.metrics.snapshot()["counters"][fallback] == 1
        d.device = torch.device("cuda")
        with pytest.raises(_FatalExit):
            d._fallback_step(plan)
        assert exits == [STICKY_EXIT_CODE]
        assert inst.metrics.snapshot()["counters"][fallback] == 1
    finally:
        d.device = CPU
        inst.terminate()


_STICKY_CHILD = textwrap.dedent('''
    import json, sys
    sys.path.insert(0, {tools!r})
    import torch_devfault_bench as bench
    from sitewhere_tpu_torch.runtime import faults

    inst = bench.make_instance({data_dir!r}, "cpu")
    inst.start()
    bench.register(inst)
    inst.checkpointer.save()
    traffic = bench.Traffic()
    inst.dispatcher.ingest_wire_lines(traffic.payload())
    inst.dispatcher.flush()
    faults.device_inject("device.dispatch", exc=RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    inst.dispatcher.ingest_wire_lines(traffic.payload())
    print("survived", flush=True)
''')


def test_sticky_error_exits_and_the_restart_recovers(tmp_path):
    data_dir = str(tmp_path / "sticky")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _STICKY_CHILD.format(
            tools=os.path.join(ROOT, "tools"), data_dir=data_dir)],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == STICKY_EXIT_CODE, proc.stderr[-2000:]
    assert "survived" not in proc.stdout
    assert "failing closed" in proc.stderr
    inst = port_bench.make_instance(data_dir, CPU)
    try:
        assert inst.restored
        letters = inst.list_dead_letters(limit=50)
        assert not [d for d in letters if d.get("kind") == "device-poison"]
        snaps = [s["reason"] for s in inst.flightrec.snapshots()]
        assert "device-lost" in snaps
        inst.start()
        inst.dispatcher.flush()
        inst.event_store.flush()
        # the first payload was committed and stored before the fault;
        # the second was journaled and replays: nothing lost, nothing
        # twice
        assert inst.event_store.total_events == 2 * port_bench.WIDTH
        c = inst.metrics.snapshot()["counters"]
        assert c.get("device.fault.cpu_fallback_steps", 0) == 0
        assert c.get("device.fault.poison_rows", 0) == 0
    finally:
        inst.terminate()


def test_shard_containment_equals_the_reference(tmp_path):
    """The reference's ``shard_containment`` phase (4 shards of its
    virtual CPU mesh) and the port's (4 shards on ``cpu``): the same
    report, and the port's FALLBACK leg side-steps shard 2's rows
    through the mesh while the healthy shards keep chaining."""
    check, ref_fail = _checker()
    try:
        ref = ref_bench.phase_shard_containment(str(tmp_path / "jax"), check)
    finally:
        ref_faults.device_clear()
    check, port_fail = _checker()
    try:
        got = port_bench.phase_shard_containment(str(tmp_path / "torch"),
                                                 check, CPU)
    finally:
        port_faults.device_clear()
    assert ref_fail == [] and port_fail == []
    for key in ("n_shards", "ring_depth", "poison_rows", "stored",
                "expected_stored", "shard_levels", "ring_chains",
                "dead_letter_rows"):
        assert got[key] == ref[key], key
    assert got["flightrec_dump"] is not None
    assert got["fallback_side_steps"] == 4 == got["cpu_fallback_steps"]
    assert got["fallback_stored"] == 4 * port_bench.WIDTH
    assert got["fallback_ring_chains"] == 2
