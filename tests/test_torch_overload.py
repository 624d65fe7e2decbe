"""Overload admission in the port against the reference.

- The reference's own ``tests/test_overload.py`` cases that need neither
  the mesh nor a component the port lacks (the state machine, admission
  and its buckets, the optional/fan-out ladder, and the dispatcher's
  admission through an ``Instance``), run against the port with their
  imports rewritten.
- One schedule through both ``Instance``s on the CPU: eight tenants, one
  of them noisy, mixed telemetry / alert / command payloads, the ladder
  driven by explicit signal samples on a fake clock through NORMAL,
  DEGRADED, SHEDDING, EMERGENCY and back.  Compared exactly: the
  transitions with their drivers, the shed counts by class and tenant,
  the Retry-After hints, the ``intake-shed`` letters, the stored rows and
  the ledger's per-tenant totals.
- A fill-direct reservation is admitted or shed, whole, before it is
  adopted, in both packages.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.runtime import overload as port_overload
from torch_parity import port_test_module, reference_cases, run_port_case

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(TESTS, "test_overload.py")

CASES = reference_cases(REF)
# the overload bench case drives the port's bench, on the CPU
EDITS = (
    ('"tools", "overload_bench.py")', '"tools", "torch_overload_bench.py")'),
    ("result = mod.run(width=64, duration_s=0.2, multipliers=(1.0, 4.0),",
     "result = mod.run(device='cpu', width=64, duration_s=0.2, "
     "multipliers=(1.0, 4.0),"),
)


@pytest.fixture(scope="module")
def port_ns():
    return port_test_module(REF, replace=EDITS)


def test_the_port_runs_the_reference_admission_cases():
    assert len(CASES) >= 28
    assert sum(c.startswith("TestProtocolBackpressure.")
               for c in CASES) == 6
    assert "TestDispatcherAdmission.test_full_shed_raises_dead_letters_" \
        "and_skips_journal" in CASES
    assert "TestOverloadBenchSmoke.test_tool_reports_curve_and_never_" \
        "sheds_alerts" in CASES


@pytest.mark.parametrize("case", CASES)
def test_reference_overload_case_on_the_port(port_ns, case, tmp_path):
    run_port_case(port_ns, case, tmp_path)


# ---------------------------------------------------------------------------
# one schedule through both Instances
# ---------------------------------------------------------------------------

TENANTS = [f"t-{i}" for i in range(8)]
NOISY = "t-0"


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _instance(pkg, data_dir, **overload):
    tree = {
        "instance": {"id": "ov-parity", "data_dir": str(data_dir)},
        "pipeline": {"width": 64, "registry_capacity": 128,
                     "mtype_slots": 4, "deadline_ms": 5.0, "n_shards": 1,
                     "ring_depth": 0},
        "checkpoint": {"interval_s": 0},
        "events": {"compact_interval_s": 0},
        # small budgets, so a few dozen rows exercise every rung
        "overload": {"degraded_telemetry_rate_per_s": 20.0,
                     "degraded_telemetry_burst": 12.0, **overload},
        "slo": {"enabled": False},
        "presence": {"scan_interval_s": 3600.0, "missing_after_s": 1800},
    }
    if pkg == "jax":
        from sitewhere_tpu.instance import Instance
        from sitewhere_tpu.runtime.config import Config

        return Instance(Config(tree, apply_env=False))
    from sitewhere_tpu_torch.instance import Instance
    from sitewhere_tpu_torch.runtime.config import Config

    return Instance(Config(tree, apply_env=False), device="cpu")


def _line(token, kind, i, ts0=1_753_800_000):
    if kind == "m":
        return json.dumps({"deviceToken": token, "type": "Measurement",
                           "request": {"name": "temp", "value": float(i),
                                       "eventDate": ts0 + i}})
    if kind == "a":
        return json.dumps({"deviceToken": token, "type": "Alert",
                           "request": {"type": "overheat",
                                       "level": "warning",
                                       "message": "hot",
                                       "eventDate": ts0 + i}})
    return json.dumps({"deviceToken": token, "type": "CommandInvocation",
                       "request": {"commandToken": "ping",
                                   "eventDate": ts0 + i}})


def _payload(tenant, n, ts0, kinds="mmmma"):
    token = f"d-{TENANTS.index(tenant)}"
    return "\n".join(_line(token, kinds[i % len(kinds)], i, ts0)
                     for i in range(n)).encode()


def _stored_rows(store):
    keys = []
    for c in store.iter_chunks():
        keys.append(np.stack([
            np.asarray(c[k], np.int64) for k in (
                "device_id", "tenant_id", "event_type", "ts_s",
                "mtype_id", "alert_code")], axis=1))
    rows = np.concatenate(keys) if keys else np.zeros((0, 6), np.int64)
    return rows[np.lexsort(rows.T[::-1])]


def _run_schedule(pkg, root):
    if pkg == "jax":
        from sitewhere_tpu.ingest.decoders import JsonLinesDecoder
        from sitewhere_tpu.runtime.overload import (
            OverloadShed,
            OverloadSignals,
        )
    else:
        from sitewhere_tpu_torch.ingest.decoders import JsonLinesDecoder
        from sitewhere_tpu_torch.runtime.overload import (
            OverloadShed,
            OverloadSignals,
        )
    inst = _instance(pkg, root / pkg)
    ov = inst.overload
    clock = FakeClock()
    ov._clock = clock
    ov.signals_fn = None          # the schedule drives the ladder
    transitions = []
    ov.on_transition(lambda old, new, sig: transitions.append(
        [old.name, new.name, ov.last_driver]))
    inst.start()
    decoder = JsonLinesDecoder()
    outcomes = []
    try:
        dm = inst.device_management
        dm.create_device_type(token="sensor", name="S")
        for i, tenant in enumerate(TENANTS):
            dm.create_device(token=f"d-{i}", device_type="sensor")
            dm.create_device_assignment(device=f"d-{i}")
        d = inst.dispatcher
        ts = [1_753_800_000]

        def send(tenant, n, kinds="mmmma"):
            payload = _payload(tenant, n, ts[0], kinds)
            ts[0] += 1000
            reqs = decoder(payload)
            for r in reqs:
                r.metadata = dict(r.metadata or {}, tenant=tenant)
            try:
                d.ingest_many(reqs, payload, source_id=f"src-{tenant}")
                outcomes.append([tenant, "ok"])
            except OverloadShed as e:
                outcomes.append([tenant, "shed", e.priority_class.name,
                                 e.state.name, e.retry_after_s])
            d.flush()

        def round_of_traffic():
            for tenant in TENANTS:
                send(tenant, 40 if tenant == NOISY else 10)

        def observe(**signals):
            for _ in range(2):            # confirm_samples: 2
                clock.t += 0.1
                ov.observe(OverloadSignals(**signals))

        round_of_traffic()                                 # NORMAL
        observe(seal_lag_s=0.2)                            # DEGRADED
        round_of_traffic()
        clock.t += 0.5                                     # refill
        round_of_traffic()
        observe(seal_lag_s=0.6)                            # SHEDDING
        round_of_traffic()
        send(NOISY, 6, kinds="c")                          # commands
        observe(seal_lag_s=3.0)                            # EMERGENCY
        send(NOISY, 6, kinds="c")
        send("t-3", 5, kinds="a")                          # critical
        # calm: one cooldown below the exit watermarks -> NORMAL
        for _ in range(3):
            clock.t += 1.0
            ov.observe(OverloadSignals())
        round_of_traffic()
        inst.event_store.flush()
        snap = inst.metrics.snapshot()["counters"]
        ledger = inst.usage_ledger.snapshot(
            resolve=inst.identity.tenant.token_of)
        letters = [{k: v for k, v in doc.items() if k != "offset"}
                   for doc in inst.list_dead_letters(limit=200)
                   if doc.get("kind") in ("intake-shed", "tenant-budget")]
        out = {
            "transitions": transitions,
            "outcomes": outcomes,
            "shed_total": ov.shed_total,
            "admitted_total": ov.admitted_total,
            "counters": {k: int(v) for k, v in snap.items()
                         if k.startswith(("overload.", "tenant.shed.",
                                          "tenant.budget."))},
            "letters": letters,
            "ledger": {t["tenant"]: {c: t["usage"][c] for c in (
                "rows", "state_writes", "shed_rows", "dead_letter_rows")}
                for t in ledger["tenants"]},
            "state": ov.state.name,
            "tenant_ids": {t: int(inst.identity.tenant.lookup(t))
                           for t in TENANTS},
        }
        inst.stop()
        out["rows"] = _stored_rows(inst.event_store)
    finally:
        inst.terminate()
    return out


@pytest.fixture(scope="module")
def schedule(tmp_path_factory):
    root = tmp_path_factory.mktemp("overload")
    return {"jax": _run_schedule("jax", root),
            "torch": _run_schedule("torch", root)}


def test_ladder_transitions_equal_the_reference(schedule):
    ref, got = schedule["jax"], schedule["torch"]
    assert got["transitions"] == ref["transitions"]
    assert [t[1] for t in got["transitions"]] == [
        "DEGRADED", "SHEDDING", "EMERGENCY", "NORMAL"]
    assert got["state"] == "NORMAL"


def test_sheds_and_retry_after_equal_the_reference(schedule):
    ref, got = schedule["jax"], schedule["torch"]
    assert got["outcomes"] == ref["outcomes"]
    assert got["shed_total"] == ref["shed_total"] > 0
    assert got["admitted_total"] == ref["admitted_total"]
    assert got["counters"] == ref["counters"]
    # the noisy tenant sheds in DEGRADED while a quiet one does not
    assert got["counters"]["tenant.shed.t-0"] > \
        got["counters"].get("tenant.shed.t-5", 0)
    # CRITICAL rows were never shed, not even in EMERGENCY
    assert got["counters"]["overload.shed.critical"] == 0
    assert ["t-3", "ok"] in got["outcomes"]


def test_shed_letters_equal_the_reference(schedule):
    ref, got = schedule["jax"], schedule["torch"]
    assert got["letters"] == ref["letters"]
    assert {d["kind"] for d in got["letters"]} == {"intake-shed"}


def test_stored_rows_equal_the_reference(schedule):
    np.testing.assert_array_equal(schedule["torch"]["rows"],
                                  schedule["jax"]["rows"])


def test_ledger_tenant_totals_equal_the_reference(schedule):
    ref, got = schedule["jax"], schedule["torch"]
    assert got["ledger"] == ref["ledger"]
    # accepted rows are billed exactly: a tenant's billed rows are its
    # stored rows (no rule fires here, so every stored row was accepted)
    rows = got["rows"]
    for tenant, tid in got["tenant_ids"].items():
        assert got["ledger"][tenant]["rows"] == float(
            (rows[:, 1] == tid).sum())
    shed = sum(u["shed_rows"] for u in got["ledger"].values())
    assert shed == got["shed_total"]


# ---------------------------------------------------------------------------
# the fill-direct reservation is admitted or shed before it is adopted
# ---------------------------------------------------------------------------

def _reservation_run(pkg, root):
    if pkg == "jax":
        from sitewhere_tpu.runtime.overload import OverloadShed, OverloadState
    else:
        from sitewhere_tpu_torch.runtime.overload import (
            OverloadShed,
            OverloadState,
        )
    inst = _instance(pkg, root / pkg)
    inst.start()
    try:
        dm = inst.device_management
        dm.create_device_type(token="sensor", name="S")
        dm.create_device(token="d-0", device_type="sensor")
        dm.create_device_assignment(device="d-0")
        d = inst.dispatcher
        payload = "\n".join(_line("d-0", "m", i) for i in range(64)).encode()
        inst.overload.force(OverloadState.SHEDDING)
        cols, host = d.decode_wire_lines(payload)
        reserved = type(cols).__name__
        with pytest.raises(OverloadShed) as exc:
            d.ingest_wire_decoded(payload, cols, host, source_id="wire-1")
        shed = {"reserved": reserved,
                "class": exc.value.priority_class.name,
                "journal_end": inst.ingest_journal.end_offset,
                "pending": inst.batcher.pending,
                "steps": d.steps,
                "letters": [{k: v for k, v in doc.items() if k != "offset"}
                            for doc in inst.list_dead_letters(limit=10)]}
        inst.overload.force(OverloadState.NORMAL)
        d.ingest_wire_lines(payload)
        d.flush()
        inst.event_store.flush()
        shed["stored_after"] = inst.event_store.total_events
    finally:
        inst.stop()
        inst.terminate()
    return shed


def test_reservation_is_shed_before_adoption(tmp_path):
    ref = _reservation_run("jax", tmp_path)
    got = _reservation_run("torch", tmp_path)
    assert got == ref
    assert got["reserved"] == "Reservation"
    assert got["class"] == "TELEMETRY"
    assert got["journal_end"] == 0 and got["pending"] == 0
    assert got["letters"][0]["classes"] == {"telemetry": 64}
    assert got["stored_after"] == 64


def test_port_overload_module_is_the_reference_surface():
    from sitewhere_tpu.runtime import overload as ref

    assert port_overload.__all__ == ref.__all__
    assert tuple(int(c) for c in port_overload.CLASS_OF_EVENT_TYPE) == \
        tuple(int(c) for c in ref.CLASS_OF_EVENT_TYPE)
    assert port_overload.Watermarks() == port_overload.Watermarks(
        **{k: getattr(ref.Watermarks(), k)
           for k in ref.Watermarks.__dataclass_fields__})
