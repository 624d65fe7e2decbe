"""Auto-registration and command delivery on the port's wire path, against
the JAX package's, on the CPU.

One reference ``Instance`` and one port ``Instance`` (width 64, 1024
slots, ``registration.default_device_type: sensor``, 40 sensors created
through ``DeviceManagement``) take the same traffic:

- payload A (40 lines), then payload B (48 lines, two of them from
  unknown devices), so B straddles two plans: the ghosts' plan re-decodes
  all of B and replays every row the plan did not process itself, the
  rows B left for the next plan among them, so those are stored twice
  (a property of the reference, kept);
- ``create_command_invocation`` for a ``set-rate`` and a ``ping``, each
  delivered once; an invocation naming an unknown command (undelivered,
  dead-lettered); a device's ``CommandResponse`` correlating with its
  invocation by the invocation token;
- an NDJSON payload holding a command line among measurements: the
  record is not one JSON document, so the command dead-letters as
  ``undeliverable-invocation``;
- a single-document event from an unknown device (registered, replayed);
- with the default device type cleared, a payload from unknown devices:
  they are rejected (``registration.rejected``), not dead-lettered.

Stored rows, dispatcher totals, registered devices and assignments, dead
letters and delivered executions are equal between the packages (the
minted invocation tokens aside).
"""

import json

import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.commands import decode_binary_execution
from sitewhere_tpu_torch.instance import Instance as PortInstance
from sitewhere_tpu_torch.runtime.config import Config as PortConfig
from test_torch_device_management import normalize

torch.set_num_threads(1)

WIDTH, CAP, SENSORS = 64, 1024, 40
T0_MS = 1_753_800_000_000


def config(pkg, data_dir):
    tree = {
        "instance": {"id": "registration-wire", "data_dir": str(data_dir)},
        "pipeline": {"width": WIDTH, "registry_capacity": CAP,
                     "mtype_slots": 4, "deadline_ms": 60_000.0,
                     "adaptive_deadline": False, "ring_depth": 0},
        "checkpoint": {"interval_s": 0},
        "events": {"compact_interval_s": 0},
        "registration": {"default_device_type": "sensor"},
    }
    if pkg == "jax":
        from sitewhere_tpu.runtime.config import Config

        tree["presence"] = {"scan_interval_s": 3600.0,
                            "missing_after_s": 1800}
        return Config(tree, apply_env=False)
    return PortConfig(tree, apply_env=False)


def measurement(token, i, value):
    return json.dumps({"deviceToken": token, "type": "DeviceMeasurements",
                       "request": {"name": "temp", "value": value,
                                   "eventDate": T0_MS + 1000 * i}})


def payload(lines):
    return "\n".join(lines).encode()


def traffic_a_b(rng):
    a = [measurement(f"s-{d}", i, float(rng.integers(0, 80)))
         for i, d in enumerate(rng.permutation(SENSORS))]
    b = [measurement(f"s-{d}", 100 + i, float(rng.integers(0, 80)))
         for i, d in enumerate(rng.integers(0, SENSORS, 48))]
    # the ghosts land in B's first 24 lines: the plan A fills
    b[5] = measurement("x-1", 105, 1.0)
    b[17] = measurement("x-2", 117, 2.0)
    return payload(a), payload(b)


def run_package(pkg, root):
    rng = np.random.default_rng(20261017)
    if pkg == "jax":
        from sitewhere_tpu.commands import (
            BinaryCommandEncoder, CallbackDeliveryProvider,
            CommandDestination, TopicParameterExtractor)
        from sitewhere_tpu.ingest.decoders import JsonDecoder
        from sitewhere_tpu.instance import Instance

        inst = Instance(config(pkg, root / pkg))
    else:
        from sitewhere_tpu_torch.commands import (
            BinaryCommandEncoder, CallbackDeliveryProvider,
            CommandDestination, TopicParameterExtractor)
        from sitewhere_tpu_torch.ingest.decoders import JsonDecoder

        inst = PortInstance(config(pkg, root / pkg), device="cpu")
    dm = inst.device_management
    inst.identity.mtype.mint("temp")
    dm.create_device_type(token="sensor", name="Sensor")
    dm.create_device_type(token="gateway", name="Gateway")
    dm.create_device_command("sensor", token="ping", name="ping")
    dm.create_device_command(
        "sensor", token="set-rate", name="setRate", namespace="sw",
        parameters=[("rate", "int32", True), ("unit", "string", False)])
    for d in range(SENSORS):
        dm.create_device(token=f"s-{d}", device_type="sensor")
        dm.create_device_assignment(token=f"a-s-{d}", device=f"s-{d}")
    delivered = []
    inst.commands.add_destination(CommandDestination(
        "callback", BinaryCommandEncoder(), TopicParameterExtractor(),
        CallbackDeliveryProvider(lambda ex, data, params: delivered.append(
            (ex.invocation.token, ex.command_name, params["topic"], data)))))
    inst.start()
    disp = inst.dispatcher
    out = {}
    try:
        a, b = traffic_a_b(rng)
        disp.ingest_wire_lines(a)
        disp.ingest_wire_lines(b)
        disp.flush()
        out["straddle"] = dict(disp.totals)

        # explicit event times: the default is the wall clock
        t_s = T0_MS // 1000
        inv1 = inst.create_command_invocation(
            "a-s-3", "set-rate", {"rate": "5", "unit": "hz"},
            ts_s=t_s + 200)["token"]
        inv2 = inst.create_command_invocation("a-s-4", "ping",
                                              ts_s=t_s + 201)["token"]
        inst.create_command_invocation("a-s-5", "no-such-command",
                                       ts_s=t_s + 202)
        # the device answers the first invocation, naming its token
        resp = json.dumps({
            "deviceToken": "s-3", "type": "commandResponse",
            "request": {"originatingEventId": inv1, "response": "ok",
                        "eventDate": T0_MS + 500_000}}).encode()
        disp.ingest(JsonDecoder()(resp)[0], payload=resp)
        disp.ingest_wire_lines(payload([
            measurement("s-6", 300, 10.0),
            json.dumps({"deviceToken": "s-7", "type": "commandinvocation",
                        "request": {"commandToken": "ping",
                                    "eventDate": T0_MS + 301_000}}),
            measurement("s-8", 302, 11.0)]))
        single = json.dumps({"deviceToken": "x-3", "type": "DeviceMeasurements",
                             "request": {"name": "temp", "value": 3.0,
                                         "eventDate": T0_MS + 400_000}}
                            ).encode()
        disp.ingest(JsonDecoder()(single)[0], payload=single)
        disp.flush()
        inst.registration.default_device_type = None
        disp.ingest_wire_lines(payload([measurement("x-4", 500, 4.0),
                                        measurement("s-9", 501, 5.0),
                                        measurement("x-5", 502, 6.0)]))
        disp.flush()
        out["totals"] = dict(disp.totals)
        out["registration"] = (inst.registration.registered,
                               inst.registration.rejected)
        out["handles"] = {t: inst.identity.invocation.lookup(t)
                          for t in (inv1, inv2)}
        out["devices"] = normalize(dm.devices)
        asg = normalize(list(dm.assignments.values()))
        for doc in asg:
            if not doc["token"].startswith("a-s-"):
                doc.pop("token")      # minted per process
        out["assignments"] = asg
        out["mirror"] = {k: np.asarray(getattr(inst.mirror, k)).copy()
                         for k in ("active", "tenant_id", "device_type_id",
                                   "assignment_status")}
        inst.stop()
        out["rows"] = stored_rows(inst.event_store)
        out["dead"] = [json.loads(raw) for _, raw in
                       inst.dead_letters.scan(0)]
    finally:
        inst.terminate()
    tokens = {inv1: "inv-1", inv2: "inv-2"}
    out["delivered"] = []
    for token, name, topic, data in delivered:
        doc = decode_binary_execution(data)
        assert doc.pop("invocation") == token
        out["delivered"].append((tokens.get(token), name, topic, doc))
    out["inv_tokens"] = tokens
    return out


def stored_rows(store):
    keys = []
    for c in store.iter_chunks():
        keys.append(np.stack([np.asarray(c[k], np.int64) for k in (
            "device_id", "event_type", "ts_s", "ts_ns", "mtype_id",
            "command_id", "assignment_id", "device_type_id")]
            + [np.asarray(c["value"], np.float32).view(np.int32)
               .astype(np.int64)], axis=1))
    rows = np.concatenate(keys)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = tmp_path_factory.mktemp("registration-wire")
    return {pkg: run_package(pkg, root) for pkg in ("jax", "torch")}


def test_straddled_payload_replays_as_the_reference(both):
    ref, got = both["jax"]["straddle"], both["torch"]["straddle"]
    assert got == ref
    # two ghosts, and every row B left for the next plan: stored twice
    assert got["unregistered"] == 2
    assert got["replayed"] > 2
    assert got["accepted"] == 40 + 48 + got["replayed"] - 2 == ref["accepted"]


def test_totals_and_registration_equal_the_reference(both):
    ref, got = both["jax"], both["torch"]
    assert got["totals"] == ref["totals"]
    assert got["registration"] == ref["registration"]
    registered, rejected = got["registration"]
    assert registered == 3            # x-1, x-2, then x-3's single event
    assert rejected >= 2              # x-4 and x-5, with no default type
    assert got["totals"]["commands"] == 4


def test_stored_rows_equal_the_reference(both):
    ref, got = both["jax"]["rows"], both["torch"]["rows"]
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    assert len(got) == both["torch"]["totals"]["accepted"]


def test_registered_devices_equal_the_reference(both):
    ref, got = both["jax"], both["torch"]
    assert got["devices"] == ref["devices"]
    assert sorted(t for t in got["devices"] if t.startswith("x-")) == [
        "x-1", "x-2", "x-3"]
    assert got["assignments"] == ref["assignments"]
    for k in got["mirror"]:
        assert got["mirror"][k].tobytes() == ref["mirror"][k].tobytes(), k


def _neutral(dead, tokens):
    out = []
    for doc in dead:
        doc = dict(doc)
        if "invocation" in doc:
            doc["invocation"] = tokens.get(doc["invocation"], "minted")
        out.append(doc)
    return out


def test_dead_letters_equal_the_reference(both):
    ref, got = both["jax"], both["torch"]
    a = _neutral(ref["dead"], ref["inv_tokens"])
    b = _neutral(got["dead"], got["inv_tokens"])
    assert b == a
    kinds = [d["kind"] for d in b]
    # the NDJSON command line, and the unknown command
    assert kinds.count("undeliverable-invocation") == 1
    assert kinds.count("undelivered-command") == 1
    # rejected ghosts are not dead-lettered
    assert "unregistered" not in kinds


def test_deliveries_equal_the_reference(both):
    ref, got = both["jax"]["delivered"], both["torch"]["delivered"]
    assert got == ref
    assert [(t, n) for t, n, _, _ in got] == [("inv-1", "setRate"),
                                              ("inv-2", "ping")]
    assert got[0][3]["parameters"] == {"rate": 5, "unit": "hz"}
    assert got[0][2] == "sitewhere/command/s-3"


def test_command_response_correlates_with_its_invocation(both):
    for pkg in ("jax", "torch"):
        out = both[pkg]
        handle = out["handles"][next(iter(out["inv_tokens"]))]
        assert handle >= 0
        rows = out["rows"]
        # event types: 3 invocation, 4 response; column 5 is command_id
        inv = rows[(rows[:, 1] == 3) & (rows[:, 5] == handle)]
        resp = rows[(rows[:, 1] == 4) & (rows[:, 5] == handle)]
        assert len(inv) == 1 and len(resp) == 1
    assert both["torch"]["handles"].values().__len__() == 2


def test_concurrent_invocations_each_deliver_once(tmp_path):
    """Invocations from several threads at once (a REST front end's
    handler threads), each flushing the dispatcher while the others
    ingest: every one is delivered exactly once, with the parameters it
    was made with."""
    import sys
    import threading

    from sitewhere_tpu_torch.commands import (
        BinaryCommandEncoder, CallbackDeliveryProvider, CommandDestination,
        TopicParameterExtractor)

    inst = PortInstance(config("torch", tmp_path), device="cpu")
    dm = inst.device_management
    dm.create_device_type(token="sensor", name="Sensor")
    dm.create_device_command(
        "sensor", token="set-rate", name="setRate", namespace="sw",
        parameters=[("rate", "int32", True)])
    for d in range(8):
        dm.create_device(token=f"s-{d}", device_type="sensor")
        dm.create_device_assignment(token=f"a-s-{d}", device=f"s-{d}")
    delivered, lock = [], threading.Lock()

    def deliver(ex, data, params):
        with lock:
            delivered.append((ex.invocation.token, decode_binary_execution(
                data)["parameters"]["rate"]))

    inst.commands.add_destination(CommandDestination(
        "callback", BinaryCommandEncoder(), TopicParameterExtractor(),
        CallbackDeliveryProvider(deliver)))
    made, errors = {}, []

    def operator(t):
        try:
            for k in range(5):
                rate = 10 * t + k
                out = inst.create_command_invocation(
                    f"a-s-{t}", "set-rate", {"rate": rate},
                    ts_s=T0_MS // 1000 + rate)
                with lock:
                    made[out["token"]] = rate
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    switch = sys.getswitchinterval()
    inst.start()
    try:
        sys.setswitchinterval(1e-5)
        threads = [threading.Thread(target=operator, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
        assert not any(t.is_alive() for t in threads)
        inst.dispatcher.flush()
        totals = dict(inst.dispatcher.totals)
    finally:
        sys.setswitchinterval(switch)
        inst.stop()
        inst.terminate()
    assert errors == []
    assert len(made) == 40
    assert sorted(delivered) == sorted(made.items())
    assert totals["commands"] == totals["accepted"] == 40




def run_straddled_record(root, monkeypatch, cached, certify):
    """Payload A, then B with a ghost in each of the two plans B
    straddles; registration keeps ``cached`` re-decoded records and,
    with ``certify`` off, decodes each record whole.  Returns the totals,
    registered count, stored rows, the registration leg's timer and the
    number of lines the scalar decoder decoded for B and for an aligned
    payload after it."""
    from sitewhere_tpu_torch.ingest import columnar, decoders
    from sitewhere_tpu_torch.runtime import dispatcher as dispatcher_mod

    decodes = []

    def counting(decode):
        def wrapped(*args):
            decodes.append(args[0])
            return decode(*args)
        return wrapped

    monkeypatch.setattr(decoders, "_decode_one",
                        counting(decoders._decode_one))
    monkeypatch.setattr(columnar, "_decode_one",
                        counting(columnar._decode_one))
    monkeypatch.setattr(dispatcher_mod, "_REDECODED_RECORDS", cached)
    if not certify:
        monkeypatch.setattr(columnar, "certified_event_lines",
                            lambda payload: None)
    inst = PortInstance(config("torch", root), device="cpu")
    dm = inst.device_management
    inst.identity.mtype.mint("temp")
    dm.create_device_type(token="sensor", name="Sensor")
    for d in range(SENSORS):
        dm.create_device(token=f"s-{d}", device_type="sensor")
        dm.create_device_assignment(token=f"a-s-{d}", device=f"s-{d}")
    a, b = traffic_a_b(np.random.default_rng(20261017))
    lines = b.split(b"\n")
    lines[30] = measurement("x-3", 130, 3.0).encode()   # B's second plan
    inst.start()
    try:
        disp = inst.dispatcher
        disp.ingest_wire_lines(a)
        decodes.clear()                  # the intake's own decode aside
        disp.ingest_wire_lines(b"\n".join(lines))
        disp.flush()
        straddled = len(decodes)
        # a payload that fills one plan alone, one ghost in it
        decodes.clear()
        c = [measurement(f"s-{d % SENSORS}", 200 + d, 1.0)
             for d in range(WIDTH)]
        c[9] = measurement("x-4", 209, 4.0)
        disp.ingest_wire_lines(payload(c))
        disp.flush()
        aligned = len(decodes)
        totals = dict(disp.totals)
        leg = disp.metrics.timer("pipeline.egress_registration_s")
        registered = inst.registration.registered
        inst.stop()
        rows = stored_rows(inst.event_store)
    finally:
        inst.terminate()
    return (totals, registered, rows, (leg.count, leg.total),
            (straddled, aligned))


def test_straddled_record_decodes_once(tmp_path, monkeypatch):
    """Both plans of a straddled payload re-decode it for registration.
    The dispatcher keeps the record, so each line is decoded at most
    once, and only the lines a plan needs when the C scanner certifies
    the record (a payload filling its plan alone: the ghost's line);
    replays and stored rows are those of decoding the whole record in
    every plan."""
    runs = []
    for name, cached, certify in (("fresh", 0, False), ("kept", 2, False),
                                  ("lazy", 2, True)):
        with monkeypatch.context() as mp:
            runs.append(run_straddled_record(tmp_path / name, mp, cached,
                                             certify))
    fresh, kept, lazy = runs
    assert fresh[4] == (2 * 48, WIDTH) and kept[4] == (48, WIDTH)
    assert lazy[4][0] <= 48 and lazy[4][1] == 1
    for totals, registered, rows, (legs, leg_s), _ in (fresh, kept, lazy):
        assert totals["unregistered"] == 4 and registered == 4
        assert legs == 3 and leg_s > 0
        assert len(rows) == totals["accepted"]
        # the rows each plan did not process replay (the reference's
        # straddle duplicates)
        assert totals["replayed"] > 3
    for run in (kept, lazy):
        assert run[0] == fresh[0]
        np.testing.assert_array_equal(run[2], fresh[2])
