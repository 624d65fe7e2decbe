"""The port's checkpointer against the JAX package's, on the CPU.

- the CRC-framed section format: round trip, the corruption matrix, and
  a section written by either package read by the other;
- torn-generation fallback, unsupported section versions skipped, and
  the restore tolerance rules (unknown fields skipped, a field of another
  shape keeps its empty init, the EWMA statistics dropped together);
- after the same NDJSON stream through both dispatchers (the composition
  of ``torch_parity.wire_world``), the mirror and state npz arrays, the
  identity JSON and the rules section that each package's
  ``Checkpointer.save`` writes are equal (ints exact, EWMAs within the
  parity bound of ``torch_parity``, other floats bitwise); the JAX side
  saves through a duck-typed instance with the attributes ``save()``
  reads;
- a port ``Instance`` restored from its checkpoint holds state bitwise
  equal to what was saved, and the first packed read after restore sees
  the restored epoch.
"""

import json
import os
import pickle
import types

import numpy as np
import pytest
import torch

from sitewhere_tpu.runtime import checkpoint as ref_ckpt
from sitewhere_tpu_torch.instance import Instance, refuse_unsupported
from sitewhere_tpu_torch.runtime import checkpoint as port_ckpt
from sitewhere_tpu_torch.runtime.config import Config
from sitewhere_tpu_torch.schema import AssignmentStatus
from torch_parity import (
    WIRE_TS0_MS,
    assert_ewma_close,
    wire_payload,
    wire_world,
)

torch.set_num_threads(1)

SEED = 20261016
CKPT = {"jax": ref_ckpt, "torch": port_ckpt}


# -- framed sections ----------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("torch", "torch"), ("torch", "jax"),
                                           ("jax", "torch")])
def test_framed_section_round_trip_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "s.swsnap")
    payload = os.urandom(3000)
    CKPT[writer].write_framed(path, {"component": "c", "version": 3,
                                     "as_of": 17}, payload)
    header, got = CKPT[reader].read_framed(path, component="c")
    assert got == payload
    assert header == {"component": "c", "version": 3, "as_of": 17}
    with open(path, "rb") as f:
        assert f.read(8) == port_ckpt.SNAP_MAGIC == ref_ckpt.SNAP_MAGIC


def _corrupt(kind, data):
    if kind == "magic":
        return b"XX" + data[2:]
    if kind == "truncated_header":
        return data[:len(port_ckpt.SNAP_MAGIC) + 3]
    if kind == "truncated_payload":
        return data[:-5]
    if kind == "crc":
        return data[:-1] + bytes([data[-1] ^ 0x40])
    if kind == "header_json":
        head = len(port_ckpt.SNAP_MAGIC) + 8
        return data[:head] + b"{" + data[head + 1:]
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["magic", "truncated_header",
                                  "truncated_payload", "crc", "header_json",
                                  "component", "missing"])
def test_framed_section_corruption_raises_snapshot_corrupt(tmp_path, kind):
    path = str(tmp_path / "s.swsnap")
    port_ckpt.write_framed(path, {"component": "c", "version": 1}, b"x" * 64)
    if kind == "missing":
        os.remove(path)
    elif kind != "component":
        data = open(path, "rb").read()
        if kind == "header_json":
            # keep the CRC valid over a broken header: rewrite the frame
            head = b"{not json"
            payload = b"x" * 64
            with open(path, "wb") as f:
                f.write(port_ckpt.SNAP_MAGIC)
                for blob in (head, payload):
                    f.write(port_ckpt._FRAME.pack(
                        len(blob), __import__("zlib").crc32(blob)))
                    f.write(blob)
        else:
            open(path, "wb").write(_corrupt(kind, data))
    with pytest.raises(port_ckpt.SnapshotCorrupt):
        port_ckpt.read_framed(path, component="other" if kind == "component"
                              else "c")


# -- instances on the CPU -------------------------------------------------------

CAP, WIDTH, M = 128, 64, 4


def config(root, **pipeline):
    return Config({
        "instance": {"id": "ckpt", "data_dir": str(root)},
        "pipeline": {"width": WIDTH, "registry_capacity": CAP,
                     "mtype_slots": M, "deadline_ms": 60_000.0,
                     "adaptive_deadline": False, "max_zones": 4,
                     "max_zone_verts": 8, **pipeline},
        "checkpoint": {"interval_s": 0},
        "events": {"compact_interval_s": 0},
    }, apply_env=False)


def seed_instance(inst, n=100):
    """Devices, a rule and a zone, written through the instance's own
    components (what a restore must bring back)."""
    from sitewhere_tpu_torch.schema import ComparisonOp, ZoneCondition

    inst.identity.tenant.mint("default")
    inst.identity.mtype.mint("temp")
    for i in range(n):
        d = inst.identity.device.mint(f"dev-{i}")
        inst.mirror.set_device_row(
            d, active=True, tenant_id=0, device_type_id=i % 3,
            assignment_id=i, assignment_status=int(AssignmentStatus.ACTIVE),
            area_id=i % 4)
    inst.rules.create_rule("temp", ComparisonOp.GT, 80.0, "hot",
                           token="r-hot")
    inst.mirror.set_zone_row(
        1, active=True, tenant_id=-1, area_id=-1,
        verts_lonlat=np.asarray([[0, 0], [10, 0], [10, 10], [0, 10]],
                                np.float32),
        condition=int(ZoneCondition.ALERT_IF_INSIDE),
        alert_code=inst.identity.alert_type.mint("zone"))


def payloads(n=4, seed=SEED):
    rng = np.random.default_rng(seed)
    return [wire_payload(rng, WIDTH, WIRE_TS0_MS + 1000 * i, ghosts=0.0)
            for i in range(n)]


def halt(inst):
    """Stop an instance's threads WITHOUT its final checkpoint (what a
    crash leaves: the saved generations only)."""
    for child in reversed(inst.children):
        child.stop()
    inst.ingest_journal.close()
    inst.dead_letters.close()


def host_state(inst):
    return inst.device_state.snapshot_host()


def assert_host_state_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.fixture
def saved(tmp_path):
    """A stopped instance that ingested a stream: its final checkpoint and
    the state it held."""
    inst = Instance(config(tmp_path / "data"), device="cpu")
    seed_instance(inst)
    inst.start()
    for p in payloads():
        inst.dispatcher.ingest_wire_lines(p)
    inst.dispatcher.flush()
    state = host_state(inst)
    tokens = inst.identity.device.tokens()
    inst.stop()
    inst.terminate()
    return tmp_path / "data", state, tokens


def test_restore_is_bitwise_equal_to_the_saved_state(saved):
    root, state, tokens = saved
    assert state["last_event_ts_s"].max() > 0
    inst = Instance(config(root), device="cpu")
    try:
        assert inst.restored and inst.checkpointer.restored_generation == 0
        assert_host_state_bitwise(host_state(inst), state)
        assert inst.identity.device.tokens() == tokens
        assert inst.rules.get_rule("r-hot").threshold == 80.0
        assert inst.mirror.z_hi == 2 and inst.mirror._zones_dirty
        # the packed carry the next step reads is the restored epoch
        packed = inst.device_state.current_packed
        from sitewhere_tpu_torch.pipeline.packed import unpack_state

        restored = unpack_state(packed)
        for k, arr in state.items():
            assert getattr(restored, k).numpy().tobytes() == arr.tobytes(), k
    finally:
        inst.terminate()


def test_restore_drops_a_cached_packed_carry(saved):
    """A packed twin cached before the restore's commit must not survive
    it: the first lease reads the restored epoch."""
    root, state, _ = saved
    # build, cache a packed carry of the empty epoch, then restore
    inst = Instance(config(root / "fresh"), device="cpu")
    inst.device_state.current_packed
    inst.data_dir = str(root)
    ck = port_ckpt.Checkpointer(inst, interval_s=0)
    assert ck.restore()
    packed, _ = inst.device_state.lease_packed()
    from sitewhere_tpu_torch.pipeline.packed import unpack_state

    got = unpack_state(packed)
    for k, arr in state.items():
        assert getattr(got, k).numpy().tobytes() == arr.tobytes(), k
    inst.terminate()


def test_torn_generation_falls_back_to_the_previous_complete(tmp_path):
    root = tmp_path / "data"
    inst = Instance(config(root), device="cpu")
    seed_instance(inst)
    inst.start()
    inst.checkpointer.save()                     # gen 0
    gen0 = host_state(inst)
    for p in payloads(2):
        inst.dispatcher.ingest_wire_lines(p)
    inst.dispatcher.flush()
    inst.checkpointer.save()                     # gen 1
    assert host_state(inst)["last_event_ts_s"].max() > 0
    halt(inst)
    # tear gen 1's state section: the whole generation is abandoned
    path = root / "checkpoint" / "state-00000001.npz"
    data = path.read_bytes()
    path.write_bytes(data[:len(data) // 2])
    again = Instance(config(root), device="cpu")
    try:
        assert again.restored
        assert again.checkpointer.restored_generation == 0
        assert_host_state_bitwise(host_state(again), gen0)
        assert again.checkpointer.replay_floor == 0
    finally:
        again.terminate()


def test_unsupported_section_versions_are_skipped(tmp_path, caplog):
    root = tmp_path / "data"
    inst = Instance(config(root), device="cpu")
    seed_instance(inst)
    inst.checkpointer.register_provider(port_ckpt.StateProvider(
        name="extra", snapshot_fn=lambda: (b"v9", None),
        restore_fn=lambda h, p: None, version=9))
    inst.checkpointer.save()
    inst.terminate()
    # rewrite the stores section with a version no reader speaks
    ck = root / "checkpoint"
    header, payload = port_ckpt.read_framed(str(ck / "stores-00000000.swsnap"))
    header["version"] = 99
    port_ckpt.write_framed(str(ck / "stores-00000000.swsnap"), header, payload)
    seen = []
    again = Instance(config(root), device="cpu")
    again.checkpointer.register_provider(port_ckpt.StateProvider(
        name="extra", snapshot_fn=lambda: (b"", None),
        restore_fn=lambda h, p: seen.append(p), version=1))
    try:
        assert again.checkpointer.restore()
        assert seen == []                           # version 9 skipped
        assert "extra" not in again.checkpointer.restored_offsets
        assert "stores" not in again.checkpointer.restored_offsets
        assert again.rules.list_rules() == []       # stores skipped
        assert again.identity.device.lookup("dev-5") == 5
    finally:
        again.terminate()


def test_state_restore_tolerance(tmp_path):
    """Unknown fields are skipped; a field of another shape keeps its
    empty init; without the EWMAs the last values and their times are
    dropped too, so the fold seeds again."""
    root = tmp_path / "data"
    inst = Instance(config(root), device="cpu")
    seed_instance(inst)
    inst.start()
    for p in payloads(2):
        inst.dispatcher.ingest_wire_lines(p)
    inst.dispatcher.flush()
    inst.checkpointer.save()
    saved = host_state(inst)
    halt(inst)
    path = root / "checkpoint" / "state-00000000.npz"
    z = dict(np.load(path))
    z["not_a_field"] = np.zeros(3)
    z["last_lat"] = np.zeros(CAP + 1, np.float32)
    del z["ewma_values"]
    with open(path, "wb") as f:
        np.savez(f, **z)
    again = Instance(config(root), device="cpu")
    try:
        got = host_state(again)
        empty = Instance(config(tmp_path / "empty"), device="cpu")
        blank = host_state(empty)
        empty.terminate()
        for k in ("last_lat", "ewma_values", "last_values",
                  "last_value_ts_s", "last_value_ts_ns"):
            assert got[k].tobytes() == blank[k].tobytes(), k
        for k in ("last_event_ts_s", "last_lon", "last_event_type"):
            assert got[k].tobytes() == saved[k].tobytes(), k
    finally:
        again.terminate()


# -- the sections each package writes after the same stream ---------------------


class _Stub:
    """A management store the instance lacks: empty containers."""

    _lock = None

    def __init__(self, keys):
        for k in keys:
            setattr(self, k, {})


def duck_instance(world, data_dir, pkg):
    """The attributes ``Checkpointer.save`` reads, over a wire world."""
    if pkg == "jax":
        from sitewhere_tpu.runtime.config import Config as Cfg
        stores = {attr: _Stub(keys) for attr, keys in
                  ref_ckpt._STORE_ATTRS.items() if attr != "rules"}
    else:
        Cfg, stores = Config, {}
    dl = world.journal.__class__(str(data_dir), name="dead-letters")
    return types.SimpleNamespace(
        data_dir=str(data_dir), dispatcher=world.disp,
        ingest_journal=world.journal, mirror=world.mirror,
        device_state=world.state, identity=world.identity,
        rules=world.rules, config=Cfg(apply_env=False), dead_letters=dl,
        **stores)


@pytest.fixture(scope="module")
def both_saved(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt-parity")
    rng = np.random.default_rng(SEED + 5)
    stream = [wire_payload(rng, 64, WIRE_TS0_MS + 1000 * i) for i in range(4)]
    out = {}
    for pkg in ("jax", "torch"):
        world = wire_world(pkg, root / pkg, 2)
        for p in stream:
            world.disp.ingest_wire_lines(p)
        world.disp.flush()
        inst = duck_instance(world, root / pkg / "data", pkg)
        ck = CKPT[pkg].Checkpointer(inst, interval_s=0)
        ck.save()
        out[pkg] = types.SimpleNamespace(world=world, dir=ck.dir,
                                         committed=world.reader.committed)
        inst.dead_letters.close()
    return out


def _npz(d, name):
    with np.load(os.path.join(d, name)) as z:
        return {k: np.array(z[k]) for k in z.files}


def test_manifests_name_the_same_sections(both_saved):
    ref, got = both_saved["jax"], both_saved["torch"]
    assert got.committed == ref.committed == 4
    a = json.load(open(os.path.join(ref.dir, "MANIFEST.json")))
    b = json.load(open(os.path.join(got.dir, "MANIFEST.json")))
    for key in ("generation", "files", "version", "offsets", "committed",
                "journal_end"):
        assert a[key] == b[key], key
    assert sorted(os.listdir(ref.dir)) == sorted(os.listdir(got.dir))


def test_mirror_section_equals_the_reference(both_saved):
    name = "mirror-00000000.npz"
    a = _npz(both_saved["jax"].dir, name)
    b = _npz(both_saved["torch"].dir, name)
    assert sorted(a) == sorted(b)
    assert sorted(b) == sorted(port_ckpt._MIRROR_ARRAYS + ("epoch", "z_hi"))
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("field", [
    "last_event_ts_s", "last_event_ts_ns", "last_event_type", "last_lat",
    "last_lon", "last_elevation", "last_location_ts_s", "last_location_ts_ns",
    "last_alert_code", "last_alert_ts_s", "last_alert_ts_ns",
    "presence_missing", "nonfinite_count", "last_values", "last_value_ts_s",
    "last_value_ts_ns", "ewma_values"])
def test_state_section_equals_the_reference(both_saved, field):
    name = "state-00000000.npz"
    a = _npz(both_saved["jax"].dir, name)
    b = _npz(both_saved["torch"].dir, name)
    assert sorted(a) == sorted(b)
    assert a[field].dtype == b[field].dtype
    assert a[field].shape == b[field].shape
    if field == "ewma_values":
        assert_ewma_close(a[field], b[field])
    else:
        assert a[field].tobytes() == b[field].tobytes()
    if field == "last_event_ts_s":
        assert (b[field] > 0).sum() > 50


def test_identity_section_equals_the_reference(both_saved):
    name = "identity-00000000.json"
    a = json.load(open(os.path.join(both_saved["jax"].dir, name)))
    b = json.load(open(os.path.join(both_saved["torch"].dir, name)))
    assert a == b
    assert len(b["device"]["id_to_token"]) == 100


def test_rules_section_equals_the_reference(both_saved):
    def rules(d):
        header, payload = port_ckpt.read_framed(
            os.path.join(d, "stores-00000000.swsnap"), component="stores")
        return header, pickle.loads(payload)["rules"]

    (ha, ra), (hb, rb) = rules(both_saved["jax"].dir), rules(
        both_saved["torch"].dir)
    assert ha == hb
    assert ra["_slots"] == rb["_slots"] and ra["_free"] == rb["_free"]
    assert sorted(ra["_rules"]) == sorted(rb["_rules"])
    stamps = ("created_s", "updated_s")    # wall-clock creation times
    for token, rule in ra["_rules"].items():
        a = {k: v for k, v in vars(rule).items() if k not in stamps}
        b = {k: v for k, v in vars(rb["_rules"][token]).items()
             if k not in stamps}
        assert a == b, token


def test_unsupported_config_is_refused(tmp_path):
    # the reference builds no connector from a config key either
    for tree in ({"web": {"port": 8081}},
                 {"outbound": {"connectors": [{"id": "x"}]}}):
        with pytest.raises(NotImplementedError):
            refuse_unsupported(Config(tree, apply_env=False))
    refuse_unsupported(config(tmp_path))
    # the sharded pipeline and the step-interface switch are the
    # Instance's since the mesh came
    refuse_unsupported(Config({"pipeline": {"n_shards": 2,
                                            "packed_step": False}},
                              apply_env=False))
    # the control plane's sections are the Instance's since devguard and
    # the control plane came
    refuse_unsupported(Config({"overload": {"enabled": False},
                               "metering": {"top_k": 8}},
                              apply_env=False))
    # the analytics section is the runner's since streaming analytics
    refuse_unsupported(Config({"analytics": {"max_queries": 8,
                                             "enabled": False}},
                              apply_env=False))
    # the sources section and the decode pool's keys are the Instance's
    # since the ingest sources came
    refuse_unsupported(Config({"sources": [{"type": "mqtt"}],
                               "ingest": {"decode_workers": 0,
                                          "decode_max_pending": 16}},
                              apply_env=False))
    # the presence section is the PresenceManager's since outbound,
    # search and presence came
    refuse_unsupported(Config({"presence": {"scan_interval_s": 60.0,
                                            "missing_after_s": 1800}},
                              apply_env=False))
    # the JWT secret and the batch pacing are the Instance's since the
    # tenant engines, users and batch operations came
    refuse_unsupported(Config({"security": {"jwt_secret": "s3cret"},
                               "batch": {"throttle_delay_ms": 5}},
                              apply_env=False))
    # the rpc and api sections are the Instance's since the multi-host
    # fabric came
    refuse_unsupported(Config({"rpc": {"server": {"enabled": True},
                                       "peers": ["a:1", "b:2"]},
                               "api": {"port": 9090}}, apply_env=False))
    for tree in ({"web": {"port": 8080}},
                 {"metrics": {"report_interval_s": 5.0}}):
        with pytest.raises(NotImplementedError):
            refuse_unsupported(Config(tree, apply_env=False))


# -- the stores section across packages ---------------------------------------

_STORE_KEYS = {
    "device_management": ("device_types", "devices", "assignments",
                          "area_types", "areas", "customer_types",
                          "customers", "zones", "device_groups", "alarms"),
    "assets": ("_types", "_assets"),
    "rules": ("_rules", "_slots", "_free"),
}


def seed_entities(inst, pkg):
    """The same entities through either package's own services."""
    if pkg == "jax":
        from sitewhere_tpu.schema import ComparisonOp
        from sitewhere_tpu.services.device_management import (
            DeviceGroupElement)
    else:
        from sitewhere_tpu_torch.schema import ComparisonOp
        from sitewhere_tpu_torch.services.device_management import (
            DeviceGroupElement)
    dm = inst.device_management
    dm.create_device_type(token="sensor", name="Sensor")
    dm.create_device_command(
        "sensor", token="set-rate", name="setRate", namespace="sw",
        parameters=[("rate", "int32", True), ("unit", "string", False)])
    dm.create_device_status("sensor", token="ok", code="ok", name="OK")
    dm.create_area_type(token="site", name="Site")
    dm.create_area(token="hq", area_type="site", name="HQ",
                   bounds=[(0.0, 0.0), (0.0, 1.0), (1.0, 1.0)])
    dm.create_customer_type(token="org", name="Org")
    dm.create_customer(token="acme", customer_type="org", name="Acme")
    inst.assets.create_asset_type("person", name="Person",
                                  category="person")
    inst.assets.create_asset("ada", name="Ada", asset_type="person",
                             metadata={"k": "v"})
    for i in range(6):
        dm.create_device(token=f"dev-{i}", device_type="sensor",
                         metadata={"i": str(i)})
        dm.create_device_assignment(
            token=f"a-{i}", device=f"dev-{i}", area="hq", customer="acme",
            asset="ada" if i == 0 else None)
    dm.release_device_assignment("a-5")
    dm.create_zone(token="z-1", area="hq", name="fence",
                   bounds=[(0.0, 0.0), (0.0, 10.0), (10.0, 10.0)],
                   condition="outside", alert_level=3)
    dm.create_device_group(token="g", name="G", roles=["fleet"])
    dm.add_device_group_elements("g", [DeviceGroupElement(device="dev-1",
                                                          roles=["r"])])
    dm.create_device_alarm(token="al-1", device="dev-2", message="hot")
    inst.rules.create_rule("temp", ComparisonOp.GT, 80.0, "hot",
                           token="r-hot")


def store_view(inst):
    from test_torch_device_management import normalize

    return {attr: {k: normalize(getattr(getattr(inst, attr), k))
                   for k in keys} for attr, keys in _STORE_KEYS.items()}


def _ref_instance(root):
    from sitewhere_tpu.instance import Instance as RefInstance
    from sitewhere_tpu.runtime.config import Config as RefConfig

    return RefInstance(RefConfig({
        "instance": {"id": "ckpt", "data_dir": str(root)},
        "pipeline": {"width": WIDTH, "registry_capacity": CAP,
                     "mtype_slots": M},
        "presence": {"scan_interval_s": 3600.0, "missing_after_s": 1800},
        "checkpoint": {"interval_s": 0},
    }, apply_env=False))


def _stores_file(d):
    return os.path.join(d, [f for f in os.listdir(d)
                            if f.startswith("stores-")][-1])


@pytest.fixture(scope="module")
def stores_both(tmp_path_factory):
    """A reference and a port instance holding the same entities, each
    saved once."""
    root = tmp_path_factory.mktemp("stores")
    ref = _ref_instance(root / "jax")
    seed_entities(ref, "jax")
    ref.checkpointer.save()
    port = Instance(config(root / "torch"), device="cpu")
    seed_entities(port, "torch")
    port.checkpointer.save()
    out = {"root": root,
           "jax": (store_view(ref), _stores_file(ref.checkpointer.dir)),
           "torch": (store_view(port), _stores_file(port.checkpointer.dir))}
    ref.terminate()
    port.terminate()
    return out


def test_stores_sections_hold_the_same_entities(stores_both):
    assert stores_both["torch"][0] == stores_both["jax"][0]
    assert len(stores_both["torch"][0]["device_management"]["devices"]) == 6


def test_port_stores_section_restores_into_the_reference(stores_both,
                                                         tmp_path):
    """The reference's own restore path (its unpickler, ``merge_store``)
    over the section the port wrote: the reference's classes come back,
    field for field."""
    view, path = stores_both["torch"]
    header, payload = ref_ckpt.read_framed(path, component="stores")
    assert header["version"] == ref_ckpt.STORES_VERSION
    # every class is written under the reference's module name
    assert b"sitewhere_tpu_torch" not in payload
    stores = ref_ckpt.Checkpointer._unpickle(payload, path)
    assert sorted(stores) == ["__engines__", "assets", "batch_ops",
                              "device_management", "rules", "schedules",
                              "tenants", "users"]
    # no tenant engine is up before start()
    assert stores.pop("__engines__") == {}
    ref = _ref_instance(tmp_path / "ref")
    try:
        for attr, values in stores.items():
            ref_ckpt.merge_store(getattr(ref, attr), values)
        assert store_view(ref) == view
        dev = ref.device_management.devices["dev-0"]
        assert type(dev).__module__ == \
            "sitewhere_tpu.services.device_management"
        rule = ref.rules._rules["r-hot"]
        assert type(rule.op).__module__ == "sitewhere_tpu.schema"
        # the reference's services work on what it restored
        assert ref.device_management.get_active_assignment("dev-1").token \
            == "a-1"
    finally:
        ref.terminate()


_STORES_PROBE = """
import json, sys
sys.modules["jax"] = None
sys.modules["sitewhere_tpu"] = None
import dataclasses
from sitewhere_tpu_torch.instance import Instance
from sitewhere_tpu_torch.runtime.config import Config
inst = Instance(Config(json.loads(sys.argv[1]), apply_env=False),
                device="cpu")
assert inst.restored
DATES = ("active_date_s", "released_date_s", "triggered_date_s",
         "acknowledged_date_s", "resolved_date_s")
def normalize(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"__class__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            if f.name in ("created_s", "updated_s"):
                continue
            v = getattr(obj, f.name)
            out[f.name] = (v is not None) if f.name in DATES else normalize(v)
        return out
    if isinstance(obj, dict):
        return {k: normalize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [normalize(v) for v in obj]
    return obj
view = {attr: {k: normalize(getattr(getattr(inst, attr), k)) for k in keys}
        for attr, keys in json.loads(sys.argv[2]).items()}
dm = inst.device_management
view["active_of_dev_1"] = dm.get_active_assignment("dev-1").token
view["active_of_dev_5"] = dm.get_active_assignment("dev-5")
bad = sorted(m for m, v in sys.modules.items() if v is not None
             and (m.startswith("jax") or m == "sitewhere_tpu"
                  or m.startswith("sitewhere_tpu.")))
inst.terminate()
print(json.dumps([view, bad]))
"""


def test_reference_stores_section_restores_into_the_port_without_jax(
        stores_both, tmp_path):
    """A port instance whose newest generation carries the stores section
    a reference ``Instance`` wrote (users, tenants, schedules and batch
    operations among it, restored since the port composes them) restores
    it in a process where ``jax`` and ``sitewhere_tpu`` cannot be
    imported."""
    import shutil
    import subprocess
    import sys

    view, path = stores_both["jax"]
    data = tmp_path / "port"
    port = Instance(config(data), device="cpu")
    port.checkpointer.save()
    target = _stores_file(port.checkpointer.dir)
    port.terminate()
    shutil.copyfile(path, target)
    tree = config(data).as_dict()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _STORES_PROBE, json.dumps(tree),
         json.dumps(_STORE_KEYS)],
        cwd=repo, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got, bad = json.loads(proc.stdout.strip().splitlines()[-1])
    assert bad == []
    assert got.pop("active_of_dev_1") == "a-1"
    assert got.pop("active_of_dev_5") is None
    want = json.loads(json.dumps(view))      # tuples as JSON lists
    assert got == want


def test_stores_section_refuses_other_reference_globals():
    forged = (b"\x80\x04\x95\x00\x00\x00\x00\x00\x00\x00\x00\x8c\x16"
              b"sitewhere_tpu.instance\x94\x8c\x08Instance\x94\x93\x94.")
    with pytest.raises(port_ckpt.SnapshotCorrupt):
        port_ckpt.Checkpointer._unpickle(forged, "forged")
    # a record of a store the port composes loads as the port's class
    user = (b"\x80\x04\x95\x00\x00\x00\x00\x00\x00\x00\x00\x8c\x1c"
            b"sitewhere_tpu.security.users\x94\x8c\x04User\x94\x93\x94"
            b")\x81\x94.")
    from sitewhere_tpu_torch.security.users import User

    obj = port_ckpt.Checkpointer._unpickle(user, "user")
    assert type(obj) is User
