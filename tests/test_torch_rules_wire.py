"""The rule engine on the port's wire path, against the JAX package's, on
the CPU.

- The same NDJSON with the same tenant programs through the port
  ``Instance`` and the JAX ``Instance``: the program-alert rows (as a
  multiset) and the stored rows (a multiset of each row's identity:
  device, type, time, measurement, value bits, alert code and level)
  are equal, and stored = accepted + built-in derived + program alerts.
  Each payload fits one plan and is settled (flush, engine drain, flush)
  before the next, so both packages see the same plan boundaries.
- ``inject_rule_alerts`` steps the pipeline on the engine's worker
  thread; with CUDA streams mocked on the CPU, the step's code sees the
  dispatcher's stream, never the engine's.
- A restart restores the ``rule-programs`` section; ``rules.*`` keys are
  honoured and a default config composes the engine.
"""

import collections
import os

import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.instance import Instance as PortInstance
from sitewhere_tpu_torch.rules import compile as port_compile
from sitewhere_tpu_torch.rules import engine as port_engine
from sitewhere_tpu_torch.runtime.config import Config as PortConfig
from test_torch_rules import KEYS, program_doc
from torch_parity import WIRE_MTYPES, WIRE_TS0_MS, wire_payload

torch.set_num_threads(1)

SEED = 20261016
WIDTH, CAP, M, DEVICES = 64, 128, 4, 100
PAYLOADS = 4


def config(pkg, data_dir, **extra):
    tree = {
        "instance": {"id": "rules-wire", "data_dir": str(data_dir)},
        "pipeline": {"width": WIDTH, "registry_capacity": CAP,
                     "mtype_slots": M, "deadline_ms": 60_000.0,
                     "adaptive_deadline": False, "ring_depth": 0},
        "checkpoint": {"interval_s": 0},
        "events": {"compact_interval_s": 0},
        **extra,
    }
    if pkg == "jax":
        from sitewhere_tpu.runtime.config import Config

        tree["presence"] = {"scan_interval_s": 3600.0,
                            "missing_after_s": 1800}
        return Config(tree, apply_env=False)
    return PortConfig(tree, apply_env=False)


def program_docs():
    """Three programs of each structure key, all in the default tenant."""
    rng = np.random.default_rng(SEED)
    return [program_doc(key, f"{key}-{j}", rng)
            for key in KEYS for j in range(3)]


def alert_types():
    return ("overheat",) + tuple(f"byo.{k}.{i}" for k in KEYS
                                 for i in range(3))


def make_instance(pkg, data_dir, **extra):
    if pkg == "jax":
        from sitewhere_tpu.instance import Instance
        from sitewhere_tpu.schema import AssignmentStatus, ComparisonOp

        inst = Instance(config(pkg, data_dir, **extra))
    else:
        from sitewhere_tpu_torch.schema import AssignmentStatus, ComparisonOp

        inst = PortInstance(config(pkg, data_dir, **extra), device="cpu")
    return inst, AssignmentStatus, ComparisonOp


def seed_world(inst, status, ops, programs=True):
    ident = inst.identity
    assert ident.tenant.mint("default") == 0
    for name in WIRE_MTYPES:
        ident.mtype.mint(name)
    for name in alert_types():
        ident.alert_type.mint(name)
    for i in range(DEVICES):
        d = ident.device.mint(f"dev-{i}")
        inst.mirror.set_device_row(
            d, active=True, tenant_id=0, device_type_id=i % 3,
            assignment_id=i, assignment_status=int(status.ACTIVE),
            area_id=i % 4, customer_id=i % 5, asset_id=i % 7)
    inst.rules.create_rule("temp", ops.GT, 95.0, "overheat", token="r-hot")
    if programs:
        eng = inst.rule_engine
        eng.attributes.set_many("device", np.arange(DEVICES), "tier",
                                np.arange(DEVICES) % 4)
        eng.attributes.set_many("asset", np.arange(7), "grade",
                                np.arange(7) % 3)
        for doc in program_docs():
            eng.put_program(0, doc)


def settle(inst):
    """Every row egressed and stored, every program alert injected."""
    for _ in range(3):
        inst.dispatcher.flush()
        inst.rule_engine.drain()
    inst.dispatcher.flush()


def stored_rows(store):
    keys = []
    for c in store.iter_chunks():
        keys.append(np.stack([
            np.asarray(c["device_id"], np.int64),
            np.asarray(c["event_type"], np.int64),
            np.asarray(c["ts_s"], np.int64),
            np.asarray(c["ts_ns"], np.int64),
            np.asarray(c["mtype_id"], np.int64),
            np.asarray(c["value"], np.float32).view(np.int32).astype(np.int64),
            np.asarray(c["alert_code"], np.int64),
            np.asarray(c["alert_level"], np.int64)], axis=1))
    rows = np.concatenate(keys) if keys else np.zeros((0, 8), np.int64)
    return rows[np.lexsort(rows.T[::-1])]


def run_package(pkg, root):
    inst, status, ops = make_instance(pkg, root / pkg)
    seed_world(inst, status, ops)
    alerts = []
    inject = inst.rule_engine.inject

    def recording(cols):
        alerts.extend(zip(*(np.asarray(cols[k]).tolist() for k in (
            "device_id", "ts_s", "ts_ns", "alert_code", "alert_level"))))
        return inject(cols)

    inst.rule_engine.inject = recording
    inst.start()
    rng = np.random.default_rng(SEED + 1)
    try:
        for k in range(PAYLOADS):
            inst.dispatcher.ingest_wire_lines(
                wire_payload(rng, WIDTH, WIRE_TS0_MS + 1000 * k, ghosts=0.0))
            settle(inst)
        totals = dict(inst.dispatcher.totals)
        committed = inst.dispatcher.journal_reader.committed
        inst.stop()
        rows = stored_rows(inst.event_store)
    finally:
        inst.terminate()
    return {"alerts": sorted(alerts), "totals": totals, "rows": rows,
            "committed": committed}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = tmp_path_factory.mktemp("rules-wire")
    return {pkg: run_package(pkg, root) for pkg in ("jax", "torch")}


def test_program_alerts_equal_the_reference(both):
    ref, got = both["jax"], both["torch"]
    assert got["alerts"] == ref["alerts"]
    assert len(got["alerts"]) > 20
    assert got["totals"]["rule_program_alerts"] == len(got["alerts"]) \
        == ref["totals"]["rule_program_alerts"]


def test_stored_rows_equal_the_reference(both):
    ref, got = both["jax"], both["torch"]
    assert got["rows"].shape == ref["rows"].shape
    np.testing.assert_array_equal(got["rows"], ref["rows"])
    assert got["committed"] == ref["committed"] == PAYLOADS


def test_stored_is_accepted_plus_derived_plus_program_alerts(both):
    got = both["torch"]
    t = got["totals"]
    program = t["rule_program_alerts"]
    builtin = t["derived_alerts"] - program
    assert builtin > 0 and program > 0
    lines = PAYLOADS * WIDTH
    assert t["accepted"] == lines - t["unregistered"] - t["unassigned"] \
        + builtin + program
    assert len(got["rows"]) == t["accepted"]
    # every program alert was stored exactly once: the stored alert rows
    # with a program's code are the engine's alerts, as multisets
    byo = np.arange(1, len(alert_types()))
    rows = got["rows"]
    mine = rows[(rows[:, 1] == 2) & np.isin(rows[:, 6], byo)]
    stored = collections.Counter(
        tuple(r) for r in mine[:, [0, 2, 3, 6, 7]].tolist())
    assert stored == collections.Counter(got["alerts"])
    assert sum(stored.values()) == program


class _FakeStreams:
    """Thread-local "current stream" stand-in for ``torch.cuda``."""

    def __init__(self):
        import threading

        self.local = threading.local()

    def current(self, *args, **kw):
        return getattr(self.local, "stream", "dispatcher-stream")

    def stream(self, s):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            prev = self.current()
            self.local.stream = s
            try:
                yield
            finally:
                self.local.stream = prev

        return ctx()


def test_injected_alert_step_runs_on_the_dispatchers_stream(
        tmp_path, monkeypatch):
    import threading

    fakes = _FakeStreams()
    monkeypatch.setattr(port_engine, "_new_stream", lambda device: "engine")
    monkeypatch.setattr(torch.cuda, "stream", fakes.stream)
    monkeypatch.setattr(torch.cuda, "current_stream", fakes.current)
    seen = {"step": [], "eval": []}
    real_eval = port_compile.rules_group_eval

    def eval_spy(*args, **kw):
        seen["eval"].append(torch.cuda.current_stream())
        return real_eval(*args, **kw)

    monkeypatch.setattr(port_compile, "rules_group_eval", eval_spy)
    inst, status, ops = make_instance("torch", tmp_path)
    seed_world(inst, status, ops, programs=False)
    inst.rule_engine.put_program(0, {
        "token": "always", "alert": {"type": "overheat"},
        "when": {"pred": "value", "op": "gt", "value": -1e9}})
    disp = inst.dispatcher
    real_step = disp._packed_step

    def step_spy(*args):
        seen["step"].append((threading.current_thread().name,
                             torch.cuda.current_stream()))
        return real_step(*args)

    inst.start()
    disp._packed_step = step_spy
    try:
        rng = np.random.default_rng(SEED + 2)
        disp.ingest_wire_lines(wire_payload(
            rng, WIDTH, WIRE_TS0_MS, kinds=("m",), p=(1.0,), ghosts=0.0))
        settle(inst)
    finally:
        inst.stop()
        inst.terminate()
    assert seen["eval"] and set(seen["eval"]) == {"engine"}
    on_engine = [s for name, s in seen["step"] if name.endswith("-eval")]
    # the 64 alerts fill a plan, which steps inside inject, on the
    # engine's worker thread, on the dispatcher's stream
    assert on_engine and set(on_engine) == {"dispatcher-stream"}
    assert {s for _, s in seen["step"]} == {"dispatcher-stream"}
    assert disp.totals["rule_program_alerts"] >= WIDTH


def test_restart_restores_rule_programs(tmp_path):
    inst, status, ops = make_instance("torch", tmp_path)
    seed_world(inst, status, ops)
    inst.rule_engine.attributes.set("device", 5, "tier", 9)
    before = inst.rule_engine.registry.snapshot_payload()
    n = inst.rule_engine.registry.program_count()
    inst.start()
    inst.stop()
    inst.terminate()
    ckpt = os.listdir(tmp_path / "checkpoint")
    assert any(f.startswith("rule-programs-") for f in ckpt)
    again, _, _ = make_instance("torch", tmp_path)
    try:
        assert again.restored
        eng = again.rule_engine
        assert eng.registry.program_count() == n == 3 * len(KEYS)
        assert eng.registry.snapshot_payload()[0] == before[0]
        assert eng.attributes.columns("device") == {"tier": 0}
        _, arrays = eng.attributes.snapshot_payload()
        assert arrays["device"][5, 0] == 9 and arrays["device"][6, 0] == 2
        assert eng.registry.current_epoch() is not None
    finally:
        again.terminate()


def test_rules_config_is_honoured(tmp_path):
    default, _, _ = make_instance("torch", tmp_path / "a")
    try:
        assert default.rule_engine is not None
        assert default.dispatcher.rules_engine is default.rule_engine
        assert default.rule_engine.inject == \
            default.dispatcher.inject_rule_alerts
    finally:
        default.terminate()
    off, _, _ = make_instance(
        "torch", tmp_path / "b",
        rules={"programs_enabled": False, "queue_depth": 8})
    try:
        assert off.rule_engine is None
        assert off.dispatcher.rules_engine is None
    finally:
        off.terminate()
    sized, _, _ = make_instance(
        "torch", tmp_path / "c",
        rules={"programs_per_tenant": 2, "asset_capacity": 64})
    try:
        assert sized.rule_engine.registry.programs_per_tenant == 2
        assert sized.rule_engine.attributes._host["asset"].shape[0] == 64
    finally:
        sized.terminate()
