"""Tenant metering, quotas and tenant partitions in the port against the
reference.

- The reference's own ``tests/test_metering.py`` and
  ``tests/test_tenant_isolation.py`` cases (sketches, block attribution,
  the ledger and its checkpoint payload, the ladder integration, budget
  composition, the quota ladder, the partition rung ladder, and the
  ``tenant-budget`` dead letters through an ``Instance``), run against
  the port with their imports rewritten.
- The same traffic (eight tenants, one noisy, NaN rows among them)
  through both ``Instance``s: the ledger's per-tenant totals and the
  partition views are equal.
- Metering adds no host sync: host syncs per batch with it on equal the
  count with it off.
- The ``tenant-metering`` checkpoint section (JSON) restores across the
  packages both ways; the port's restore runs where ``jax`` and
  ``sitewhere_tpu`` cannot be imported.
- A tenant over ``metering.quota.eval_s_per_window`` is deprioritized
  (its rows skipped in the rule engine), then refused.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import port_test_module, reference_cases, run_port_case

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
REF_METERING = os.path.join(TESTS, "test_metering.py")
REF_ISOLATION = os.path.join(TESTS, "test_tenant_isolation.py")

METERING_CASES = reference_cases(REF_METERING)
ISOLATION_CASES = reference_cases(REF_ISOLATION)


@pytest.fixture(scope="module")
def metering_ns():
    return port_test_module(REF_METERING)


@pytest.fixture(scope="module")
def isolation_ns():
    return port_test_module(REF_ISOLATION)


@pytest.mark.parametrize("case", METERING_CASES)
def test_reference_metering_case_on_the_port(metering_ns, case, tmp_path):
    run_port_case(metering_ns, case, tmp_path)


@pytest.mark.parametrize("noisy_rows", [400, 4_000, 40_000])
@pytest.mark.parametrize("case", [
    c for c in ISOLATION_CASES
    if c.endswith("test_noisy_volume_never_penalizes_quiet_tenant")])
def test_reference_fairness_case_on_the_port(isolation_ns, case, tmp_path,
                                             noisy_rows):
    run_port_case(isolation_ns, case, tmp_path,
                  fixtures={"noisy_rows": noisy_rows})


@pytest.mark.parametrize("case", [
    c for c in ISOLATION_CASES
    if not c.endswith("test_noisy_volume_never_penalizes_quiet_tenant")])
def test_reference_isolation_case_on_the_port(isolation_ns, case, tmp_path):
    run_port_case(isolation_ns, case, tmp_path)


# ---------------------------------------------------------------------------
# the same traffic through both Instances
# ---------------------------------------------------------------------------

TENANTS = [f"t-{i}" for i in range(8)]
COUNTERS = ("rows", "state_writes", "nonfinite_rows", "shed_rows",
            "dead_letter_rows", "outbound_rows", "sealed_bytes")


def _tree(data_dir, **extra):
    return {
        "instance": {"id": "meter-parity", "data_dir": str(data_dir)},
        "pipeline": {"width": 64, "registry_capacity": 128,
                     "mtype_slots": 4, "deadline_ms": 60_000.0,
                     "adaptive_deadline": False, "ring_depth": 0},
        "checkpoint": {"interval_s": 0},
        "events": {"compact_interval_s": 0},
        "slo": {"enabled": False},
        **extra,
    }


def _instance(pkg, data_dir, **extra):
    tree = _tree(data_dir, **extra)
    if pkg == "jax":
        from sitewhere_tpu.instance import Instance
        from sitewhere_tpu.runtime.config import Config

        tree["presence"] = {"scan_interval_s": 3600.0,
                            "missing_after_s": 1800}
        return Instance(Config(tree, apply_env=False))
    from sitewhere_tpu_torch.instance import Instance
    from sitewhere_tpu_torch.runtime.config import Config

    return Instance(Config(tree, apply_env=False), device="cpu")


def _traffic(inst, decoder, seed=5, rounds=3):
    """Eight tenants (t-0 sends four times the others), a device each, a
    few NaN values; every payload carries its tenant."""
    rng = np.random.default_rng(seed)
    dm = inst.device_management
    dm.create_device_type(token="sensor", name="S")
    for i in range(len(TENANTS)):
        dm.create_device(token=f"d-{i}", device_type="sensor")
        dm.create_device_assignment(device=f"d-{i}")
    ts = 1_753_900_000
    for _ in range(rounds):
        for i, tenant in enumerate(TENANTS):
            n = 24 if i == 0 else 6
            values = rng.uniform(0, 50, n).round(2)
            values[rng.random(n) < 0.1] = np.nan
            payload = "\n".join(json.dumps({
                "deviceToken": f"d-{i}", "type": "Measurement",
                "request": {"name": "temp", "value": float(v),
                            "eventDate": ts + j}})
                for j, v in enumerate(values)).encode()
            ts += 100
            reqs = decoder(payload)
            for r in reqs:
                r.metadata = dict(r.metadata or {}, tenant=tenant)
            inst.dispatcher.ingest_many(reqs, payload)
    inst.dispatcher.flush()


def _ledger_view(inst):
    snap = inst.usage_ledger.snapshot(resolve=inst.identity.tenant.token_of)
    return {
        "tenants": {t["tenant"]: {c: t["usage"][c] for c in COUNTERS}
                    for t in snap["tenants"]},
        "totals": {c: snap["totals"][c] for c in COUNTERS},
        "top": [t["tenant"] for t in snap["tenants"]][:3],
        "shares": {t["tenant"]: round(t["window_share"], 9)
                   for t in snap["tenants"]},
    }


def _run(pkg, root):
    if pkg == "jax":
        from sitewhere_tpu.ingest.decoders import JsonLinesDecoder
    else:
        from sitewhere_tpu_torch.ingest.decoders import JsonLinesDecoder
    inst = _instance(pkg, root / pkg)
    inst.start()
    try:
        _traffic(inst, JsonLinesDecoder())
        inst.event_store.flush()
        out = {"ledger": _ledger_view(inst),
               "partitions": {t: inst.device_state.tenant_state_summary(
                   int(inst.identity.tenant.lookup(t)))
                   for t in TENANTS + ["default"]}}
        inst.stop()
    finally:
        inst.terminate()
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = tmp_path_factory.mktemp("meter")
    return {"jax": _run("jax", root), "torch": _run("torch", root)}


def test_ledger_tenant_totals_equal_the_reference(both):
    ref, got = both["jax"]["ledger"], both["torch"]["ledger"]
    assert got == ref
    assert "t-0" in got["top"]
    assert got["totals"]["nonfinite_rows"] > 0


def test_partition_views_equal_the_reference(both):
    assert both["torch"]["partitions"] == both["jax"]["partitions"]
    # DeviceManagement registers every device in the default tenant
    assert both["torch"]["partitions"]["default"]["devices"] == 8
    assert both["torch"]["partitions"]["t-3"]["devices"] == 0


def _host_syncs(root, enabled):
    from sitewhere_tpu_torch.ingest.decoders import JsonLinesDecoder

    inst = _instance("torch", root / f"meter-{enabled}",
                     metering={"enabled": enabled})
    inst.start()
    try:
        assert (inst.usage_ledger is not None) is enabled
        _traffic(inst, JsonLinesDecoder())
        snap = inst.dispatcher.metrics_snapshot()
        return snap["host_syncs"], snap["steps"]
    finally:
        inst.terminate()


def test_metering_adds_no_host_sync(tmp_path):
    on, off = _host_syncs(tmp_path, True), _host_syncs(tmp_path, False)
    assert on == off
    syncs, steps = on
    assert steps > 0 and syncs == steps   # one per plan with the ring off


# ---------------------------------------------------------------------------
# the tenant-metering section across packages
# ---------------------------------------------------------------------------

def _section(checkpoint_dir):
    return os.path.join(checkpoint_dir, [
        f for f in sorted(os.listdir(checkpoint_dir))
        if f.startswith("tenant-metering-")][-1])


def _saved(pkg, root):
    from sitewhere_tpu.ingest.decoders import JsonLinesDecoder as RefDec
    from sitewhere_tpu_torch.ingest.decoders import JsonLinesDecoder

    inst = _instance(pkg, root / f"saved-{pkg}")
    inst.start()
    try:
        _traffic(inst, RefDec() if pkg == "jax" else JsonLinesDecoder())
        view = inst.usage_ledger.snapshot()
        inst.stop()
    finally:
        inst.terminate()
    return view, _section(inst.checkpointer.dir)


def _comparable(snap):
    return {"tenants": {t["tenant_id"]: {c: t["usage"][c] for c in COUNTERS}
                        for t in snap["tenants"]},
            "totals": {c: snap["totals"][c] for c in COUNTERS},
            "sketch": snap["sketch"]}


def test_port_section_restores_into_the_reference(tmp_path):
    view, path = _saved("torch", tmp_path)
    ref = _instance("jax", tmp_path / "ref")
    ref.checkpointer.save()
    shutil.copyfile(path, _section(ref.checkpointer.dir))
    ref.terminate()
    again = _instance("jax", tmp_path / "ref")
    try:
        assert again.restored
        assert _comparable(again.usage_ledger.snapshot()) == \
            _comparable(view)
    finally:
        again.terminate()


_PROBE = """
import json, sys
sys.modules["jax"] = None
sys.modules["sitewhere_tpu"] = None
from sitewhere_tpu_torch.instance import Instance
from sitewhere_tpu_torch.runtime.config import Config
inst = Instance(Config(json.loads(sys.argv[1]), apply_env=False),
                device="cpu")
assert inst.restored
snap = inst.usage_ledger.snapshot()
bad = sorted(m for m, v in sys.modules.items() if v is not None
             and (m.startswith("jax") or m == "sitewhere_tpu"
                  or m.startswith("sitewhere_tpu.")))
inst.terminate()
print(json.dumps([snap, bad]))
"""


def test_reference_section_restores_into_the_port_without_jax(tmp_path):
    view, path = _saved("jax", tmp_path)
    data = tmp_path / "port"
    port = _instance("torch", data)
    port.checkpointer.save()
    shutil.copyfile(path, _section(port.checkpointer.dir))
    port.terminate()
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, json.dumps(_tree(data))],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got, bad = json.loads(proc.stdout.strip().splitlines()[-1])
    assert bad == []
    assert json.loads(json.dumps(_comparable(got))) == \
        json.loads(json.dumps(_comparable(view)))


# ---------------------------------------------------------------------------
# quotas: deprioritized, then refused, in the rule engine
# ---------------------------------------------------------------------------

def _quota_run(pkg, root):
    if pkg == "jax":
        from sitewhere_tpu.services.common import QuotaExceeded
    else:
        from sitewhere_tpu_torch.services.common import QuotaExceeded
    inst = _instance(pkg, root / f"quota-{pkg}", tenants={
        "t-1": {"quota": {"eval_s_per_window": 1.0}}})
    try:
        assert inst.rule_engine.quotas is inst.quotas
        assert inst.analytics.quotas is inst.quotas
        assert inst.rule_engine.usage_ledger is inst.usage_ledger
        tid = int(inst.identity.tenant.lookup("t-1"))
        other = int(inst.identity.tenant.mint("t-2"))
        ids = np.array([tid, other, tid, other], np.int32)
        states, masks, refused = [], [], []
        for charge in (0.5, 0.35, 0.2):
            inst.usage_ledger.charge(tid, "eval_s", charge)
            states.append(inst.quotas.state_of(tid))
            mask = inst.rule_engine.quotas.skip_mask(ids)
            masks.append(None if mask is None else mask.tolist())
            try:
                inst.quotas.check_eval(tid)
                refused.append(False)
            except QuotaExceeded:
                refused.append(True)
        return {"states": states, "masks": masks, "refused": refused,
                "other": inst.quotas.state_of(other)}
    finally:
        inst.terminate()


def test_quota_deprioritizes_then_refuses_as_the_reference(tmp_path):
    ref, got = _quota_run("jax", tmp_path), _quota_run("torch", tmp_path)
    assert got == ref
    assert got["states"] == ["ok", "deprioritized", "refused"]
    assert got["refused"] == [False, False, True]
    assert got["masks"][1] == [True, False, True, False]
    assert got["other"] == "ok"
