"""The multitenant wire path of the port against the reference.

- Both ``Instance``s on the CPU, bootstrapped from the same
  ``InstanceTemplate`` (an admin and N tenants), each tenant's devices,
  area and zone made through its own engine: the same seeded numpy
  columns through ``dispatcher.ingest_arrays`` give every plan the same
  packed ``[10, B]`` outputs, step counters and 16-slot tenant block, and
  every tenant the same accepted rows.  With 3 tenants and with 20, whose
  dense ids fold onto the block's slots as ``tenant_id % 16``
  (``pipeline/packed.py:259``).
- Rows stamped with tenant B for a device of tenant A count as
  processed and are never accepted, in both packages.
- A checkpoint the reference ``Instance`` wrote, holding users, tenants
  with their engines' devices and assignments, schedules, jobs and batch
  operations, restores into the port's with every record equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_device_management import normalize

torch.set_num_threads(1)

WIDTH, CAP, DEVICES_PER_TENANT = 64, 1024, 6
TS0 = 1_753_800_000
ZONE = [(-10.0, -10.0), (-10.0, 10.0), (10.0, 10.0), (10.0, -10.0)]


def _packages(pkg):
    if pkg == "jax":
        from sitewhere_tpu.instance import Instance, InstanceTemplate
        from sitewhere_tpu.runtime.config import Config
        from sitewhere_tpu.schema import ComparisonOp
        return Instance, InstanceTemplate, Config, ComparisonOp, {}
    from sitewhere_tpu_torch.instance import Instance, InstanceTemplate
    from sitewhere_tpu_torch.runtime.config import Config
    from sitewhere_tpu_torch.schema import ComparisonOp
    return (Instance, InstanceTemplate, Config, ComparisonOp,
            {"device": "cpu"})


def tenant_tokens(n):
    return [f"t-{k:02d}" for k in range(n)]


def _config(Config, data_dir):
    return Config({
        "instance": {"id": "mt-wire", "data_dir": str(data_dir)},
        "pipeline": {"width": WIDTH, "registry_capacity": CAP,
                     "mtype_slots": 4, "deadline_ms": 60_000.0,
                     "adaptive_deadline": False, "n_shards": 1},
        "presence": {"scan_interval_s": 3600.0, "missing_after_s": 1800},
        "checkpoint": {"interval_s": 0},
        "events": {"compact_interval_s": 0},
        # the ladder and the SLO engine would act on host timing
        "overload": {"enabled": False},
        "slo": {"enabled": False},
    }, apply_env=False)


def build(pkg, data_dir, n_tenants):
    """One package's ``Instance``, bootstrapped from the template and
    started, with each tenant's devices, area and zone made through its
    engine."""
    Instance, InstanceTemplate, Config, ComparisonOp, dev = _packages(pkg)
    tokens = tenant_tokens(n_tenants)
    template = InstanceTemplate(tenants=[
        {"token": "default", "name": "Default"}] + [
        {"token": t, "name": t.upper(), "auth_token": f"{t}-auth"}
        for t in tokens])
    inst = Instance(_config(Config, data_dir), template, **dev)
    inst.start()
    for token in tokens:
        dm = inst.engines.get_engine(token).device_management
        dm.create_device_type(token="sensor", name="Sensor")
        dm.create_area_type(token="site", name="Site")
        dm.create_area(token="hq", area_type="site", name="HQ")
        dm.create_zone(token="fence", area="hq", name="Fence",
                       bounds=ZONE, condition="outside", alert_level=2)
        for i in range(DEVICES_PER_TENANT):
            dm.create_device(token=f"{token}-d{i}", device_type="sensor")
            # every third device is left unassigned
            if i % 3 != 2:
                dm.create_device_assignment(device=f"{token}-d{i}",
                                            area="hq")
    inst.rules.create_rule("temp", ComparisonOp.GT, 80.0, "hot",
                           token="r-hot")
    return inst, tokens


def traffic(inst, tokens, n_rows, seed):
    """Seeded columns over every tenant's devices, ghosts (unregistered
    handles) and about 5% rows stamped with another tenant."""
    rng = np.random.default_rng(seed)
    devices = [f"{t}-d{i}" for t in tokens for i in range(DEVICES_PER_TENANT)]
    handles = np.asarray(inst.identity.device.lookup_many(devices), np.int32)
    owner = np.repeat(np.asarray(
        [inst.identity.tenant.lookup(t) for t in tokens], np.int32),
        DEVICES_PER_TENANT)
    pick = rng.integers(0, len(devices), n_rows)
    device_id = handles[pick]
    tenant_id = owner[pick].copy()
    ghosts = rng.random(n_rows) < 0.03
    device_id[ghosts] = CAP - 1 - rng.integers(0, 8, int(ghosts.sum()))
    mismatch = rng.random(n_rows) < 0.05
    tenant_id[mismatch] = owner[(pick[mismatch] + DEVICES_PER_TENANT)
                                % len(devices)]
    event_type = rng.choice([0, 0, 1, 2], n_rows).astype(np.int32)
    cols = dict(
        device_id=device_id.astype(np.int32),
        tenant_id=tenant_id.astype(np.int32),
        event_type=event_type,
        ts_s=(TS0 + rng.integers(0, 40, n_rows)).astype(np.int32),
        mtype_id=np.full(n_rows, inst.identity.mtype.mint("temp"), np.int32),
        value=np.round(rng.uniform(0, 100, n_rows), 2).astype(np.float32),
        lat=rng.uniform(-20, 20, n_rows).astype(np.float32),
        lon=rng.uniform(-20, 20, n_rows).astype(np.float32),
        alert_code=np.where(event_type == 2,
                            inst.identity.alert_type.mint("door"),
                            -1).astype(np.int32),
    )
    return cols, dict(zip(handles.tolist(), owner.tolist()))


def run(pkg, data_dir, n_tenants, n_rows, seed):
    """The egress of every plan: packed outputs, step counters, tenant
    block and the plan's host tenant column."""
    inst, tokens = build(pkg, data_dir, n_tenants)
    plans = []
    disp = inst.dispatcher
    egress = disp._egress

    def record(plan, out, replay_depth, trace=None):
        m = out.metrics
        plans.append({
            "oi": np.array(out.oi),
            "tenant_meter": np.array(out.tenant_meter),
            "metrics": {k: int(getattr(m, k)) for k in (
                "processed", "accepted", "unregistered", "unassigned",
                "threshold_alerts", "zone_alerts")},
            "tenant_id": np.array(plan.host_cols["tenant_id"]),
            "device_id": np.array(plan.host_cols["device_id"]),
            "accepted": np.array(out.accepted),
        })
        return egress(plan, out, replay_depth, trace=trace)

    disp._egress = record
    try:
        cols, owner = traffic(inst, tokens, n_rows, seed)
        disp.ingest_arrays(**cols)
        disp.flush()
        ids = {t: inst.identity.tenant.lookup(t) for t in tokens}
        snap = disp.metrics_snapshot()
    finally:
        inst.stop()
        inst.terminate()
    return {"plans": plans, "ids": ids, "cols": cols, "owner": owner,
            "snapshot": {k: snap[k] for k in ("processed", "accepted")}}


def _accepted_by_tenant(result):
    out = {}
    for p in result["plans"]:
        tid, acc = p["tenant_id"][:len(p["accepted"])], p["accepted"]
        for t, k in result["ids"].items():
            out[t] = out.get(t, 0) + int((acc & (tid == k)).sum())
    return out


@pytest.fixture(scope="module", params=[3, 20], ids=["3-tenants",
                                                      "20-tenants"])
def both(request, tmp_path_factory):
    n = request.param
    root = tmp_path_factory.mktemp(f"mt{n}")
    rows = 6 * WIDTH + 17
    return n, {pkg: run(pkg, root / pkg, n, rows, seed=100 + n)
               for pkg in ("jax", "torch")}


def test_packed_outputs_and_tenant_block_equal(both):
    n, res = both
    ref, got = res["jax"], res["torch"]
    assert ref["ids"] == got["ids"]
    # seven plans of ingest, then the derived alerts' re-injection
    assert len(ref["plans"]) == len(got["plans"]) > 7
    for i, (a, b) in enumerate(zip(ref["plans"], got["plans"])):
        assert a["metrics"] == b["metrics"], i
        np.testing.assert_array_equal(a["oi"], b["oi"], err_msg=str(i))
        np.testing.assert_array_equal(a["tenant_meter"], b["tenant_meter"],
                                      err_msg=str(i))
    assert ref["snapshot"] == got["snapshot"]
    assert ref["snapshot"]["accepted"] > 0


def test_per_tenant_accepted_rows_equal(both):
    n, res = both
    want = _accepted_by_tenant(res["jax"])
    assert _accepted_by_tenant(res["torch"]) == want
    assert all(v > 0 for v in want.values()), want
    # the tenant block's accepted-rows counter is the per-tenant count
    # folded onto its 16 slots
    block = sum(p["tenant_meter"][0] for p in res["torch"]["plans"])
    folded = np.zeros(16, np.int64)
    for t, k in res["torch"]["ids"].items():
        folded[k % 16] += want[t]
    np.testing.assert_array_equal(block, folded)
    if n == 20:
        # dense ids past 15 share a slot with a lower one
        assert max(res["torch"]["ids"].values()) >= 16


def test_tenant_mismatch_rows_are_processed_and_never_accepted(both):
    n, res = both
    for pkg in ("jax", "torch"):
        r = res[pkg]
        owner = r["owner"]
        mismatched = 0
        for p in r["plans"]:
            n_rows = len(p["accepted"])
            dev, tid = p["device_id"][:n_rows], p["tenant_id"][:n_rows]
            stamped_other = np.asarray(
                [d in owner and owner[d] != t for d, t in zip(dev, tid)])
            assert not (p["accepted"] & stamped_other).any(), pkg
            mismatched += int(stamped_other.sum())
        assert mismatched > 0
        assert sum(p["metrics"]["processed"] for p in r["plans"]) >= \
            len(r["cols"]["device_id"])


# ---------------------------------------------------------------------------
# a reference checkpoint of the slice's records, restored into the port
# ---------------------------------------------------------------------------

def _seed_records(inst):
    """Users, a schedule with a job and a batch operation over the
    default tenant's devices (the reference's own services)."""
    inst.users.create_granted_authority("ROLE_OPERATOR")
    inst.users.create_user(username="ops", password="ops-pass-1",
                           first_name="Op", last_name="Erator",
                           authorities=["ROLE_OPERATOR"])
    dm = inst.device_management
    dm.create_device_type(token="sensor", name="Sensor")
    for i in range(3):
        dm.create_device(token=f"def-d{i}", device_type="sensor")
        dm.create_device_assignment(token=f"def-a{i}", device=f"def-d{i}")
    # yearly, fired on demand: the tickers must not fire it during the test
    inst.schedules.create_schedule(token="nightly", name="Nightly",
                                   trigger_type="Cron", cron="0 0 1 1 *")
    inst.schedules.create_job(
        token="job-1", schedule="nightly", job_type="CommandInvocation",
        config={"commandToken": "ping", "assignmentToken": "def-a0"})
    inst.schedules.fire("nightly", at_s=TS0)
    inst.batch_ops.create_batch_command_invocation(
        "ping", parameter_values={"n": "1"},
        devices=[f"def-d{i}" for i in range(3)], token="batch-1")
    assert inst.batch_ops.wait_idle(30.0)


_RECORD_KEYS = {
    "users": ("_users", "_authorities"),
    "tenants": ("_tenants",),
    "schedules": ("schedules", "jobs", "_fires"),
    "batch_ops": ("operations",),
}
_ENGINE_KEYS = ("device_types", "devices", "assignments", "area_types",
                "areas", "zones")


def record_view(inst):
    view = {attr: {k: normalize(getattr(getattr(inst, attr), k))
                   for k in keys} for attr, keys in _RECORD_KEYS.items()}
    view["engines"] = {
        eng.tenant.token: {k: normalize(getattr(eng.device_management, k))
                           for k in _ENGINE_KEYS}
        for eng in inst.engines.list_engines()}
    view["tenant_ids"] = {eng.tenant.token: eng.tenant_id
                          for eng in inst.engines.list_engines()}
    return view


def test_reference_checkpoint_of_the_slice_restores_into_the_port(tmp_path):
    data = tmp_path / "data"
    ref, tokens = build("jax", data, 3)
    try:
        _seed_records(ref)
        ref.stop()
        want = record_view(ref)
    finally:
        ref.terminate()
    assert len(want["engines"]) == 4
    assert want["batch_ops"]["operations"]["batch-1"]["elements"]

    Instance, _, Config, _, dev = _packages("torch")
    port = Instance(_config(Config, data), **dev)
    assert port.restored
    port.start()
    try:
        # the template does not run again; the engines come back with
        # their devices, found by token in the shared identity map
        assert port.bootstrapped
        got = record_view(port)
        assert got == want
        eng = port.engines.get_engine(tokens[0])
        assert eng.device_management.get_active_assignment(
            f"{tokens[0]}-d0") is not None
        assert port.users.authenticate("ops", "ops-pass-1").username == "ops"
        assert type(port.schedules.get_schedule("nightly")).__module__ == \
            "sitewhere_tpu_torch.services.schedules"
    finally:
        port.stop()
        port.terminate()
