"""The control plane on the port's wire path, against the reference.

- The reference's own ``tests/test_flightrec.py`` cases for the flight
  recorder, the SLO burn-rate engine, anomaly tail retention, the latency
  buckets, the zero-sync acceptance through an ``Instance``, the
  OpenMetrics exposition of the new families, the REST surface and the
  timeline renderer, run against the port with their imports rewritten
  (the renderer case drives the port's
  ``tools/torch_flightrec_timeline.py``).
- The ``Instance`` honours every key of the ``overload``, ``metering``,
  ``slo``, ``flightrec`` and ``tenants`` sections and
  ``state.partition_min_capacity``, and still refuses the sections it
  does not compose.
- The same NDJSON through both ``Instance``s (ring depth 2): the flight
  records, the SLO sample and the overload signals are equal; an
  overload transition, an SLO alert and a restore each leave the same
  flight-recorder snapshot in both packages.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.instance import HONOURED
from torch_parity import port_test_module, reference_cases, run_port_case

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(TESTS, "test_flightrec.py")

# the packed-telemetry block is held against the reference by
# tests/test_torch_step.py
SKIP = ("TestPackedTelemetryBlock",)
CASES = reference_cases(REF, skip=SKIP)
# the timeline renderer case drives the port's renderer
REPLACE = (('"tools", "flightrec_timeline.py")',
            '"tools", "torch_flightrec_timeline.py")'),)


@pytest.fixture(scope="module")
def port_ns():
    return port_test_module(REF, replace=REPLACE)


def test_the_port_runs_the_reference_control_plane_cases():
    assert len(CASES) >= 30
    assert "TestTimelineRenderer.test_renders_a_snapshot" in CASES
    assert "TestTelemetryZeroSyncAcceptance.test_host_syncs_stay_one_" \
        "per_chain_with_telemetry_on" in CASES


@pytest.mark.parametrize("case", CASES)
def test_reference_flightrec_case_on_the_port(port_ns, case, tmp_path,
                                              capsys):
    run_port_case(port_ns, case, tmp_path, fixtures={"capsys": capsys})


# ---------------------------------------------------------------------------
# the Instance's configuration
# ---------------------------------------------------------------------------

CONTROL_PLANE = {
    "overload": {"enabled": True, "cooldown_s": 5.0, "hysteresis": 0.5,
                 "confirm_samples": 3, "sample_interval_s": 0.2,
                 "retry_after_s": 2.0,
                 "degraded_telemetry_rate_per_s": 500.0,
                 "degraded_telemetry_burst": 900.0,
                 "budget_refresh_s": 1.0,
                 "watermarks": {"batcher_backlog": [2.0, 5.0, 20.0]}},
    "metering": {"enabled": True, "top_k": 8, "window_s": 30.0,
                 "fair_share_frac": 0.5, "min_rate_frac": 0.2,
                 "quota": {"enabled": True, "eval_s_per_window": 3.0,
                           "soft_frac": 0.5}},
    "slo": {"enabled": True, "throughput_eps": 5000.0, "p99_ms": 50.0,
            "shed_rate": 0.05, "fast_window_s": 10.0,
            "slow_window_s": 100.0, "error_budget": 0.1,
            "alert_burn": 3.0, "min_samples": 2, "lag_tolerance_s": 1.0,
            "sample_interval_s": 0.5},
    "flightrec": {"enabled": True, "capacity": 16,
                  "min_snapshot_interval_s": 1.0, "max_snapshots": 4},
    "tenants": {"t-a": {"overload": {"degraded_telemetry_rate_per_s": 7.0},
                        "quota": {"eval_s_per_window": 0.5}}},
    "state": {"partition_min_capacity": 16},
}


def _port(data_dir, **sections):
    from sitewhere_tpu_torch.instance import Instance
    from sitewhere_tpu_torch.runtime.config import Config

    return Instance(Config({
        "instance": {"id": "cp", "data_dir": str(data_dir)},
        "pipeline": {"width": 64, "registry_capacity": 128,
                     "mtype_slots": 4},
        "checkpoint": {"interval_s": 0},
        **sections,
    }, apply_env=False), device="cpu")


def test_control_plane_sections_are_honoured(tmp_path):
    for key in ("overload.*", "metering.*", "slo.*", "flightrec.*",
                "tenants.*", "state.partition_min_capacity"):
        assert key in HONOURED
    inst = _port(tmp_path / "cp", **CONTROL_PLANE)
    try:
        ov = inst.overload
        assert (ov.cooldown_s, ov.hysteresis, ov.confirm_samples) == \
            (5.0, 0.5, 3)
        assert ov.watermarks.batcher_backlog == (2.0, 5.0, 20.0)
        assert ov.retry_after() == 2.0
        assert ov.tenant_budgets.overlay("t-a") == {
            "degraded_telemetry_rate_per_s": 7.0}
        led = inst.usage_ledger
        assert (led.top_k, led.window_s, led.fair_share_frac) == \
            (8, 30.0, 0.5)
        tid = inst.identity.tenant.lookup("t-a")
        assert inst.quotas.quota_of(tid) == 0.5
        assert inst.quotas.quota_of(tid + 1) == 3.0
        assert inst.slo.targets.p99_ms == 50.0
        assert inst.slo.windows_s == (10.0, 100.0)
        assert inst.flightrec.capacity == 16
        assert inst.device_state.partitions.min_capacity == 16
        assert inst.dispatcher.overload is ov
        assert inst.dispatcher.usage_ledger is led
        assert inst.event_store.usage_ledger is led
        assert inst.rule_engine.overload is ov
        assert inst.analytics.overload is ov
    finally:
        inst.terminate()


def test_control_plane_can_be_turned_off(tmp_path):
    inst = _port(tmp_path / "off", overload={"enabled": False},
                 metering={"enabled": False}, slo={"enabled": False},
                 flightrec={"enabled": False})
    try:
        assert inst.overload is None and inst.usage_ledger is None
        assert inst.quotas is None and inst.slo is None
        assert inst.flightrec is None
        assert inst.rule_engine.quotas is None
        names = list(inst.checkpointer._providers)
        assert "tenant-metering" not in names
    finally:
        inst.terminate()


# (the presence section is honoured since the outbound, search and
# presence slice, the ``rpc`` and ``api`` sections since the multi-host
# fabric; the ``web`` keys have no reader, the WebServer takes its host
# and port as arguments, and the metrics reporter is not composed)
@pytest.mark.parametrize("section", [
    {"web": {"port": 8080}},
    {"outbound": {"connectors": [{"id": "x"}]}},
    {"metrics": {"report_interval_s": 5.0}},
])
def test_uncomposed_sections_still_refuse(tmp_path, section):
    with pytest.raises(NotImplementedError):
        _port(tmp_path / "refuse", **section)


# ---------------------------------------------------------------------------
# the same NDJSON through both Instances
# ---------------------------------------------------------------------------

WIDTH = 64


def _instance(pkg, data_dir):
    tree = {
        "instance": {"id": "cp-wire", "data_dir": str(data_dir)},
        "pipeline": {"width": WIDTH, "registry_capacity": 128,
                     "mtype_slots": 4, "deadline_ms": 60_000.0,
                     "adaptive_deadline": False, "ring_depth": 2},
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


def _payload(r, n=WIDTH):
    return "\n".join(json.dumps({
        "deviceToken": f"d-{i % 16}", "type": "Measurement",
        "request": {"name": "temp", "value": float(i % 50),
                    "eventDate": 1_753_800_000 + 100 * r + i}})
        for i in range(n)).encode()


RECORD_KEYS = ("seq", "reason", "rows", "fill", "slot", "replay_depth",
               "overload", "commit")


def _snapshot_reasons(flightrec, timeout_s=5.0):
    """Snapshot reasons, waiting for the dump threads."""
    deadline = time.monotonic() + timeout_s
    while True:
        snaps = flightrec.snapshots()
        done = all("reason" in s for s in snaps)
        reasons = sorted(s.get("reason", "") for s in snaps)
        if time.monotonic() > deadline or (done and len(reasons) >= 2):
            return reasons
        time.sleep(0.02)


def _run(pkg, root):
    if pkg == "jax":
        from sitewhere_tpu.runtime.overload import OverloadState
    else:
        from sitewhere_tpu_torch.runtime.overload import OverloadState
    data = root / pkg
    inst = _instance(pkg, data)
    inst.slo.sample_fn = None   # the test feeds the engine itself
    inst.start()
    out = {}
    try:
        dm = inst.device_management
        dm.create_device_type(token="sensor", name="S")
        for i in range(16):
            dm.create_device(token=f"d-{i}", device_type="sensor")
            dm.create_device_assignment(device=f"d-{i}")
        inst.checkpointer.save()
        d = inst.dispatcher
        inst._slo_sample()                     # the baseline
        for r in range(4):
            d.ingest_wire_lines(_payload(r))
        d.ingest_wire_lines(_payload(4, n=10))  # a partial plan
        d.flush()
        sample = inst._slo_sample()
        out["sample"] = {k: sample[k] for k in ("events", "shed",
                                                "admitted", "backlog")}
        signals = inst._overload_signals()
        out["signals"] = {k: v for k, v in signals.as_dict().items()
                          if k != "fsync_latency_s"}
        out["records"] = [{k: r.get(k) for k in RECORD_KEYS}
                          for r in inst.flightrec.recent(50)]
        snap = d.metrics_snapshot()
        out["sync"] = (snap["steps"], snap["ring_chains"],
                       snap["host_syncs"])
        # an overload transition and an SLO burn alert each dump
        inst.overload.force(OverloadState.DEGRADED, reason="test")
        clock = [5000.0]
        for _ in range(6):
            clock[0] += 1.0
            inst.slo.observe({"events": 10, "elapsed_s": 1.0,
                              "p99_ms": 80.0, "shed": 0, "admitted": 10,
                              "backlog": 0}, now=clock[0])
        out["alerts"] = inst.slo.alerts_fired
        out["alerting"] = {k: v["alerting"] for k, v in
                           inst.slo.snapshot()["objectives"].items()}
        out["snapshots"] = _snapshot_reasons(inst.flightrec)
        inst.stop()
    finally:
        inst.terminate()
    again = _instance(pkg, data)
    try:
        assert again.restored
        again.start()
        out["restart_snapshots"] = sorted(
            s["reason"] for s in again.flightrec.snapshots())
    finally:
        again.terminate()
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = tmp_path_factory.mktemp("cp-wire")
    return {"jax": _run("jax", root), "torch": _run("torch", root)}


def test_flight_records_equal_the_reference(both):
    ref, got = both["jax"], both["torch"]
    assert got["records"] == ref["records"]
    assert [r["slot"] for r in got["records"]] == [0, 1, 0, 1, None]
    assert all(r["commit"] == "ok" for r in got["records"])


def test_slo_sample_and_signals_equal_the_reference(both):
    ref, got = both["jax"], both["torch"]
    assert got["sample"] == ref["sample"]
    assert got["sample"]["events"] == 4 * WIDTH + 10
    assert got["signals"] == ref["signals"]
    assert got["sync"] == ref["sync"] == (5, 2, 3)


def test_alerts_and_dumps_equal_the_reference(both):
    ref, got = both["jax"], both["torch"]
    assert got["alerts"] == ref["alerts"] == 1
    assert got["alerting"] == ref["alerting"]
    assert got["snapshots"] == ref["snapshots"]
    assert "overload-degraded" in got["snapshots"]
    assert "slo-p99_ms" in got["snapshots"]
    assert "recovery" in got["restart_snapshots"]
    assert got["restart_snapshots"] == ref["restart_snapshots"]


def test_quiet_instance_reads_no_seal_lag(both):
    for pkg in ("jax", "torch"):
        assert both[pkg]["signals"]["seal_lag_s"] == 0.0
        assert both[pkg]["signals"]["egress_inflight"] == 0.0
    assert np.isfinite(both["torch"]["signals"]["batcher_backlog"])
