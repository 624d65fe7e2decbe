"""Device telemetry and the profiler endpoints of the port, against the
reference.

- ``profile_device_stages`` returns the reference's keys and observes the
  same ``device.stage_ms.<stage>`` histograms with the same buckets (on
  the CPU, at width 64).
- The watchdog's ``calibrate`` gives the same soft and hard budgets from
  the same full-step time in both packages.
- ``run_device_profile`` through both ``Instance``s: the same result keys
  and the watchdog re-anchored from the measured ``full_ms``.
- A capture's start, a second start, stop, a failed stop and its retry
  answer as the reference's do (``torch.profiler`` in place of
  ``jax.profiler``), start and stop on two threads.
- ``telemetry.device_profile_on_start`` is honoured: the boot-time
  calibration fills the histograms on a background thread.
"""

from __future__ import annotations

import os
import threading
import time

import pytest
import torch

from torch_parity import CpuInstance, make_config

torch.set_num_threads(1)
WIDTH, CAPACITY = 64, 128


def test_stage_profile_keys_and_buckets_match_the_reference():
    from sitewhere_tpu.pipeline import telemetry as ref
    from sitewhere_tpu.runtime.metrics import MetricsRegistry as RefRegistry
    from sitewhere_tpu_torch.pipeline import telemetry as port
    from sitewhere_tpu_torch.runtime.metrics import MetricsRegistry

    assert port.DEVICE_STAGES == ref.DEVICE_STAGES
    assert port.DEVICE_STAGE_MS_BUCKETS == ref.DEVICE_STAGE_MS_BUCKETS
    kw = dict(width=WIDTH, capacity=CAPACITY, rules_capacity=8,
              zones_capacity=8, iters=2, repeats=2)
    ref_metrics, port_metrics = RefRegistry(), MetricsRegistry()
    want = ref.profile_device_stages(metrics=ref_metrics, **kw)
    got = port.profile_device_stages(metrics=port_metrics, device="cpu",
                                     zone_verts=16, **kw)
    assert set(got) == set(want)
    assert {k: got[k] for k in ("width", "iters", "repeats")} == {
        k: want[k] for k in ("width", "iters", "repeats")}
    for stage in port.DEVICE_STAGES:
        assert got[f"{stage}_ms"] > 0
    assert got["device_events_per_s"] == round(
        WIDTH / got["full_ms"] * 1e3, 1)
    ref_h = ref_metrics.snapshot()["histograms"]
    port_h = port_metrics.snapshot()["histograms"]
    assert set(port_h) == set(ref_h) == {
        f"device.stage_ms.{s}" for s in port.DEVICE_STAGES}
    for name in ref_h:
        assert port_h[name]["count"] == ref_h[name]["count"] == 2
        assert list(port_h[name]["buckets"]) == list(ref_h[name]["buckets"])


@pytest.mark.parametrize("full_ms", [0.0, 1.5, 4.999, 9.0, 37.25, 400.0])
def test_calibrate_gives_the_reference_budgets(full_ms):
    from sitewhere_tpu.runtime.devguard import DeviceWatchdog as Ref
    from sitewhere_tpu_torch.runtime.devguard import DeviceWatchdog as Port

    ref, port = Ref(), Port()
    ref.calibrate(full_ms)
    port.calibrate(full_ms)
    assert (port.soft_s, port.hard_s) == (ref.soft_s, ref.hard_s)


def _jax_instance(tmp_path):
    from sitewhere_tpu.instance import Instance
    from sitewhere_tpu.runtime.config import Config

    cfg = make_config(tmp_path).as_dict()
    return Instance(Config(cfg, apply_env=False))


def test_run_device_profile_matches_the_reference(tmp_path):
    ref = _jax_instance(tmp_path / "jax")
    port = CpuInstance(make_config(tmp_path / "torch"))
    try:
        want = ref.run_device_profile(iters=2, repeats=2)
        before = (port.dispatcher.watchdog.soft_s,
                  port.dispatcher.watchdog.hard_s)
        got = port.run_device_profile(iters=2, repeats=2)
        assert set(got) == set(want)
        probe = type(port.dispatcher.watchdog)()
        probe.calibrate(got["full_ms"])
        assert (port.dispatcher.watchdog.soft_s,
                port.dispatcher.watchdog.hard_s) == (probe.soft_s,
                                                     probe.hard_s)
        assert before == (1.0, 10.0)
        hist = port.metrics.snapshot()["histograms"]
        assert hist["device.stage_ms.full"]["count"] == 2
    finally:
        ref.terminate()
        port.terminate()


def _capture_sequence(inst, break_stop):
    """start, start again, stop (failing once), stop again, stop, with
    start and the stops on two different threads."""
    from sitewhere_tpu_torch.services.common import ServiceError as PortErr
    from sitewhere_tpu.services.common import ServiceError as RefErr

    def call(fn):
        try:
            doc = fn()
            return ("ok", doc["capturing"], os.path.basename(
                os.path.dirname(doc["trace_dir"])))
        except (PortErr, RefErr) as e:
            return (type(e).__name__, e.http_status, str(e).split(":")[0])

    out = []
    t = threading.Thread(target=lambda: out.append(
        call(inst.start_profiler_capture)))
    t.start()
    t.join(120)
    assert not t.is_alive(), "start_profiler_capture on a thread: no " \
        "answer within 120 s"
    out.append(call(inst.start_profiler_capture))
    with break_stop():
        out.append(call(inst.stop_profiler_capture))
    out.append(call(inst.stop_profiler_capture))
    out.append(call(inst.stop_profiler_capture))
    return out


def test_profiler_capture_answers_as_the_reference(tmp_path, monkeypatch):
    import contextlib

    import jax

    ref = _jax_instance(tmp_path / "jax")
    port = CpuInstance(make_config(tmp_path / "torch"))

    @contextlib.contextmanager
    def break_ref_stop():
        def fail():
            raise RuntimeError("trace writer gone")
        with monkeypatch.context() as m:
            m.setattr(jax.profiler, "stop_trace", fail)
            yield

    @contextlib.contextmanager
    def break_port_stop():
        def fail(prof):
            raise RuntimeError("trace writer gone")
        with monkeypatch.context() as m:
            m.setattr(port._profiler, "_stop", fail)
            yield

    try:
        want = _capture_sequence(ref, break_ref_stop)
        got = _capture_sequence(port, break_port_stop)
    finally:
        ref.terminate()
        port.terminate()
    assert got == want
    assert [o[0] for o in got] == [
        "ok", "ValidationError", "ValidationError", "ok", "ValidationError"]
    traces = [os.path.join(dp, f) for dp, _, fs in os.walk(
        os.path.join(port.data_dir, "profiles")) for f in fs]
    assert traces and all(os.path.getsize(p) > 0 for p in traces)


def test_device_profile_on_start_is_honoured(tmp_path):
    from sitewhere_tpu_torch.instance import refuse_unsupported
    from sitewhere_tpu_torch.runtime.config import Config

    tree = make_config(tmp_path).as_dict()
    tree["telemetry"] = {"device_profile_on_start": True}
    cfg = Config(tree, apply_env=False)
    refuse_unsupported(cfg)
    inst = CpuInstance(cfg)
    profiled, real = [], inst.run_device_profile
    inst.run_device_profile = lambda: (
        profiled.append((threading.current_thread().name, real())))
    inst.start()
    try:
        deadline = time.monotonic() + 20
        while not profiled and time.monotonic() < deadline:
            time.sleep(0.05)
        (thread, result), = profiled
        assert thread == "device-profile"
        hist = inst.metrics.snapshot()["histograms"]
        assert hist["device.stage_ms.full"]["count"] == 3
        probe = type(inst.dispatcher.watchdog)()
        probe.calibrate(result["full_ms"])
        assert (inst.dispatcher.watchdog.soft_s,
                inst.dispatcher.watchdog.hard_s) == (probe.soft_s,
                                                     probe.hard_s)
    finally:
        inst.stop()
        inst.terminate()
