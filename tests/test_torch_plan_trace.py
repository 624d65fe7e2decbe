"""``tools/torch_plan_trace.py``: the readings of a cell's per-plan spans,
on synthetic spans and through the benchmark harness at a tiny size on
the CPU.

- :func:`plan_readings` on a hand-made trace: the batcher's wait, the
  host's wait on the card, the device stages, the latency by origin and
  chained through the plan that re-injected a row, the part of a plan
  no host span covers.
- Idle gaps named ``<harness span>/<innermost program span>`` on the
  harness span's thread.
- ``run_once`` over a tiny copy of the cell (alerts firing): the traced
  run is correct and its readings carry the four would-be metrics; the
  untraced run at sample rates 1.0 and 0.0 reports events/s.
"""

import importlib.util
import math
import os
import threading

import pytest
import torch

from sitewhere_tpu_torch.runtime.tracing import Tracer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_plan_trace", os.path.join(REPO, "tools", "torch_plan_trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _plan(tr, seq, start, spans, origin="stream", source=-1, end=None):
    """One plan's trace: a root from ``start``, and ``(name, a, b, tags)``
    spans under it; closed at ``end`` (the last span's end)."""
    trace = tr.trace("pipeline.plan", start=start)
    trace.root.tag("seq", seq).tag("rows", 8)
    for name, a, b, tags in spans:
        if name == "batch.wait":
            tags = dict(tags, origin=origin, source_seq=source)
        trace.record(name, a, b, seq=seq, rows=8, **tags)
    trace.root.end_s = end if end is not None else max(b for _, _, b, _
                                                       in spans)
    tr._finish(trace.root)


def test_plan_readings_on_a_made_trace():
    tool = _tool()
    tr = Tracer(sample_rate=1.0)
    _plan(tr, 0, 10.000, [
        ("batch.wait", 10.000, 10.004, {}),
        ("batch.intake", 10.002, 10.006, {}),
        ("step.dispatch", 10.006, 10.016, {}),
        ("window.wait", 10.016, 10.040, {}),
        ("egress.fetch-outputs", 10.040, 10.050, {}),
        ("egress.derived-alerts", 10.050, 10.054, {}),
        ("device.zones", 10.020, 10.040, {"device_ms": 20.0}),
        ("device.state", 10.040, 10.045, {"device_ms": 5.0}),
    ], end=10.060)
    _plan(tr, 1, 10.052, [
        ("batch.wait", 10.052, 10.070, {}),
        ("batch.intake", 10.068, 10.072, {}),
        ("step.dispatch", 10.072, 10.082, {}),
        ("window.wait", 10.082, 10.100, {}),
        ("egress.fetch-outputs", 10.100, 10.120, {}),
        ("device.zones", 10.090, 10.112, {"device_ms": 22.0}),
        ("device.state", 10.112, 10.119, {"device_ms": 7.0}),
    ], origin="derived", source=0)
    # a plan closed before the window is left out
    _plan(tr, 9, 9.0, [("batch.wait", 9.0, 9.1, {})])
    got = tool.plan_readings(tr.finished(), 9.5, 11.0)
    assert got["plans"] == 2
    assert got["batcher_wait_ms"] == pytest.approx((4 + 18) / 2)
    assert got["card_wait_ms"] == pytest.approx((10 + 20) / 2)
    assert got["zones_device_ms"] == pytest.approx(21.0)
    assert got["state_device_ms"] == pytest.approx(6.0)
    assert got["device_step_ms"] == pytest.approx(27.0)
    assert got["latency_ms"]["mean"] == pytest.approx((60 + 68) / 2)
    # plan 0's root runs 6 ms past its last span; plan 1's is covered
    assert got["unaccounted_ms"] == pytest.approx(3.0)
    assert got["stages_ms"]["egress.derived-alerts"] == pytest.approx(2.0)
    assert got["by_origin"] == {
        "derived": {"plans": 1, "latency_ms": pytest.approx(68.0),
                    "batcher_wait_ms": pytest.approx(18.0)},
        "stream": {"plans": 1, "latency_ms": pytest.approx(60.0),
                   "batcher_wait_ms": pytest.approx(4.0)}}
    assert got["chained_ms"]["mean"] == pytest.approx(120.0)


def test_idle_gaps_are_named_by_the_program_span_under_the_harness_span():
    tool = _tool()
    from benchmark import devtrace

    tr = Tracer(sample_rate=1.0)
    _plan(tr, 0, 1.0, [
        ("batch.wait", 1.0, 1.5, {}),
        ("step.dispatch", 1.1, 1.3, {}),
        ("egress.derived-alerts", 1.4, 1.8, {}),
    ])
    named = tool.naming_spans(devtrace, tr)()
    named.on = True
    me = threading.get_ident()
    named.record("intake", 1.0, 2.0)
    named.spans.append((me + 1, "sink", 1.6, 1.7))
    assert named.at(1.2) == "intake/step.dispatch"
    # the batcher's wait is not work of the thread: the harness name only
    assert named.at(1.35) == "intake"
    assert named.at(1.65) == "intake/egress.derived-alerts+sink"
    assert named.at(3.0) == "host_outside_spans"


@pytest.fixture
def tiny_root(tmp_path):
    from benchmark.tests.tiny import make_root

    return make_root(tmp_path, base_config="geo-10k-sync",
                     base_traffic="tracking",
                     traffic_changes={"nonfinite_share": 0.01},
                     config_changes={"zone_box": [-60.0, 60.0],
                                     "zone_radius": [8.0, 20.0]})


def _on_cpu(monkeypatch):
    from benchmark import run

    monkeypatch.setattr(run, "require_cards", lambda n: torch.device("cpu"))
    # this process holds the JAX reference for the other tests; the
    # harness's refusal of it guards benchmark processes, not this one
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])


def test_a_tiny_traced_run_reads_the_plans(tiny_root, monkeypatch):
    tool = _tool()
    _on_cpu(monkeypatch)
    rec = tool.run_once("tiny.cell", 3_000_000_019, 1.0, 1, 1.0,
                        root=str(tiny_root))
    assert rec["rc"] == 0 and rec["result"]["correct"] is True
    assert rec["spans_evicted"] == 0
    got = rec["readings"]
    assert got["plans"] > 0 and got["device_marked_plans"] == got["plans"]
    for name in ("batcher_wait_ms", "card_wait_ms", "zones_device_ms",
                 "state_device_ms"):
        assert math.isfinite(got[name]) and got[name] >= 0, name
    assert set(got["device_stage_ms"]) == {
        "validate", "rules", "zones", "state", "derived", "pack"}
    assert "derived" in got["by_origin"]
    assert got["latency_ms"]["mean"] == pytest.approx(
        got["program_latency_ms"]["mean"], rel=0.05)


def test_tiny_untraced_runs_at_both_sample_rates(tiny_root, monkeypatch):
    tool = _tool()
    _on_cpu(monkeypatch)
    for rate in (1.0, 0.0):
        rec = tool.run_once("tiny.cell", 11, 0.5, 0, rate,
                            root=str(tiny_root))
        assert rec["result"]["correct"] is True
        assert rec["result"]["metrics"]["events_per_s"]["value"] > 0
        assert "readings" not in rec
