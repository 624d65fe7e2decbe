"""The port's span tracer on one clock, and the dispatcher's per-plan
span tree, on the CPU.

- ``runtime/tracing.py``: span starts and ends, ``Trace.record`` and the
  anomaly stamps on ``time.perf_counter`` (the clock a device trace is
  aligned to); wall time only at export; the thread a span ran on; a
  trace's root span; the finished ring's evictions counted.
- ``PipelineDispatcher`` driven by its caller at a tiny size, alerts
  firing, under ``Tracer(sample_rate=1.0)``: each plan's trace is one
  tree (batcher wait and intake, staging, dispatch, the in-flight window,
  the output fetch, the egress legs, the step's device stages), every
  span tagged with the plan's seq and rows; a derived alert's plan names
  the plan whose egress re-injected it.  At ``sample_rate=0.0`` no span
  is built and no stage boundary is marked.
"""

import collections
import threading
import time

import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.pipeline import step as step_mod
from sitewhere_tpu_torch.pipeline import telemetry
from sitewhere_tpu_torch.runtime import tracing
from sitewhere_tpu_torch.runtime.tracing import Span, Tracer, span_clock
from torch_parity import WIRE_TS0_MS, WIRE_WIDTH, wire_payload, wire_world

torch.set_num_threads(1)

SEED = 20261020


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def test_span_start_and_end_are_perf_counter_instants():
    tr = Tracer(sample_rate=1.0)
    trace = tr.trace("plan")
    t0 = time.perf_counter()
    with trace.span("stage") as span:
        time.sleep(0.002)
    t1 = time.perf_counter()
    assert span_clock is time.perf_counter
    assert t0 <= span.start_s < span.end_s <= t1
    assert span.duration_s == pytest.approx(span.end_s - span.start_s)
    assert span.duration_s >= 0.002


def test_record_takes_instants_and_a_length_ends_now():
    tr = Tracer(sample_rate=1.0)
    trace = tr.trace("plan")
    trace.record("wait", 10.25, 10.75, k=1)
    t0 = time.perf_counter()
    trace.record("stage", 0.5)
    t1 = time.perf_counter()
    wait, stage = tr.finished()
    assert (wait.start_s, wait.end_s, wait.tags) == (10.25, 10.75, {"k": 1})
    assert t0 <= stage.end_s <= t1
    assert stage.end_s - stage.start_s == pytest.approx(0.5)


def test_export_maps_instants_to_wall_time():
    tr = Tracer(sample_rate=1.0)
    with tr.trace("plan").span("stage"):
        pass
    (doc,) = tr.recent()
    assert abs(doc["start_s"] - time.time()) < 1.0
    assert set(doc) == {"trace_id", "span_id", "parent_id", "name",
                        "start_s", "duration_ms", "tags", "error"}


def test_anomaly_overlap_on_the_span_clock():
    tr = Tracer(sample_rate=0.0, tail_errors=True, tail_anomaly_window_s=5.0)
    trace = tr.trace("plan")
    with trace.span("step.dispatch") as span:
        tr.note_anomaly()   # now: inside the span's extent
    trace.end()
    assert span.start_s <= tr._anomalies[0] <= span.end_s
    assert tr.retained_anomaly == 1
    # a stamp 1000 s back on the same clock closed its window long ago
    tr = Tracer(sample_rate=0.0, tail_errors=True, tail_anomaly_window_s=5.0)
    tr.note_anomaly(ts=time.perf_counter() - 1000.0)
    trace = tr.trace("plan")
    with trace.span("step.dispatch"):
        pass
    trace.end()
    assert (tr.retained_anomaly, tr.dropped_tail) == (0, 1)
    assert not tr._anomalies   # expired against the span clock


def test_span_records_its_thread():
    tr = Tracer(sample_rate=1.0)
    trace = tr.trace("plan")
    idents = []

    def work():
        idents.append(threading.get_ident())
        with trace.span("worker"):
            pass

    th = threading.Thread(target=work)
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    with trace.span("caller"):
        pass
    by = {s.name: s.thread for s in tr.finished()}
    assert by == {"worker": idents[0], "caller": threading.get_ident()}


def test_root_span_is_the_parent_and_closes_once():
    tr = Tracer(sample_rate=1.0)
    start = time.perf_counter()
    trace = tr.trace("pipeline.plan", start=start)
    with trace.span("child"):
        pass
    trace.record("waited", start, start + 1e-3)
    trace.end()
    trace.end()
    spans = tr.finished()
    roots = [s for s in spans if s.name == "pipeline.plan"]
    assert len(roots) == 1 and roots[0].parent_id is None
    assert roots[0].start_s == start and roots[0].end_s >= start
    assert {s.parent_id for s in spans if s is not roots[0]} == {
        roots[0].span_id}
    # propagated context names the root as the remote spans' parent
    assert trace.propagate({})[tracing.PARENT_ID_HEADER] == roots[0].span_id


@pytest.mark.parametrize("retention", ["head", "tail"])
def test_spans_evicted_counts_ring_overflow(retention):
    if retention == "head":
        tr = Tracer(sample_rate=1.0, capacity=4)
        for _ in range(10):
            with tr.trace("plan").span("s"):
                pass
    else:
        tr = Tracer(sample_rate=0.0, capacity=4, tail_latency_s=0.0)
        trace = tr.trace("plan")
        for _ in range(10):
            with trace.span("s"):
                pass
        trace.end()
    assert len(tr.finished()) == 4
    assert tr.spans_evicted == 6
    assert tr.stats()["spans_evicted"] == 6


# ---------------------------------------------------------------------------
# the dispatcher's per-plan spans
# ---------------------------------------------------------------------------

HOST_SPANS = ("batch.wait", "batch.intake", "stage.h2d", "step.dispatch",
              "window.wait", "egress.fetch-outputs")
DEVICE_SPANS = tuple(f"device.{s}" for s in telemetry.SERVED_STAGES)


def traced_run(tmp_path, rate, ring_depth=0, kinds=None):
    """The wire world driven by its caller (egress inline) on the span
    clock, five payloads with alerts firing, then a flush."""
    tracer = Tracer(sample_rate=rate, capacity=1 << 16)
    world = wire_world("torch", tmp_path / "journal", ring_depth=ring_depth,
                       tracer=tracer)
    world.batcher.clock = span_clock
    rng = np.random.default_rng(SEED)
    kw = {"kinds": ("m",), "p": (1.0,)} if kinds == "meas" else {}
    for i in range(5):
        n = WIRE_WIDTH if kinds == "meas" else 70
        world.disp.ingest_wire_lines(
            wire_payload(rng, n, WIRE_TS0_MS + 1_000 * i, **kw))
    world.disp.flush()
    return world, tracer


def plan_traces(tracer):
    by = collections.defaultdict(list)
    for s in tracer.finished():
        by[s.trace_id].append(s)
    out = {}
    for spans in by.values():
        roots = [s for s in spans if s.name == "pipeline.plan"]
        if roots:
            out[roots[0].tags["seq"]] = (roots[0], spans)
    return out


def test_each_plan_is_one_span_tree(tmp_path):
    world, tracer = traced_run(tmp_path, 1.0)
    plans = plan_traces(tracer)
    assert world.disp.totals["derived_alerts"] > 0
    assert len(plans) == world.disp.steps >= 3
    assert tracer.spans_evicted == 0
    derived = []
    for seq, (root, spans) in plans.items():
        names = collections.Counter(s.name for s in spans)
        assert names["pipeline.plan"] == 1
        for name in HOST_SPANS + DEVICE_SPANS:
            assert names[name] == 1, (seq, name, names)
        assert names["egress.persist"] == 1
        assert root.parent_id is None
        assert root.tags["rows"] > 0
        for s in spans:
            if s is not root:
                assert s.parent_id == root.span_id, s.name
                assert s.tags["seq"] == seq, s.name
                assert s.tags["rows"] == root.tags["rows"], s.name
                assert root.start_s - 1e-6 <= s.start_s <= s.end_s, s.name
            if not s.name.startswith("device."):
                assert s.end_s <= root.end_s + 1e-6, s.name
        by = {s.name: s for s in spans}
        # the stages follow one another on the span clock
        order = [by[n] for n in HOST_SPANS]
        assert all(a.end_s <= b.start_s + 1e-6 for a, b in zip(
            order[1:], order[2:])), [(s.name, s.start_s, s.end_s)
                                     for s in order]
        assert by["batch.wait"].end_s <= by["batch.intake"].end_s
        assert all(by[n].tags["device_ms"] >= 0 for n in DEVICE_SPANS)
        wait = by["batch.wait"]
        if wait.tags["origin"] == "derived":
            derived.append((seq, wait.tags["source_seq"]))
        else:
            assert wait.tags["source_seq"] == -1
    assert derived
    for seq, source in derived:
        assert 0 <= source < seq
        assert any(s.name == "egress.derived-alerts"
                   for s in plans[source][1])
    # the roots account for the program's own plan latencies
    roots = np.array([r.end_s - r.start_s for r, _ in plans.values()])
    lat = np.array(world.disp.latencies_s)
    assert roots.mean() == pytest.approx(lat.mean(), rel=0.05)
    assert step_mod._stage_marks is None


def test_ring_plans_carry_the_wait_and_fetch_spans(tmp_path):
    world, tracer = traced_run(tmp_path, 1.0, ring_depth=2, kinds="meas")
    assert world.disp.metrics.counter("pipeline.ring_chains").value >= 1
    ringed = [spans for _, spans in plan_traces(tracer).values()
              if any(s.name == "ring.slot" for s in spans)]
    assert ringed
    for spans in ringed:
        names = {s.name for s in spans}
        assert {"batch.wait", "batch.intake", "stage.h2d", "ring.slot",
                "window.wait", "egress.fetch-outputs"} <= names
        assert not names & set(DEVICE_SPANS)


def test_unsampled_plans_build_no_span_and_mark_no_stage(tmp_path,
                                                         monkeypatch):
    built, marks, hooks = [], [], []
    span_init, marks_init = Span.__init__, telemetry.StageMarks.__init__

    def counted_span(self, *a, **kw):
        built.append(a[2] if len(a) > 2 else kw.get("name"))
        span_init(self, *a, **kw)

    def counted_marks(self, *a, **kw):
        marks.append(1)
        marks_init(self, *a, **kw)

    monkeypatch.setattr(Span, "__init__", counted_span)
    monkeypatch.setattr(telemetry.StageMarks, "__init__", counted_marks)
    monkeypatch.setattr(step_mod, "_mark_stage", lambda: hooks.append(1))
    world, tracer = traced_run(tmp_path, 0.0)
    assert world.disp.steps >= 3
    assert (built, marks, hooks) == ([], [], [])
    assert tracer.finished() == []
    assert tracer.stats()["traces_started"] >= world.disp.steps
