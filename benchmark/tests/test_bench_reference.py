"""The plain reference on hand-made rows, and the comparison failing on
deliberately wrong outputs."""

import copy
import math

import numpy as np
import pytest
import torch

from benchmark.reference import compare, plain

TS = 1_700_000_000


def small_world():
    cap = 8
    ids = np.arange(cap)
    on = ids < 6
    registry = dict(
        active=on, tenant_id=np.where(on, 0, -1),
        device_type_id=np.where(on, ids % 16, -1),
        assignment_id=np.where(on, ids, -1),
        # device 5 is registered but holds no active assignment
        assignment_status=np.where(on & (ids != 5), 1, 0),
        area_id=np.where(on, ids % 64, -1), customer_id=np.where(on, ids, -1),
        asset_id=np.where(on, ids, -1))
    rules = dict(
        active=np.ones(3, bool), tenant_id=np.full(3, -1),
        mtype_id=np.array([0, 1, 2]), op=np.zeros(3, np.int64),
        threshold=np.array([50.0, 12.0, 5.0], np.float32),
        alert_code=np.array([1000, 1001, 1002]),
        alert_level=np.array([0, 1, 2]),
        kind=np.array([plain.KIND_INSTANT, plain.KIND_WINDOW_MEAN,
                       plain.KIND_RATE]),
        window_idx=np.zeros(3, np.int64),
        ewma_tau_s=np.array([60.0], np.float32))
    square = np.array([[0, 0], [10, 0], [10, 10], [0, 10]], np.float32)
    zones = dict(active=np.ones(1, bool), tenant_id=np.full(1, -1),
                 area_id=np.full(1, -1), verts=square[None],
                 nvert=np.array([4]), condition=np.zeros(1, np.int64),
                 alert_code=np.array([2000]), alert_level=np.array([3]))
    return {"registry": registry, "rules": rules, "zones": zones}


def rows_of(*rows):
    """Rows as (ref, dev, type, ts_s, ts_ns, mtype, value, lon, lat)."""
    a = np.array(rows, dtype=np.float64)
    return dict(
        ref=a[:, 0].astype(np.int64), device_id=a[:, 1].astype(np.int32),
        event_type=a[:, 2].astype(np.int32), ts_s=a[:, 3].astype(np.int32),
        ts_ns=a[:, 4].astype(np.int32), mtype_id=a[:, 5].astype(np.int32),
        value=a[:, 6].astype(np.float32), lon=a[:, 7].astype(np.float32),
        lat=a[:, 8].astype(np.float32),
        elevation=np.zeros(len(rows), np.float32),
        alert_code=np.full(len(rows), -1, np.int32),
        alert_level=np.zeros(len(rows), np.int32))


M, L = plain.MEASUREMENT, plain.LOCATION
ROWS = rows_of(
    # plan 0: rows 0-5
    (0, 0, M, TS, 0, 0, 60.0, 0, 0),       # instant rule fires
    (1, 1, M, TS, 0, 1, 20.0, 0, 0),       # seeds the EWMA: window rule fires
    (2, 1, M, TS, 0, 1, 30.0, 0, 0),       # same device, slot and time: wins
    (3, 2, L, TS, 5, 0, 1.0, 5.0, 5.0),    # inside the square
    (4, 7, M, TS, 0, 0, 99.0, 0, 0),       # unregistered: not stored
    (5, 5, M, TS, 0, 0, 99.0, 0, 0),       # unassigned: not stored
    # plan 1: rows 6-9
    (6, 1, M, TS + 60, 0, 1, 0.0, 0, 0),   # EWMA 30 -> 30 + a * (0 - 30)
    (7, 3, M, TS, 0, 0, math.nan, 0, 0),   # non-finite: stored, no state
    (8, 2, L, TS - 5, 0, 0, 1.0, 50.0, 5.0),  # older than the state
    (9, 2, L, TS + 1, 0, 0, 1.0, 50.0, 5.0),  # outside the square
)
PLANS = np.array([[0, 5], [6, 9]])
SAMPLE = np.array([0, 1, 2, 3, 5, 7])


def reference():
    return plain.outcome(small_world(), ROWS, SAMPLE, PLANS, 4)


def test_reference_on_hand_made_rows():
    out, ambiguous = reference()
    assert ambiguous.size == 0
    assert out.stored_refs.tolist() == [0, 1, 2, 3, 6, 7, 8, 9]
    assert sorted(map(tuple, out.alerts[:, :3].tolist())) == [
        (0, 1000, 0), (1, 1001, 1), (2, 1001, 1), (3, 2000, 3)]
    c = {d: i for i, d in enumerate(SAMPLE)}
    st = out.state
    # the later of two rows at one time wins; the EWMA folds from it
    assert st["last_values"][c[1], 1] == 0.0
    alpha = np.float32(1) - np.exp(np.float32(-60.0) / np.float32(60.0))
    want = np.float32(30.0) + alpha * (np.float32(0.0) - np.float32(30.0))
    assert st["ewma_values"][c[1], 1, 0] == pytest.approx(want, abs=1e-5)
    # newest wins: the row older than the state does not replace it
    assert st["last_location_ts_s"][c[2]] == TS + 1
    assert st["last_lon"][c[2]] == 50.0
    assert st["nonfinite_count"][c[3]] == 1
    assert st["last_event_type"][c[3]] == -1
    assert st["last_event_type"][c[5]] == -1
    assert out.state_changes.tolist() == [0] * SAMPLE.size


def test_every_row_of_a_plan_reads_the_state_before_it():
    # one plan: row 6 folds from the unseeded state, so its EWMA is 0
    out, _ = plain.outcome(small_world(), ROWS, SAMPLE,
                           np.array([[0, 9]]), 4)
    c1 = int(np.searchsorted(SAMPLE, 1))
    assert out.state["ewma_values"][c1, 1, 0] == 0.0
    assert out.state["last_values"][c1, 1] == 0.0


def test_bfloat16_control_rounds_every_float():
    assert plain.to_bfloat16(np.float32(1.0 + 2 ** -9)) == 1.0
    x = np.random.default_rng(1).normal(0, 100, 4096).astype(np.float32)
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    assert np.array_equal(plain.to_bfloat16(x), want)
    assert np.isnan(plain.to_bfloat16(np.float32("nan")))
    ctl, _ = plain.outcome(small_world(), ROWS, SAMPLE, PLANS, 4,
                           precision="bfloat16")
    exp, amb = reference()
    numbers = compare.outcome_gaps(exp, ctl, amb)
    assert numbers["ewma_gap"] > 1e-3


def _numbers(exp, obs, amb):
    n = compare.outcome_gaps(exp, obs, amb)
    n.update(rows_misplaced=0, stored_total_gap=0, enrich_wrong=0)
    return n


LIMITS = {name: 0 for name in compare.CHECKS} | {"ewma_gap": 1e-3}


def test_the_reference_passes_against_itself():
    exp, amb = reference()
    ok, checks, lines = compare.verdict(_numbers(exp, copy.deepcopy(exp),
                                                 amb), LIMITS)
    assert ok
    assert len(lines) == len(compare.CHECKS)


@pytest.mark.parametrize("fault", ["alert_dropped", "row_stored_twice",
                                   "state_off", "ewma_off",
                                   "state_change_missing"])
def test_the_comparison_fails_on_a_wrong_output(fault):
    exp, amb = reference()
    obs = copy.deepcopy(exp)
    if fault == "alert_dropped":
        obs.alerts = obs.alerts[1:]
    elif fault == "row_stored_twice":
        obs.stored_refs = np.sort(np.append(obs.stored_refs, 3))
    elif fault == "state_off":
        obs.state["last_alert_code"][0] = 7
    elif fault == "ewma_off":
        obs.state["ewma_values"][1, 1, 0] += 0.01
    else:
        obs.state_changes[0] = 1
    ok, _, _ = compare.verdict(_numbers(exp, obs, amb), LIMITS)
    assert not ok


def test_rows_misplaced_counts_order_gaps_and_overlaps():
    w = 10
    good = np.array([[0, 9, 10, 10], [10, 14, 5, 7], [15, 24, 10, 10]])
    assert compare.rows_misplaced(good, 25, w) == 0
    swapped = good[[0, 2, 1]]
    assert compare.rows_misplaced(swapped, 25, w) > 0
    assert compare.rows_misplaced(good[:2], 25, w) == 10
    wide = good.copy()
    wide[1, 3] = 12
    assert compare.rows_misplaced(wide, 25, w) == 2


def test_order_inversions_per_device():
    plans = np.array([[0, 4], [10, 14], [5, 9]])   # stepped out of order
    refs = np.array([1, 6, 11, 12])
    dev = np.array([1, 1, 1, 2])
    # device 1: rows 1 (plan 0), 6 (plan 2), 11 (plan 1): 6 comes after 11
    assert compare.order_inversions(plans, refs, dev) == 1
    assert compare.order_inversions(plans[[0, 2, 1]], refs, dev) == 0


def test_enrich_wrong():
    reg = small_world()["registry"]
    dev = np.array([0, 1])
    enrich = {n: reg[n][dev].copy() for n in plain.ENRICHMENT}
    assert compare.enrich_wrong(dev, enrich, reg) == 0
    enrich["area_id"][1] += 1
    assert compare.enrich_wrong(dev, enrich, reg) == 1


def test_device_trace_summary_clips_aligns_and_names_gaps():
    from benchmark import devtrace

    spans = devtrace.HostSpans()
    # host clock: window [10.0, 10.3]; the trace clock is host - 9.0
    spans.spans = [(1, "ring_dispatch", 10.05, 10.25), (2, "egress", 10.0, 10.1)]
    events = [(devtrace.MARKER, 1.0, 1.00001), (devtrace.MARKER, 1.3, 1.30001),
              ("pip_parity_kernel<16, true>", 0.95, 1.05),   # clipped at 1.0
              ("Memcpy HtoD", 1.04, 1.06),                  # overlaps
              ("other", 1.2, 1.3)]
    # the opening marker (host 9.99) is missing from the trace
    out = devtrace.summarize(events, 10.0, 10.3, [9.99, 10.0, 10.3], 4, spans,
                             t_start=9.5)
    assert out["aligned"] and out["markers"] == 2
    assert out["busy_s"] == pytest.approx(0.06 + 0.1)
    assert out["kernel_s"] == pytest.approx(0.05 + 0.1)
    assert out["copy_s"] == pytest.approx(0.02)
    assert out["pip_launches"] == 1
    assert out["idle_gaps"][0][0] == "ring_dispatch"
    assert out["idle_gaps"][0][1] == pytest.approx(0.14)
    # without markers the trace clock is taken from the profiler's start
    plain_events = [e for e in events if e[0] != devtrace.MARKER]
    out = devtrace.summarize(plain_events, 10.0, 10.3, [], 4, None,
                             t_start=9.0)
    assert not out["aligned"] and out["busy_s"] == pytest.approx(0.16)
