"""The streaming analytics operators of the port against the JAX package's,
on the CPU.

The same numpy inputs go through the JAX function and the port's
(``device="cpu"``).  Values lie on a 1/8 grid (signed deviations from a
set point, |v| <= 64, like a 0.125-resolution sensor), so every window
sum and sum of squares is exact in float32 whatever the order, and every
float output is held BITWISE: ints, bools, sort orders, session ids and
matches exactly, floats bit for bit.  Two aggregates follow XLA's own
rounding: ``rate`` (the jit folds the division by the constant span into
a reciprocal multiply) and ``std`` (XLA:CPU fuses ``ssq/n - m*m`` into
one FMA); the port reproduces both.  One test feeds continuous values:
its aggregates agree within ``CONT_MAX_ULP`` ULPs and its thresholds sit
outside that bound, so its matches are equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.analytics import cep as rcep
from sitewhere_tpu.analytics import query as rq
from sitewhere_tpu.analytics import runner as rrun
from sitewhere_tpu.analytics import windows as rwin
from sitewhere_tpu_torch.analytics import cep as pcep
from sitewhere_tpu_torch.analytics import query as pq
from sitewhere_tpu_torch.analytics import runner as prun
from sitewhere_tpu_torch.analytics import windows as pwin
from sitewhere_tpu_torch.schema import ComparisonOp, EventType

torch.set_num_threads(1)

CPU = torch.device("cpu")
M = int(EventType.MEASUREMENT)
A = int(EventType.ALERT)
T0 = 1_753_800_000
CAP = 16
CONT_MAX_ULP = 4
Z_MAX_ULP = 64


def grid_values(rng, n):
    return (rng.integers(-512, 513, n) / 8).astype(np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def j(x):
    return jnp.asarray(np.asarray(x))


def assert_bitwise(ref, got, what=""):
    a, b = np.asarray(ref), np.asarray(got)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), (what, np.nonzero(a != b))


def assert_fields(ref, got, what=""):
    for f in dataclasses.fields(ref):
        assert_bitwise(getattr(ref, f.name), getattr(got, f.name),
                       f"{what}.{f.name}")


def batch(rng, n=64, cap=CAP, t0=T0, span=400, ok_share=0.9):
    """Rows over ``cap + 3`` device ids (a few out of range, some NULL),
    ``span`` seconds of event time from ``t0``, grid values."""
    dev = rng.integers(-1, cap + 2, n).astype(np.int32)
    ts = (t0 + rng.integers(0, span, n)).astype(np.int32)
    et = rng.choice([M, M, M, A, 1], n).astype(np.int32)
    mt = rng.integers(-1, 3, n).astype(np.int32)
    return dev, ts, et, mt, grid_values(rng, n), rng.random(n) < ok_share


# -- windows.py -------------------------------------------------------------


@pytest.mark.parametrize("op", list(range(6)))
def test_compare_and_compare_traced(op):
    rng = np.random.default_rng(op)
    v, thr = grid_values(rng, 64), grid_values(rng, 64)
    thr[:8] = v[:8]                              # ties
    assert_bitwise(rwin.compare(op, j(v), jnp.float32(2.0)),
                   pwin.compare(op, t(v), 2.0))
    ops = rng.integers(-1, 7, 64).astype(np.int32)
    assert_bitwise(rwin.compare_traced(j(ops), j(v), j(thr)),
                   pwin.compare_traced(t(ops), t(v), t(thr)))


@pytest.mark.parametrize("seed", range(2))
def test_aggregate_and_sliding_windows(seed):
    rng = np.random.default_rng(seed)
    n, d, w = 256, 8, 16
    dev = rng.integers(-1, d + 1, n).astype(np.int32)
    win = rng.integers(-1, w + 1, n).astype(np.int32)
    val = grid_values(rng, n)
    val[:3] = (np.nan, np.inf, -np.inf)
    ok = rng.random(n) < 0.9
    ref = rwin.aggregate_windows(j(dev), j(win), j(val), j(ok),
                                 n_devices=d, n_windows=w)
    got = pwin.aggregate_windows(t(dev), t(win), t(val), t(ok),
                                 n_devices=d, n_windows=w)
    assert_fields(ref, got, "grid")
    for agg in rwin.AGGREGATES:
        assert_bitwise(ref.aggregate(agg, window_s=60.0),
                       got.aggregate(agg, window_s=60.0), agg)
    assert_bitwise(ref.occupancy(), got.occupancy())
    for length in (1, 2, 3):
        assert_fields(rwin.sliding_aggregates(ref, length),
                      pwin.sliding_aggregates(got, length), f"L{length}")


def test_aggregate_windows_continuous_values_row_order():
    """Continuous values: the port's segmented sum adds each cell's rows
    in row order from zero, as XLA:CPU's scatter-add does."""
    rng = np.random.default_rng(7)
    n, d, w = 512, 4, 4
    dev = rng.integers(0, d, n).astype(np.int32)
    win = rng.integers(0, w, n).astype(np.int32)
    val = rng.normal(100.0, 30.0, n).astype(np.float32)
    ok = np.ones(n, bool)
    assert_fields(
        rwin.aggregate_windows(j(dev), j(win), j(val), j(ok), d, w),
        pwin.aggregate_windows(t(dev), t(win), t(val), t(ok), d, w))


@pytest.mark.parametrize("seed", range(3))
def test_sort_by_device_time_and_sessionize(seed):
    rng = np.random.default_rng(seed)
    n = 128
    dev = rng.integers(-1, 6, n).astype(np.int32)
    ts = (T0 + rng.integers(0, 50, n) * 40).astype(np.int32)   # ties
    valid = rng.random(n) < 0.85
    assert_bitwise(rwin.sort_by_device_time(j(dev), j(ts), j(valid)),
                   pwin.sort_by_device_time(t(dev), t(ts), t(valid)))
    for gap in (40, 100, 400):
        assert_fields(rwin.sessionize(j(dev), j(ts), j(valid), jnp.int32(gap)),
                      pwin.sessionize(t(dev), t(ts), t(valid), gap),
                      f"gap{gap}")


# -- query.py operators ------------------------------------------------------


def _run_window(pkg, batches, L, agg, op, thr, min_count=1):
    mod = rq if pkg == "jax" else pq
    state = (rq.WindowOpState.empty(CAP, L) if pkg == "jax"
             else pq.WindowOpState.empty(CAP, L, CPU))
    conv = j if pkg == "jax" else t
    outs = []
    for dev, ts, _, _, val, ok in batches:
        threshold = jnp.float32(thr) if pkg == "jax" else thr
        state, out = mod.window_eval(
            state, conv(dev), conv(ts), conv(val), conv(ok), threshold,
            window_s=60, length=L, agg=agg, op=op, min_count=min_count)
        outs.append(out)
    flush = mod.window_flush(state, jnp.float32(thr) if pkg == "jax"
                             else thr, window_s=60, length=L, agg=agg,
                             op=op, min_count=min_count)
    return state, outs, flush


@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("agg", rwin.AGGREGATES)
def test_window_eval_and_flush(L, agg):
    """Three batches carried through both operators: every output of
    every batch, the carried state and the flush, bit for bit.  Batches
    span several windows per device (the ring's slot collisions) and
    include out-of-order rows."""
    rng = np.random.default_rng(10 * L + rwin.AGGREGATES.index(agg))
    batches = [batch(rng, t0=T0 + 240 * b) for b in range(3)]
    thr = {"count": 1.5, "rate": 0.02}.get(agg, 2.0)
    rs, ro, rf = _run_window("jax", batches, L, agg, int(ComparisonOp.GT),
                             thr, min_count=2 if agg == "max" else 1)
    ps, po, pf = _run_window("torch", batches, L, agg, int(ComparisonOp.GT),
                             thr, min_count=2 if agg == "max" else 1)
    for b, (a, g) in enumerate(zip(ro, po)):
        for k in a:
            assert_bitwise(a[k], g[k], f"batch {b} {k}")
        assert np.asarray(a["match"]).any() or np.asarray(
            a["carry_match"]).any() or b == 0
    assert_fields(rs, ps, "state")
    for k in rf:
        assert_bitwise(rf[k], pf[k], f"flush {k}")


def test_window_ring_one_device_spans_more_than_L_hops():
    """One device covers 9 hops of a 4-hop sliding window in one batch:
    the ring's slots collide and the latest window must win each one."""
    L, n = 4, 64
    ts = np.full(n, T0, np.int32)
    ts[:27] = T0 + 60 * np.arange(9).repeat(3)
    dev = np.full(n, 3, np.int32)
    val = grid_values(np.random.default_rng(2), n)
    ok = np.arange(n) < 27
    late = ok & (ts >= T0 + 60 * 6)             # a later batch: 3 hops on
    rows = [(dev, ts, None, None, val, ok),
            (dev, ts + 60 * 3, None, None, val, late)]
    rs, ro, rf = _run_window("jax", rows, L, "sum", int(ComparisonOp.GT),
                             -1e9)
    ps, po, pf = _run_window("torch", rows, L, "sum", int(ComparisonOp.GT),
                             -1e9)
    assert_fields(rs, ps, "state")
    hop0 = T0 // 60
    assert sorted(np.asarray(ps.ring_win)[3].tolist()) == \
        [hop0 + h for h in (7, 8, 9, 10)]
    for a, g in zip(ro, po):
        for k in a:
            assert_bitwise(a[k], g[k], k)


@pytest.mark.parametrize("agg,op", [("count", int(ComparisonOp.GT)),
                                    ("duration_s", int(ComparisonOp.LTE))])
def test_session_eval_and_flush(agg, op):
    rng = np.random.default_rng(11 + op)
    thr = 2.0 if agg == "count" else 100.0
    rstate, pstate = rq.SessionOpState.empty(CAP), \
        pq.SessionOpState.empty(CAP, CPU)
    for b in range(3):
        dev, ts, _, _, _, ok = batch(rng, t0=T0 + 300 * b)
        rstate, ro = rq.session_eval(rstate, j(dev), j(ts), j(ok),
                                     jnp.int32(60), jnp.float32(thr),
                                     agg=agg, op=op)
        pstate, po = pq.session_eval(pstate, t(dev), t(ts), t(ok), 60, thr,
                                     agg=agg, op=op)
        for k in ro:
            assert_bitwise(ro[k], po[k], f"batch {b} {k}")
    assert_fields(rstate, pstate, "state")
    rf = rq.session_flush(rstate, jnp.float32(thr), agg=agg, op=op)
    pf = pq.session_flush(pstate, thr, agg=agg, op=op)
    for k in rf:
        assert_bitwise(rf[k], pf[k], f"flush {k}")


# -- cep.py ------------------------------------------------------------------


def _steps(pkg):
    mod = rcep if pkg == "jax" else pcep
    return [mod.PatternStep(window_cross=True),
            mod.PatternStep(event_type=M, has_value=True,
                            op=int(ComparisonOp.LT), threshold=-2.0,
                            within_s=90),
            mod.PatternStep(event_type=A, within_s=120)]


def test_cep_features_and_passes():
    """cep_features then cep_pass until quiescent, over three batches:
    the sort, the cross feature, every pass's outputs and the state."""
    rng = np.random.default_rng(5)
    rprog = rcep.CepProgram.compile(_steps("jax"), window_s=60,
                                    cross_threshold=4.0, cross_mtype=1)
    pprog = pcep.CepProgram.compile(_steps("torch"), window_s=60,
                                    cross_threshold=4.0, cross_mtype=1,
                                    device=CPU)
    rstate, pstate = rcep.CepState.empty(CAP), pcep.CepState.empty(CAP, CPU)
    passes = 0
    for b in range(3):
        dev, ts, et, mt, val, ok = batch(rng, n=128, t0=T0 + 200 * b,
                                         span=300)
        rstate = dataclasses.replace(
            rstate, frontier=jnp.full(CAP, -1, jnp.int32))
        pstate = dataclasses.replace(
            pstate, frontier=torch.full((CAP,), -1, dtype=torch.int32))
        kw = dict(window_s=60, cross_op=int(ComparisonOp.GT),
                  cross_enabled=True)
        rstate, rorder, rcross = rcep.cep_features(
            rstate, j(dev), j(ts), j(et), j(mt), j(val), j(ok),
            cross_threshold=jnp.float32(4.0), cross_mtype=jnp.int32(1), **kw)
        pstate, porder, pcross = pcep.cep_features(
            pstate, t(dev), t(ts), t(et), t(mt), t(val), t(ok),
            cross_threshold=4.0, cross_mtype=1, **kw)
        assert_bitwise(rorder, porder, "order")
        assert_bitwise(rcross, pcross, "cross")
        assert_fields(rstate, pstate, "features state")
        o = np.asarray(rorder)
        sorted_cols = [x[o] for x in (dev, ts, et, mt, val, ok)]
        while True:
            r = rcep.cep_pass(rstate, (rprog.step_event_type,
                                       rprog.step_mtype, rprog.step_has_value,
                                       rprog.step_op, rprog.step_threshold,
                                       rprog.step_cross, rprog.step_within),
                              *map(j, sorted_cols), rcross, n_steps=3)
            p = pcep.cep_pass(pstate, pprog.tables(), *map(t, sorted_cols),
                              pcross, n_steps=3)
            rstate, pstate = r[0], p[0]
            assert_fields(rstate, pstate, "pass state")
            for k, (a, g) in enumerate(zip(r[1:], p[1:])):
                assert_bitwise(a, g, f"pass output {k}")
            passes += 1
            if int(r[-1]) == 0:
                break
    assert passes > 3


# -- compiled queries over batch splits --------------------------------------


def _cols(rows):
    dev, ts, et, mt, val = map(np.asarray, zip(*rows))
    return {"device_id": dev.astype(np.int32), "ts_s": ts.astype(np.int32),
            "event_type": et.astype(np.int32),
            "mtype_id": mt.astype(np.int32), "value": val.astype(np.float32)}


def _matches(compiled, rows, split=None):
    compiled.reset()
    split = split or len(rows)
    out = []
    for lo in range(0, len(rows), split):
        out += compiled.eval_cols(_cols(rows[lo:lo + split]))
    state = compiled.export_state()
    out += compiled.flush()
    return [m.to_dict() for m in out], state


def _compile_both(spec_doc, capacity=8, resolve=None):
    ref = rq.compile_query(rq.parse_query(spec_doc, resolve), capacity,
                           resolve_mtype=resolve)
    got = pq.compile_query(pq.parse_query(spec_doc, resolve), capacity,
                           resolve_mtype=resolve, device=CPU)
    return ref, got


# The reference's TestCompiledOperators cases (tests/test_streaming_
# analytics.py), each run through both packages over splits 1, 2, 3 and
# whole: equal matches and equal exported state at every split.
_CASES = {
    "tumbling": ({"kind": "window", "name": "w", "threshold": 25.0,
                  "agg": "mean", "windowS": 300},
                 [(0, 0, M, 1, 20.0), (0, 10, M, 1, 40.0),
                  (0, 300, M, 1, 10.0), (0, 600, M, 1, 50.0),
                  (1, 0, M, 1, 10.0), (1, 310, M, 1, 20.0)]),
    "sliding": ({"kind": "window", "name": "s", "threshold": 25.0,
                 "agg": "mean", "windowS": 300, "length": 2},
                [(0, 0, M, 1, 40.0), (0, 300, M, 1, 20.0),
                 (0, 600, M, 1, 10.0), (0, 900, M, 1, 80.0),
                 (0, 1800, M, 1, 5.0)]),
    "sliding-max": ({"kind": "window", "name": "mx", "threshold": 39.0,
                     "agg": "max", "windowS": 100, "length": 3},
                    [(0, 0, M, 1, 40.0), (0, 100, M, 1, 1.0),
                     (0, 200, M, 1, 2.0), (0, 300, M, 1, 3.0)]),
    "session-count": ({"kind": "session", "name": "sess", "threshold": 2.0,
                       "gapS": 100, "agg": "count"},
                      [(0, 0, M, 1, 1.0), (0, 50, M, 1, 1.0),
                       (0, 150, M, 1, 1.0), (0, 400, M, 1, 1.0),
                       (1, 0, M, 1, 1.0), (1, 100, M, 1, 1.0)]),
    "session-duration": ({"kind": "session", "name": "d", "threshold": 99.0,
                          "gapS": 60, "agg": "duration_s", "op": "gte"},
                         [(0, 0, M, 1, 1.0), (0, 50, M, 1, 1.0),
                          (0, 100, M, 1, 1.0), (0, 500, M, 1, 1.0)]),
    "pattern-carry": ({"kind": "pattern", "name": "p", "steps": [
        {"eventType": "measurement", "threshold": 10.0, "op": "gt"},
        {"eventType": "alert", "withinS": 5}]},
        [(0, 100, M, 1, 12.0), (0, 103, A, -1, 0.0),
         (1, 100, M, 1, 5.0), (1, 101, A, -1, 0.0),
         (2, 100, M, 1, 20.0), (2, 110, A, -1, 0.0),
         (2, 111, M, 1, 30.0), (2, 112, A, -1, 0.0)]),
    "pattern-unbounded": ({"kind": "pattern", "name": "nodl", "steps": [
        {"eventType": "measurement", "threshold": 10.0},
        {"eventType": "alert"}]},
        [(0, 100, M, 1, 50.0), (0, 7300, A, -1, 0.0)]),
    "pattern-two-in-one-batch": ({"kind": "pattern", "name": "p2", "steps": [
        {"eventType": "measurement", "threshold": 10.0, "op": "gt"},
        {"eventType": "alert", "withinS": 5}]},
        [(3, 10, M, 1, 50.0), (3, 11, A, -1, 0.0),
         (3, 12, M, 1, 50.0), (3, 13, A, -1, 0.0)]),
    "window-cross": ({"kind": "pattern", "name": "cx", "windowS": 300,
                      "crossOp": "gt", "crossThreshold": 25.0, "steps": [
                          {"windowCross": True},
                          {"eventType": "alert", "withinS": 60}]},
                     [(0, 1000, M, 1, 20.0), (0, 1010, M, 1, 24.0),
                      (0, 1020, M, 1, 40.0), (0, 1050, A, -1, 0.0),
                      (1, 1000, M, 1, 20.0), (1, 1100, A, -1, 0.0),
                      (2, 1000, M, 1, 30.0), (2, 1200, A, -1, 0.0)]),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_compiled_operator_cases(case):
    doc, rows = _CASES[case]
    ref, got = _compile_both(doc)
    full, state = _matches(got, rows)
    assert full
    for split in (None, 1, 2, 3):
        r, rstate = _matches(ref, rows, split)
        g, gstate = _matches(got, rows, split)
        assert g == r == full, split
        assert rstate.keys() == gstate.keys()
        for k in rstate:
            assert_bitwise(rstate[k], gstate[k], f"{split} {k}")


_RANDOM_DOCS = {
    "mean": {"kind": "window", "name": "mean", "mtype": "temp",
             "agg": "mean", "op": "gt", "threshold": 6.0, "windowS": 60},
    "burst": {"kind": "session", "name": "burst", "gapS": 30, "agg": "count",
              "op": "gte", "threshold": 3.0},
    "cross": {"kind": "pattern", "name": "cross", "windowS": 60,
              "crossOp": "gt", "crossThreshold": 8.0, "crossMtype": "temp",
              "steps": [{"windowCross": True},
                        {"eventType": "alert", "withinS": 300}]},
}


def _random_rows(rng, n, values, disorder=0):
    """``n`` rows over 6 devices and 600 s, 80% measurements (two
    types), in time order, or with arrival jittered by ``disorder`` s."""
    rows = []
    for i in range(n):
        kind = M if rng.random() < 0.8 else A
        rows.append((int(rng.integers(0, 6)), T0 + int(rng.integers(0, 600)),
                     kind, int(rng.integers(0, 2)) if kind == M else -1,
                     float(values[i])))
    jitter = rng.integers(-disorder, disorder + 1, n) if disorder else \
        np.zeros(n, int)
    keys = [r[1] + int(d) for r, d in zip(rows, jitter)]
    return [rows[i] for i in np.argsort(keys, kind="stable")]


def _key(m):
    return m["ts_s"], m["device_id"], m["start_ts_s"]


@pytest.mark.parametrize("name", sorted(_RANDOM_DOCS))
def test_compiled_queries_random_stream_splits(name):
    """A random stream of 64 rows in time order, whole and split 16 / 5:
    both packages give the same matches and the same exported state at
    each split, equal to the whole-stream run (split invariance).  The
    same stream with arrival jittered by +-20 s (late rows), split 16:
    the same matches and state in both packages."""
    rng = np.random.default_rng(sorted(_RANDOM_DOCS).index(name))
    names = {"temp": 0, "hum": 1}
    ref, got = _compile_both(_RANDOM_DOCS[name], capacity=16,
                             resolve=names.__getitem__)
    values = grid_values(rng, 64)
    for disorder, splits in ((0, (None, 16, 5)), (20, (16,))):
        rows = _random_rows(np.random.default_rng(7), 64, values, disorder)
        whole, _ = _matches(got, rows)
        assert whole
        for split in splits:
            r, rstate = _matches(ref, rows, split)
            g, gstate = _matches(got, rows, split)
            assert g == r, (disorder, split)
            if not disorder:
                # a later batch may finalize an earlier window: the same
                # matches, in batch order
                assert sorted(g, key=_key) == sorted(whole, key=_key), split
            for k in rstate:
                assert_bitwise(rstate[k], gstate[k], f"{split} {k}")


def test_continuous_values_within_ulp_bound():
    """Continuous values (not on the grid): window sums stay row-order
    sums, so values agree within CONT_MAX_ULP ULPs; the thresholds sit
    outside that bound, so the matches are equal."""
    rng = np.random.default_rng(99)
    rows = _random_rows(rng, 200, rng.normal(5.0, 20.0, 200))
    doc = {"kind": "window", "name": "m", "agg": "mean", "op": "gt",
           "threshold": 4.0, "windowS": 300, "length": 2}
    ref, got = _compile_both(doc, capacity=16)
    r, _ = _matches(ref, rows, 50)
    g, _ = _matches(got, rows, 50)
    assert len(r) == len(g) > 0
    for a, b in zip(r, g):
        assert {k: v for k, v in a.items() if k != "value"} == \
            {k: v for k, v in b.items() if k != "value"}
        ulp = np.spacing(np.float32(abs(a["value"])))
        assert abs(a["value"] - b["value"]) <= CONT_MAX_ULP * ulp
        assert abs(a["value"] - 4.0) > CONT_MAX_ULP * ulp


def test_parse_and_describe_round_trip():
    spec = pq.parse_query({
        "kind": "pattern", "name": "p", "windowS": 120, "crossThreshold": 5.5,
        "steps": [{"windowCross": True},
                  {"eventType": "alert", "withinS": 30}]})
    assert isinstance(spec, pq.PatternQuery)
    assert spec.steps[1].event_type == A and spec.steps[1].within_s == 30
    doc = {"kind": "pattern", "name": "q", "crossMtype": "temp",
           "steps": [{"eventType": "measurement", "mtype": "temp",
                      "threshold": 3, "op": "lte"},
                     {"eventType": 2, "withinS": 9}]}
    names = {"temp": 5}.__getitem__
    assert pq.describe_query(pq.parse_query(doc, names)) == \
        rq.describe_query(rq.parse_query(doc, names))
    again = pq.parse_query(pq.describe_query(pq.parse_query(
        {"kind": "window", "name": "w", "agg": "std", "length": 2})))
    assert again == pq.parse_query({"kind": "window", "name": "w",
                                    "agg": "std", "length": 2})
    for bad in ({"kind": "window", "name": "x", "op": "junk"},
                {"kind": "nope", "name": "x"}, {"kind": "window"},
                {"kind": "window", "name": "x", "agg": "median"},
                {"kind": "session", "name": "x", "gapS": 0}):
        with pytest.raises(ValueError):
            pq.parse_query(bad)


# -- runner.py batch job and charts.py ----------------------------------------


def test_window_grid_and_anomalies():
    """build_window_grid bitwise; detect_anomalies' trailing sums are
    cumulative sums of continuous values (window means), and torch's
    cumsum associates differently from XLA's, so the z-scores agree within
    Z_MAX_ULP ULPs of max(|z|, 1) and the flags are equal.  A spike in one
    device's window is flagged."""
    rng = np.random.default_rng(3)
    n, d, w = 2048, 8, 32
    dev = rng.integers(0, d, n).astype(np.int32)
    win = rng.integers(0, w, n).astype(np.int32)
    val = grid_values(rng, n) / 4
    val[(dev == 2) & (win == 20)] += 48.0
    ok = rng.random(n) < 0.95
    ref = rrun.build_window_grid(j(dev), j(win), j(val), j(ok), d, w)
    got = prun.build_window_grid(t(dev), t(win), t(val), t(ok), d, w)
    assert_fields(ref, got, "grid")
    ra, rz = rrun.detect_anomalies(ref, baseline_windows=8, z_threshold=3.0,
                                   min_baseline_count=8,
                                   std_floor=jnp.float32(0.5))
    pa, pz = prun.detect_anomalies(got, baseline_windows=8, z_threshold=3.0,
                                   min_baseline_count=8, std_floor=0.5)
    assert_bitwise(ra, pa, "anomalous")
    rz, pz = np.asarray(rz), np.asarray(pz)
    bound = Z_MAX_ULP * np.spacing(np.maximum(np.abs(rz), np.float32(1)))
    assert (np.abs(rz.astype(np.float64) - pz) <= bound).all()
    assert bool(np.asarray(pa)[2, 20])


def test_analytics_job_and_chart_series(tmp_path):
    """AnalyticsJob and build_chart_series over the port's event store,
    against the reference's functions on the same store."""
    from sitewhere_tpu.analytics.charts import build_chart_series as rchart
    from sitewhere_tpu_torch.analytics.charts import build_chart_series
    from sitewhere_tpu_torch.services.event_store import EventStore

    rng = np.random.default_rng(4)
    store = EventStore(str(tmp_path), flush_rows=256)
    store.start()
    n = 1500
    dev = rng.integers(0, 6, n)
    ts = T0 + np.sort(rng.integers(0, 40 * 3600, n))
    mt = rng.integers(0, 3, n)
    val = 50.0 + grid_values(rng, n) / 4
    val[(dev == 1) & (ts > T0 + 30 * 3600) & (ts < T0 + 31 * 3600)] += 40.0
    for i in range(n):
        store.add_event(device_id=int(dev[i]), tenant_id=0,
                        event_type=M if i % 9 else A, ts_s=int(ts[i]),
                        mtype_id=int(mt[i]), value=float(val[i]))
    store.flush()
    try:
        job_kw = dict(window_s=3600, baseline_windows=6, z_threshold=3.0,
                      min_baseline_count=6)
        ref = rrun.AnalyticsJob(**job_kw).run(store, n_devices=8, mtype_id=1)
        got = prun.AnalyticsJob(**job_kw, device=CPU).run(store, n_devices=8,
                                                          mtype_id=1)
        assert {k: v for k, v in got.items() if k != "anomalies"} == \
            {k: v for k, v in ref.items() if k != "anomalies"}
        # the anomalies are equal; z within Z_MAX_ULP (cumsum order)
        assert len(got["anomalies"]) == len(ref["anomalies"])
        for a, b in zip(ref["anomalies"], got["anomalies"]):
            assert dataclasses.astuple(dataclasses.replace(a, z_score=0.0)) \
                == dataclasses.astuple(dataclasses.replace(b, z_score=0.0))
            assert abs(a.z_score - b.z_score) <= Z_MAX_ULP * np.spacing(
                np.float32(max(abs(a.z_score), 1.0)))
        assert got["anomalies"]
        for kw in ({"device_id": 2, "mtype_ids": [0, 2]},
                   {"bucket_s": 7200, "agg": "std", "start_s": T0 + 3600,
                    "max_points_per_series": 5}):
            assert build_chart_series(store, device=CPU, **kw) == \
                rchart(store, **kw), kw
    finally:
        store.stop()
