"""Parity of the port's fused step with the JAX reference, on the CPU.

Every int and bool output, the metrics vector and every state column
must be exact; the carried EWMAs agree within ``EWMA_MAX_ULP`` ULPs of
the value scale (see ``torch_parity.assert_ewma_close``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.pipeline import packed as jpacked
from sitewhere_tpu.pipeline import step as jstep
from sitewhere_tpu_torch import convert
from sitewhere_tpu_torch.pipeline import packed as tpacked
from sitewhere_tpu_torch.pipeline import step as tstep
from torch_parity import (
    CPU,
    assert_ewma_close,
    assert_packed_state_equal,
    assert_state_equal,
    jax_batch,
    make_cols,
    make_state,
    make_tables,
    np_of,
    torch_inputs,
)

torch.set_num_threads(1)

_jax_step = jax.jit(jstep.pipeline_step)
_jax_packed_step = jax.jit(jpacked.packed_pipeline_step)

OUT_FIELDS = ("accepted", "unregistered", "unassigned", "nonfinite",
              "device_type_id", "assignment_id", "area_id", "customer_id",
              "asset_id", "rule_id", "zone_id", "present_now")


@pytest.fixture(scope="module")
def tables():
    return make_tables(seed=0)


def _run_both(tables, seed):
    registry, rules, zones = tables
    state = make_state(seed=seed + 1)
    cols = make_cols(seed=seed)
    ref_state, ref_out = _jax_step(registry, state, rules, zones,
                                   jax_batch(cols))
    t_reg, t_rules, t_zones, t_state, t_batch = torch_inputs(
        registry, rules, zones, state, cols)
    got_state, got_out = tstep.pipeline_step(
        t_reg, t_state, t_rules, t_zones, t_batch)
    return cols, (ref_state, ref_out), (got_state, got_out)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pipeline_step_parity(tables, seed):
    cols, (ref_state, ref_out), (got_state, got_out) = _run_both(tables, seed)
    for f in OUT_FIELDS:
        a, b = np_of(getattr(ref_out, f)), np_of(getattr(got_out, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ref_out.metrics.__dataclass_fields__:
        np.testing.assert_array_equal(
            np_of(getattr(ref_out.metrics, f)),
            np_of(getattr(got_out.metrics, f)), err_msg=f)
    for f in ref_out.derived_alerts.__dataclass_fields__:
        np.testing.assert_array_equal(
            np_of(getattr(ref_out.derived_alerts, f)),
            np_of(getattr(got_out.derived_alerts, f)), err_msg=f)
    assert_state_equal(ref_state, got_state)

    # the fixture reaches the cases that matter
    out = {f: np_of(getattr(got_out, f)) for f in OUT_FIELDS}
    assert out["unregistered"].any() and out["unassigned"].any()
    assert out["nonfinite"].sum() >= 5
    assert (out["rule_id"] >= 0).any() and (out["zone_id"] >= 0).any()
    assert (out["accepted"] & (cols["tenant_id"] == -1)).any()


def test_packed_step_parity(tables):
    registry, rules, zones = tables
    state = make_state(seed=4)
    cols = make_cols(seed=4)
    bi, bf = jpacked.pack_batch_host(cols, len(cols["device_id"]))
    jt = jpacked.pack_tables(registry, rules, zones)
    jps = jpacked.pack_state(state)
    ref = _jax_packed_step(jt, jps, jnp.asarray(bi), jnp.asarray(bf))

    tt = convert.packed_tables_from(jt, CPU)
    tps = convert.packed_state_from(jps, CPU)
    got = tpacked.packed_pipeline_step(
        tt, tps, torch.from_numpy(bi), torch.from_numpy(bf))
    assert_packed_state_equal(ref[0], got[0])
    for i, name in ((1, "oi"), (2, "metrics"), (3, "present")):
        a, b = np_of(ref[i]), np_of(got[i])
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got[2].shape[0] == tpacked.packed_metric_entries()

    # derived alerts rebuild from the host columns and the packed block
    ref_view = jpacked.PackedView(ref[1], ref[2], ref[3])
    view = tpacked.PackedView(got[1], got[2], got[3])
    rows = np.nonzero(view.derived_valid)[0]
    assert rows.size
    want, have = ref_view.derived_cols(cols, rows), view.derived_cols(cols, rows)
    assert want.keys() == have.keys()
    for k in want:
        np.testing.assert_array_equal(want[k], have[k], err_msg=k)
    assert view.telemetry == ref_view.telemetry
    np.testing.assert_array_equal(view.tenant_meter, ref_view.tenant_meter)


def test_pack_roundtrip_matches_reference_layout(tables):
    """pack_tables / pack_state produce the reference's buffers byte for
    byte, and unpack inverts them."""
    registry, rules, zones = tables
    state = make_state(seed=5)
    t_reg, t_rules, t_zones, t_state = torch_inputs(
        registry, rules, zones, state)
    jt = jpacked.pack_tables(registry, rules, zones)
    tt = tpacked.pack_tables(t_reg, t_rules, t_zones)
    for f in ("reg_i", "rules_i", "rules_f", "taus", "zones_i", "zones_v"):
        np.testing.assert_array_equal(np_of(getattr(jt, f)),
                                      np_of(getattr(tt, f)), err_msg=f)
    jps, tps = jpacked.pack_state(state), tpacked.pack_state(t_state)
    np.testing.assert_array_equal(np_of(jps.si), np_of(tps.si))
    np.testing.assert_array_equal(np_of(jps.sf), np_of(tps.sf))
    back = tpacked.unpack_state(tps)
    for f in state.__dataclass_fields__:
        np.testing.assert_array_equal(np_of(getattr(state, f)),
                                      np_of(getattr(back, f)), err_msg=f)
    assert tpacked.packed_metric_entries() == jpacked.packed_metric_entries()
    for name in ("REG_I", "RULE_I", "ZONE_I", "BATCH_I", "BATCH_F", "STATE_I",
                 "STATE_F", "OUT_I", "METRIC_SCALARS", "TELEMETRY_SCALARS",
                 "TENANT_METER_COUNTERS", "TENANT_METER_SLOTS", "F_ACCEPTED",
                 "F_UNREGISTERED", "F_UNASSIGNED", "F_DERIVED"):
        assert getattr(tpacked, name) == getattr(jpacked, name), name


@pytest.mark.parametrize("stage", [
    "validate_and_enrich", "eval_threshold_rules", "eval_zone_rules",
    "update_device_state", "fold_ewma"])
def test_stage_parity(tables, stage):
    registry, rules, zones = tables
    state = make_state(seed=6)
    cols = make_cols(seed=6)
    jb = jax_batch(cols)
    t_reg, t_rules, t_zones, t_state, t_batch = torch_inputs(
        registry, rules, zones, state, cols)
    accepted = jnp.asarray(cols["valid"] & (cols["device_id"] >= 0)
                           & (cols["device_id"] < 150)
                           & np.isfinite(cols["value"]))
    t_acc = torch.from_numpy(np.array(accepted))
    area = jnp.asarray(cols["device_id"] % 4, jnp.int32)
    if stage == "validate_and_enrich":
        ref = jax.jit(jstep.validate_and_enrich)(registry, jb)
        got = tstep.validate_and_enrich(t_reg, t_batch)
        ref = (*ref[:3], *(ref[3][k] for k in sorted(ref[3])))
        got = (*got[:3], *(got[3][k] for k in sorted(got[3])))
    elif stage == "eval_threshold_rules":
        ref = jax.jit(jstep.eval_threshold_rules)(rules, state, jb, accepted)
        got = tstep.eval_threshold_rules(t_rules, t_state, t_batch, t_acc)
        assert_ewma_close(ref[2], got[2])
        ref, got = ref[:2], got[:2]
        # several rules fire on one row, and the lowest index wins
        assert (np_of(got[1]) == 0).any() and (np_of(got[1]) == 1).any()
    elif stage == "eval_zone_rules":
        ref = jax.jit(jstep.eval_zone_rules)(zones, jb, accepted, area)
        got = tstep.eval_zone_rules(t_zones, t_batch, t_acc,
                                    torch.from_numpy(np.array(area)))
        assert (np_of(got[1]) == 0).any()  # zone 0 lies inside zone 1
    elif stage == "update_device_state":
        ref = jax.jit(jstep.update_device_state)(state, jb, accepted)
        got = tstep.update_device_state(t_state, t_batch, t_acc)
        assert_state_equal(ref[0], got[0])
        ref, got = ref[1:], got[1:]
    else:
        taus = jnp.asarray([2.0, 20.0, 200.0], jnp.float32)
        ref = (jax.jit(jstep.fold_ewma)(state, jb, taus),)
        got = (tstep.fold_ewma(t_state, t_batch, torch.from_numpy(
            np.array(taus))),)
        assert_ewma_close(ref[0], got[0])
        return
    for a, b in zip(ref, got):
        a, b = np_of(a), np_of(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_lowest_firing_rule_wins():
    """Every active rule fires on one row: argmax over the bool mask must
    give rule 0, and zone 2 when only zones 2 and 3 fire."""
    fired = torch.zeros((3, 5), dtype=torch.bool)
    fired[0] = True
    fired[1, 2:4] = True
    any_, first = tstep._first_firing(fired)
    assert any_.tolist() == [True, True, False]
    assert first.tolist() == [0, 2, -1]
    assert first.dtype == torch.int32


@pytest.mark.parametrize("op", range(7))
def test_compare_select_parity(op):
    rng = np.random.default_rng(op)
    val = np.round(rng.uniform(-2, 2, (64, 5)), 0).astype(np.float32)
    thr = np.round(rng.uniform(-2, 2, (1, 5)), 0).astype(np.float32)
    ref = jstep.compare_select(jnp.int32(op), jnp.asarray(val),
                               jnp.asarray(thr))
    got = tstep.compare_select(torch.tensor(op, dtype=torch.int32),
                               torch.from_numpy(val), torch.from_numpy(thr))
    np.testing.assert_array_equal(np_of(ref), np_of(got))


def test_tenant_bucket_is_floor_mod(tables):
    """NULL_ID tenants land in the last of the 16 meter buckets."""
    registry, rules, zones = tables
    t_reg, t_rules, t_zones, t_state = torch_inputs(
        registry, rules, zones, make_state(seed=7))
    cols = make_cols(seed=7)
    keep = cols["tenant_id"] == -1
    assert keep.any()
    bi, bf = tpacked.pack_batch_host(cols, len(keep))
    _, _, metrics, _ = tpacked.packed_pipeline_step(
        tpacked.pack_tables(t_reg, t_rules, t_zones),
        tpacked.pack_state(t_state), torch.from_numpy(bi),
        torch.from_numpy(bf))
    view = tpacked.PackedView(torch.zeros((10, len(keep)), dtype=torch.int32),
                              metrics, None)
    meter = view.tenant_meter
    # the rows counter of bucket 15 counts the accepted NULL_ID-tenant rows
    ref_step = _jax_step(registry, make_state(seed=7), rules, zones,
                         jax_batch(cols))
    acc = np_of(ref_step[1].accepted)
    assert meter[0, 15] == int((acc & keep).sum()) > 0


def test_schema_matches_reference():
    """Enum values, defaults, empty tables and the time helpers."""
    from sitewhere_tpu import schema as js
    from sitewhere_tpu_torch import schema as ts

    for name in ("EventType", "AssignmentStatus", "AlertLevel",
                 "ComparisonOp", "RuleKind", "ZoneCondition"):
        assert ({e.name: int(e) for e in getattr(js, name)}
                == {e.name: int(e) for e in getattr(ts, name)}), name
    assert ts.DEFAULT_EWMA_TAUS == js.DEFAULT_EWMA_TAUS
    for jcls, tcls, args in ((js.EventBatch, ts.EventBatch, (7,)),
                             (js.Registry, ts.Registry, (9,)),
                             (js.DeviceState, ts.DeviceState, (5, 3, 2)),
                             (js.RuleTable, ts.RuleTable, (4,)),
                             (js.ZoneTable, ts.ZoneTable, (3, 6))):
        ref, got = jcls.empty(*args), tcls.empty(*args, device="cpu")
        for f in ref.__dataclass_fields__:
            a, b = np_of(getattr(ref, f)), np_of(getattr(got, f))
            assert a.dtype == b.dtype, (tcls.__name__, f)
            np.testing.assert_array_equal(a, b, err_msg=f)
    rng = np.random.default_rng(0)
    a_s, b_s = (rng.integers(0, 3, 64).astype(np.int32) for _ in range(2))
    a_ns, b_ns = (rng.integers(0, 3, 64).astype(np.int32) for _ in range(2))
    ref = js.time_lt(*map(jnp.asarray, (a_s, a_ns, b_s, b_ns)))
    got = ts.time_lt(*map(torch.from_numpy, (a_s, a_ns, b_s, b_ns)))
    np.testing.assert_array_equal(np_of(ref), np_of(got))
    for n, floor, cap in ((0, 8, None), (9, 8, None), (300, 8, 256),
                          (5, 2, None)):
        assert ts.pow2_at_least(n, floor, cap) == js.pow2_at_least(n, floor, cap)
