"""The sharded pipeline of the port against the JAX package's, on the CPU.

The same numpy inputs go through the reference's mesh functions on the
conftest's 8-device virtual CPU mesh and through the port's on a mesh of
eight shards that all live on ``cpu``
(``sitewhere_tpu_torch.parallel.make_mesh(devices=["cpu"] * 8)``).
Integer and bool outputs are exact; the EWMAs within 4 ULPs of the value
scale, rates within 4 ULPs, every other float bitwise.  Covered: the
unpacked sharded step, the packed step, the K=4 chain, a mis-routed row,
the sharded rule prepare, the sharded window grid and the packed presence
sweep, and the sharded chain against the unsharded one on shard-ordered
traffic.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.analytics import runner as rrun
from sitewhere_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sitewhere_tpu.pipeline import packed as jp
from sitewhere_tpu.pipeline import sharded as js
from sitewhere_tpu.rules import compile as ref_compile
from sitewhere_tpu_torch.analytics import runner as prun
from sitewhere_tpu_torch.ops.geo import points_in_polygons
from sitewhere_tpu_torch.parallel.mesh import Sharded, gather, make_mesh
from sitewhere_tpu_torch.parallel.shmap import tree_map
from sitewhere_tpu_torch.pipeline import packed as tp
from sitewhere_tpu_torch.pipeline import sharded as ts
from sitewhere_tpu_torch.rules import compile as port_compile
from torch_parity import (
    CAP,
    WIDTH,
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
N_SHARDS = 8
ROWS = CAP // N_SHARDS          # registry rows per shard
SEG = WIDTH // N_SHARDS         # batch rows per shard
RATE_MAX_ULP = 4
# The port's step on the CPU takes the plain geofence, as every port test
GEOFENCE = points_in_polygons


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(devices=["cpu"] * N_SHARDS)


def whole(tree):
    return tree_map(gather, tree)


def assert_outputs_equal(ref_out, got_out):
    for f in ("accepted", "unregistered", "unassigned", "nonfinite",
              "device_type_id", "assignment_id", "area_id", "customer_id",
              "asset_id", "rule_id", "zone_id", "present_now"):
        np.testing.assert_array_equal(np.asarray(getattr(ref_out, f)),
                                      np_of(getattr(got_out, f)), err_msg=f)
    for f in ref_out.derived_alerts.__dataclass_fields__:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref_out.derived_alerts, f)),
            np_of(getattr(got_out.derived_alerts, f)), err_msg=f)
    for f in ref_out.metrics.__dataclass_fields__:
        np.testing.assert_array_equal(
            np.asarray(getattr(ref_out.metrics, f)),
            np_of(getattr(got_out.metrics, f)), err_msg=f)


def routed_cols(seed, ts_base=1_000):
    """make_cols rows placed so every row of a registered device sits in
    its owning shard's segment (the sharded batcher's layout); each
    segment is padded with invalid rows."""
    cols = make_cols(seed, ts_base=ts_base)
    dev = cols["device_id"]
    owned = (dev >= 0) & (dev < CAP)
    pad = int(np.nonzero(~owned)[0][0])
    rows = []
    for s in range(N_SHARDS):
        mine = list(np.nonzero(owned & (dev // ROWS == s))[0][:SEG])
        rows.append(mine + [pad] * (SEG - len(mine)))
    idx = np.concatenate(rows)
    out = {k: v[idx].copy() for k, v in cols.items()}
    out["valid"] &= owned[idx]
    return out


def test_sharded_step_matches_jax(mesh8, tmesh):
    reg, rules, zones = make_tables()
    state, cols = make_state(), make_cols(7)
    jstep = js.build_sharded_step(mesh8, donate=False)
    ref_state, ref_out = jstep(*js.place_inputs(mesh8, reg, state, rules,
                                                zones),
                               js.place_batch(mesh8, jax_batch(cols)))
    treg, trules, tzones, tstate, tbatch = torch_inputs(reg, rules, zones,
                                                        state, cols)
    step = ts.build_sharded_step(tmesh, geofence=GEOFENCE)
    new_state, out = step(*ts.place_inputs(tmesh, treg, tstate, trules,
                                           tzones),
                          ts.place_batch(tmesh, tbatch))
    assert isinstance(new_state.last_event_ts_s, Sharded)
    assert new_state.last_event_ts_s.n_shards == N_SHARDS
    assert_state_equal(ref_state, whole(new_state))
    assert_outputs_equal(ref_out, whole(out))
    assert int(ref_out.metrics.accepted) > 20
    assert int(ref_out.metrics.unregistered) > 100   # foreign rows


def test_misrouted_event_dead_letters(mesh8, tmesh):
    """A row of the last shard's device placed in shard 0's segment is
    reported unregistered by both packages (the reference's
    tests/test_sharded_pipeline.py:108 on this fixture)."""
    reg, rules, zones = make_tables()
    state = make_state()
    cols = make_cols(3)
    cols["valid"][:] = False
    cols["valid"][0] = True
    cols["device_id"][0] = CAP - 57          # registered, on shard 6
    cols["tenant_id"][0] = (CAP - 57) % 3
    cols["value"][0] = 1.0
    jstep = js.build_sharded_step(mesh8, donate=False)
    _, ref_out = jstep(*js.place_inputs(mesh8, reg, state, rules, zones),
                       js.place_batch(mesh8, jax_batch(cols)))
    step = ts.build_sharded_step(tmesh, geofence=GEOFENCE)
    treg, trules, tzones, tstate, tbatch = torch_inputs(reg, rules, zones,
                                                        state, cols)
    _, out = step(*ts.place_inputs(tmesh, treg, tstate, trules, tzones),
                  ts.place_batch(tmesh, tbatch))
    out = whole(out)
    assert bool(ref_out.unregistered[0]) and bool(out.unregistered[0])
    assert not bool(out.accepted[0])
    assert int(out.metrics.unregistered) == int(
        ref_out.metrics.unregistered) == 1


def _packed_inputs(seed_state=1):
    reg, rules, zones = make_tables()
    state = make_state(seed_state)
    treg, trules, tzones, tstate = torch_inputs(reg, rules, zones, state)
    return ((jp.pack_tables(reg, rules, zones), jp.pack_state(state)),
            (tp.pack_tables(treg, trules, tzones), tp.pack_state(tstate)))


def test_sharded_packed_step_matches_jax(mesh8, tmesh):
    (jt, jps), (tt, tps) = _packed_inputs()
    bi, bf = jp.pack_batch_host(make_cols(11), WIDTH)
    ref = js.build_sharded_packed_step(mesh8)(
        js.place_packed_tables(mesh8, jt), js.place_packed_state(mesh8, jps),
        *js.place_packed_batch(mesh8, bi, bf))
    got = ts.build_sharded_packed_step(tmesh, geofence=GEOFENCE)(
        ts.place_packed_tables(tmesh, tt), ts.place_packed_state(tmesh, tps),
        *ts.place_packed_batch(tmesh, bi, bf))
    assert got[0].si.n_shards == N_SHARDS
    got = whole(got)
    assert_packed_state_equal(ref[0], got[0])
    for a, b in zip(ref[1:], got[1:]):
        np.testing.assert_array_equal(np.asarray(a), np_of(b))


def test_sharded_packed_chain_matches_jax(mesh8, tmesh):
    k = 4
    (jt, jps), (tt, tps) = _packed_inputs()
    packs = [jp.pack_batch_host(make_cols(20 + s, ts_base=1_000 + 10 * s),
                                WIDTH) for s in range(k)]
    jslots = [js.place_packed_batch(mesh8, *p) for p in packs]
    ref = js.build_sharded_packed_chain(mesh8, k, donate=False)(
        js.place_packed_tables(mesh8, jt), js.place_packed_state(mesh8, jps),
        *[s[0] for s in jslots], *[s[1] for s in jslots])
    tslots = [ts.place_packed_batch(tmesh, *p) for p in packs]
    got = whole(ts.build_sharded_packed_chain(tmesh, k, geofence=GEOFENCE)(
        ts.place_packed_tables(tmesh, tt), ts.place_packed_state(tmesh, tps),
        *[s[0] for s in tslots], *[s[1] for s in tslots]))
    assert_packed_state_equal(ref[0], got[0])
    for a, b in zip(ref[1:], got[1:]):
        np.testing.assert_array_equal(np.asarray(a), np_of(b))


def test_sharded_chain_equals_unsharded_chain_on_routed_traffic(tmesh):
    """On shard-ordered traffic the sharded K-chain, the sharded single
    step and the unsharded chain agree bitwise: every output row, the
    metrics, the presence map and the final carry."""
    k = 4
    _, (tt, tps) = _packed_inputs()
    packs = [tp.pack_batch_host(routed_cols(30 + s, 1_000 + 10 * s), WIDTH)
             for s in range(k)]
    ref = tp.build_packed_chain(k, GEOFENCE)(
        tt, tps, *[torch.from_numpy(p[0]) for p in packs],
        *[torch.from_numpy(p[1]) for p in packs])
    mtt = ts.place_packed_tables(tmesh, tt)
    slots = [ts.place_packed_batch(tmesh, *p) for p in packs]
    chain = whole(ts.build_sharded_packed_chain(tmesh, k, GEOFENCE)(
        mtt, ts.place_packed_state(tmesh, tps),
        *[s[0] for s in slots], *[s[1] for s in slots]))
    step = ts.build_sharded_packed_step(tmesh, GEOFENCE)
    ps, ois, mets, present = ts.place_packed_state(tmesh, tps), [], [], None
    for bi, bf in slots:
        ps, oi, met, pres = step(mtt, ps, bi, bf)
        ois.append(oi.gather())
        mets.append(met.gather())
        pres = pres.gather()
        present = pres if present is None else present | pres
    single = (whole(ps), torch.stack(ois), torch.stack(mets), present)
    for got in (chain, single):
        for a, b in ((ref[0].si, got[0].si), (ref[0].sf, got[0].sf)):
            assert a.numpy().tobytes() == b.numpy().tobytes()
        for a, b in zip(ref[1:], got[1:]):
            assert a.numpy().tobytes() == b.numpy().tobytes()
    assert int(ref[2][:, 1].sum()) > 200                 # rows accepted


def test_packed_presence_sweep_matches_jax():
    (_, jps), (_, tps) = _packed_inputs(seed_state=4)
    ref_ps, ref_new = jp.packed_presence_sweep(jps, 1_000, 300)
    got_ps, got_new = tp.packed_presence_sweep(tps, 1_000, 300)
    assert_packed_state_equal(ref_ps, got_ps)
    np.testing.assert_array_equal(np.asarray(ref_new), got_new.numpy())
    assert 0 < int(got_new.sum()) < CAP


# -- the sharded rule prepare ------------------------------------------------

def _prepare_inputs(seed):
    from test_torch_rules import prepare_inputs

    trail, attrs, cols, taus = prepare_inputs(seed, B=256)
    value = cols[5].copy()
    value[:4] = (np.inf, -np.inf, -0.0, 50.0)            # no NaN from 0*inf
    return trail, attrs, cols[:5] + (value,) + cols[6:], taus


@pytest.mark.parametrize("seed", [5, 6])
def test_sharded_prepare_matches_jax_and_unsharded(seed):
    """Features summed over 4 shards equal the unsharded pass bitwise on
    every row whose device some shard owns, and the JAX mesh prepare
    within the stated bounds; each shard's trail block is the unsharded
    trail's."""
    from test_torch_rules import D, run_prepare

    n = 4
    trail, attrs, cols, taus = _prepare_inputs(seed)
    jmesh = jax_make_mesh(n)
    jfeats, jtrail = ref_compile.sharded_prepare(jmesh, D // n)(
        *(jnp.asarray(a) for a in trail + attrs + cols), jnp.asarray(taus))
    mesh = make_mesh(devices=["cpu"] * n)
    tt = tuple(torch.from_numpy(a.copy()) for a in trail)
    feats, new = port_compile.sharded_prepare(mesh, D // n)(
        *tt, *(torch.from_numpy(a) for a in attrs + cols),
        torch.from_numpy(taus))
    got = {k: v.numpy() for k, v in feats._asdict().items()}
    plain, plain_trail = run_prepare("torch", trail, attrs, cols, taus)
    ref = {k: np.asarray(v) for k, v in jfeats._asdict().items()}
    owned = (cols[0] >= 0) & (cols[0] < D)
    assert 0 < owned.sum() < owned.size
    for name in ("ewma", "rate", "rate_valid", "dev_attr", "asset_attr"):
        assert got[name][owned].tobytes() == plain[name][owned].tobytes(), \
            name
    for name in ("rate_valid", "dev_attr", "asset_attr"):
        np.testing.assert_array_equal(ref[name], got[name], err_msg=name)
    fin = owned & np.isfinite(cols[5])
    assert_ewma_close(ref["ewma"][fin], got["ewma"][fin])
    ra, rb = ref["rate"][fin].astype(np.float64), got["rate"][fin]
    assert (np.abs(ra - rb) <= RATE_MAX_ULP * np.spacing(
        np.abs(ref["rate"][fin]))).all()
    assert np.isinf(got["ewma"][:2][owned[:2]]).any() or not owned[:2].any()
    assert not np.isnan(got["ewma"][owned & ~np.isnan(plain["ewma"]).any(
        axis=1)]).any()
    for i, (t_ref, t_got) in enumerate(zip(jtrail, new)):
        t_got = np_of(gather(t_got))
        if i < 3:
            np.testing.assert_array_equal(np.asarray(t_ref), t_got)
            assert t_got.tobytes() == plain_trail[i].tobytes()
        else:
            assert_ewma_close(np.asarray(t_ref), t_got)


# -- the sharded analytics grid -----------------------------------------------

def test_window_grid_sharded_matches_jax(mesh8, tmesh):
    rng = np.random.default_rng(5)
    d, w, n = 64, 16, 5000
    dev = rng.integers(-1, d + 1, n).astype(np.int32)
    win = rng.integers(0, w, n).astype(np.int32)
    val = (rng.integers(-512, 513, n) / 32).astype(np.float32)
    ref = rrun.build_window_grid_sharded(mesh8, dev, win, val,
                                         n_devices=d, n_windows=w)
    got = prun.build_window_grid_sharded(tmesh, dev, win, val,
                                         n_devices=d, n_windows=w)
    assert got.counts.n_shards == N_SHARDS
    for f in ("counts", "means", "variances"):
        a, b = np.asarray(getattr(ref, f)), getattr(got, f).gather().numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    plain = prun.build_window_grid(
        torch.from_numpy(dev), torch.from_numpy(win), torch.from_numpy(val),
        torch.ones(n, dtype=torch.bool), d, w)
    np.testing.assert_array_equal(plain.counts.numpy(),
                                  got.counts.gather().numpy())


def test_window_sharded_flagger_matches_local(tmesh):
    """The halo-exchange flagger over 8 window shards equals the local
    detect_anomalies on values whose sums are exact in float32."""
    rng = np.random.default_rng(8)
    d, w, n = 16, 64, 6000
    dev = rng.integers(0, d, n).astype(np.int32)
    win = rng.integers(0, w, n).astype(np.int32)
    val = (rng.integers(-64, 65, n) / 8).astype(np.float32)
    val[(dev == 3) & (win == 40)] += 24.0
    grid = prun.build_window_grid(
        torch.from_numpy(dev), torch.from_numpy(win), torch.from_numpy(val),
        torch.ones(n, dtype=torch.bool), d, w)
    ra, rz = prun.detect_anomalies(grid, baseline_windows=8)
    ga, gz = prun.detect_anomalies_window_sharded(tmesh, grid,
                                                  baseline_windows=8)
    np.testing.assert_array_equal(ra.numpy(), ga.gather().numpy())
    np.testing.assert_allclose(rz.numpy(), gz.gather().numpy(), atol=1e-5)
    assert bool(ga.gather()[3, 40])
