"""The port's bring-your-own rules (``sitewhere_tpu_torch.rules``) against
the JAX package's, on the CPU.

Every test feeds the same numpy inputs, made from a seed, to both
packages (the JAX side on the CPU, un-jitted where it is a pure function)
and states its tolerance:

- integer and bool outputs exact: structure keys and canonical forms,
  the registry's operand tables (``kind``/``pint``/``pf``/``meta``/
  ``slots``/``verts``, bitwise), ``_pip_rows``, the trail's times,
  ``rate_valid``, the attribute rows, and ``fired``/``code``/``level``/
  ``pid`` of every structure key;
- EWMA features and trail EWMAs within ``EWMA_MAX_ULP`` ULPs of the value
  scale (``torch_parity``: XLA:CPU's ``exp`` differs from torch's in the
  last place);
- ``rate`` within ``RATE_MAX_ULP`` ULPs of itself: XLA:CPU may contract
  the ``dt`` sum into an FMA where the port rounds twice.

Fixtures keep float thresholds and points away from those bounds, so
fired alerts match exactly.  The non-mesh cases of ``tests/test_rules.py``
are carried over: ALERT rows never evaluated, the operand swap (no new
signature), epoch isolation, the checkpoint round trip (across the two
packages, both ways), a structure change moving a program, per-tenant
slots, a bad doc never dirtying a group, the attribute column limit, the
shape gauges, the join semantics, a swap under live traffic.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.rules import compile as ref_compile
from sitewhere_tpu.rules import dsl as ref_dsl
from sitewhere_tpu.rules.engine import RuleEngineRunner as RefEngine
from sitewhere_tpu.rules.registry import ProgramRegistry as RefRegistry
from sitewhere_tpu_torch.ops.scatter import scatter_last_by_time
from sitewhere_tpu_torch.rules import compile as port_compile
from sitewhere_tpu_torch.rules import dsl as port_dsl
from sitewhere_tpu_torch.rules.engine import RuleEngineRunner as PortEngine
from sitewhere_tpu_torch.rules.enrich import AttributeStore
from sitewhere_tpu_torch.rules.interp import (
    InterpTrail,
    interp_eval,
    interp_features,
)
from sitewhere_tpu_torch.rules.registry import ProgramRegistry as PortRegistry
from sitewhere_tpu_torch.runtime.metrics import METRIC_NAME_RE
from sitewhere_tpu_torch.schema import DEFAULT_EWMA_TAUS, EventType
from test_rules import (
    POLY,
    collect_engine_alerts,
    doc_attr,
    doc_geo,
    doc_multi,
    doc_value,
    interp_programs,
    make_batch,
)
from torch_parity import assert_ewma_close, np_of

torch.set_num_threads(1)

CPU = torch.device("cpu")
SEED = 20261016
KEYS = ("c2p4", "c2p4g", "c4p4", "c4p4g", "c4p8")
MTYPES = {"temp": 0, "hum": 1, "pres": 2, "volt": 3}
# rate: |ref - got| <= RATE_MAX_ULP ULPs of |ref|
RATE_MAX_ULP = 4


def resolve_mtype(name):
    return MTYPES[name]


# -- program docs, one family per structure key --------------------------------


def _thr(rng, lo=10.0, hi=90.0):
    # thresholds on the 0.05 grid between the fixtures' 0.1-grid values
    return float(np.round(rng.uniform(lo, hi), 1)) + 0.05


def program_doc(key, token, rng):
    """A program of structure ``key`` with constants drawn from ``rng``;
    together the families use every predicate kind and op."""
    op = str(rng.choice(["gt", "lt", "gte", "lte", "eq", "neq"]))
    level = str(rng.choice(["info", "warning", "error", "critical"]))
    alert = {"type": f"byo.{key}.{int(rng.integers(0, 3))}", "level": level}
    thr = _thr(rng)
    jx, jy = (float(v) for v in np.round(rng.uniform(-2, 2, 2), 2))
    poly = [[x + jx + 0.013, y + jy + 0.017] for x, y in POLY]
    tri = [[jx - 3.0, jy - 1.0], [jx + 4.0, jy - 2.0], [jx + 1.0, jy + 5.0]]
    if key == "c2p4":
        variant = int(rng.integers(0, 4))
        when = [
            {"pred": "value", "op": op, "value": thr},
            {"all": [{"pred": "ewma", "op": op, "value": thr,
                      "window_s": float(rng.choice([60, 600, 3600]))},
                     {"pred": "rate", "op": "gt",
                      "value": float(rng.uniform(-0.5, 0.5))}]},
            {"all": [{"pred": "value", "op": "gt", "value": thr,
                      "mtype": str(rng.choice(list(MTYPES)))},
                     {"pred": "event_type", "value": "measurement"}]},
            {"any": [{"pred": "value", "op": "lt", "value": thr - 5.0},
                     {"pred": "event_type", "op": "neq",
                      "value": "location"}]},
        ][variant]
    elif key == "c2p4g":
        when = {"pred": "geo", "polygon": poly if rng.random() < 0.5 else tri,
                "inside": bool(rng.random() < 0.5)}
    elif key == "c4p4":
        when = {"any": [
            {"pred": "value", "op": "gt", "value": thr},
            {"pred": "value", "op": "lt", "value": thr - 30.0},
            {"all": [{"pred": "rate", "op": "gt", "value": 0.01},
                     {"pred": "value", "op": "gt", "value": thr - 10.0}]}]}
    elif key == "c4p4g":
        when = {"any": [
            {"all": [{"pred": "geo", "polygon": poly, "inside": True},
                     {"pred": "value", "op": "gt", "value": thr}]},
            {"all": [{"pred": "geo", "polygon": tri, "inside": False},
                     {"pred": "event_type", "value": "location"},
                     {"pred": "attr", "table": "device", "column": "tier",
                      "op": "lte", "value": int(rng.integers(0, 4))}]},
            {"all": [{"pred": "value", "op": "lt", "value": 2.05}]}]}
    else:
        when = {"any": [
            {"all": [
                {"pred": "value", "op": "gt", "value": thr - 40.0},
                {"pred": "attr", "table": "device", "column": "tier",
                 "value": int(rng.integers(0, 4)), "op": op},
                {"pred": "event_type", "value": "measurement"},
                {"pred": "ewma", "op": "gt", "value": thr - 45.0,
                 "window_s": 600.0},
                {"pred": "rate", "op": "gt", "value": -0.5},
                {"pred": "attr", "table": "asset", "column": "grade",
                 "value": int(rng.integers(0, 3)), "op": "gte"}]},
            {"all": [{"pred": "value", "op": "lt", "value": 5.05}]},
            {"all": [{"pred": "value", "op": "gt", "value": 95.05,
                      "mtype": "hum"}]}]}
    return {"token": token, "alert": alert, "when": when}


def key_docs(key, n_tenants=6, per_tenant=3, seed=SEED):
    """``[(tenant, doc)]``: ``per_tenant`` programs of ``key`` per tenant."""
    rng = np.random.default_rng(seed + KEYS.index(key))
    return [(t, program_doc(key, f"{key}-{t}-{j}", rng))
            for t in range(n_tenants) for j in range(per_tenant)]


def world_docs(seed=SEED):
    """Programs of every structure key over 6 tenants."""
    return [d for key in KEYS for d in key_docs(key, seed=seed)]


def canonical(prog):
    """A CanonicalProgram as plain data (comparable across packages)."""
    return (prog.token, prog.name, prog.alert_type, prog.alert_level,
            tuple(tuple(dataclasses.astuple(p) for p in cl)
                  for cl in prog.clauses), prog.doc)


# -- dsl -----------------------------------------------------------------------


DSL_DOCS = ([doc_value(), doc_multi(), doc_geo(), doc_attr(),
             doc_value("lt", thr=3.0, op="lt", level="critical")]
            + [doc for _, doc in world_docs()[::4]])


@pytest.mark.parametrize("i", range(len(DSL_DOCS)))
def test_dsl_canonical_form_and_key_equal(i):
    doc = DSL_DOCS[i]
    attr = {}

    def resolve_attr(table, name):
        return attr.setdefault((table, name), len(attr))

    kw = dict(resolve_mtype=resolve_mtype, resolve_attr=resolve_attr)
    ref = ref_dsl.parse_program(doc, **kw)
    got = port_dsl.parse_program(doc, **kw)
    assert canonical(got) == canonical(ref)
    assert got.structure_key() == ref.structure_key()
    assert port_dsl.describe_program(got) == ref_dsl.describe_program(ref)


BAD_DOCS = [
    {},
    {"token": "x"},
    {"token": "x", "alert": {"type": "a"}},
    {"token": "x", "alert": {"type": "a"},
     "when": {"pred": "value", "op": "??", "value": 1}},
    {"token": "x", "alert": {"type": "a"},
     "when": {"pred": "value", "op": "gt"}},
    {"token": "x", "alert": {"type": "a"},
     "when": {"pred": "geo", "polygon": [[0, 0], [1, 1]]}},
    {"token": "x", "alert": {"type": "a", "level": "loud"},
     "when": {"pred": "value", "op": "gt", "value": 1}},
    {"token": "x", "alert": {"type": "a"},
     "when": {"any": [{"any": [{"pred": "value", "op": "gt",
                                "value": 1}]}]}},
    {"token": "x", "alert": {"type": "a"},
     "when": {"pred": "event_type", "value": "alert"}},
]


@pytest.mark.parametrize("i", range(len(BAD_DOCS)))
def test_dsl_rejects_what_the_reference_rejects(i):
    with pytest.raises(ref_dsl.RuleProgramError) as ref:
        ref_dsl.parse_program(BAD_DOCS[i])
    with pytest.raises(port_dsl.RuleProgramError) as got:
        port_dsl.parse_program(BAD_DOCS[i])
    assert str(got.value) == str(ref.value)


def test_dsl_spelling_order_and_constants_share_structure():
    a = {"token": "a", "alert": {"type": "t"},
         "when": {"all": [{"pred": "value", "op": "gt", "value": 5.0},
                          {"pred": "rate", "op": "lt", "value": 1.0}]}}
    b = {"token": "b", "alert": {"type": "t"},
         "when": {"all": [{"pred": "rate", "op": "lt", "value": 1.0},
                          {"pred": "value", "op": "gt", "value": 5.0}]}}
    pa, pb = port_dsl.parse_program(a), port_dsl.parse_program(b)
    assert pa.structure_key() == pb.structure_key()
    assert pa.clauses == pb.clauses
    keys = {port_dsl.parse_program(doc_value(thr=t, op=o)).structure_key()
            for t in (1.0, 50.0, 99.0)
            for o in ("gt", "lt", "gte", "lte", "eq", "neq")}
    assert len(keys) == 1


def test_dsl_bucketing_bound_holds():
    rng = np.random.default_rng(5)
    keys = set()
    for _ in range(200):
        clauses = []
        for _c in range(int(rng.integers(1, 5))):
            preds = [{"pred": "value", "op": "gt",
                      "value": float(rng.uniform(0, 99))}
                     for _ in range(int(rng.integers(1, 9)))]
            if rng.random() < 0.3:
                preds[0] = {"pred": "geo", "polygon": POLY}
            clauses.append({"all": preds})
        doc = {"token": "x", "alert": {"type": "t"},
               "when": {"any": clauses}}
        key = port_dsl.parse_program(doc).structure_key()
        assert key == ref_dsl.parse_program(doc).structure_key()
        keys.add(key)
    assert len(keys) <= port_dsl.MAX_STRUCTURE_KEYS == 8


# -- the registry's tables -----------------------------------------------------


def both_registries(docs, **kw):
    out = []
    for cls, dev in ((RefRegistry, {}), (PortRegistry, {"device": "cpu"})):
        attr = AttributeStore(64, 16, device="cpu")
        reg = cls(resolve_mtype=resolve_mtype, resolve_attr=attr.resolve,
                  **kw, **dev)
        for tenant, doc in docs:
            reg.put_program(tenant, doc)
        out.append(reg)
    return out


@pytest.mark.parametrize("key", KEYS)
def test_registry_tables_bitwise(key):
    ref, got = both_registries(key_docs(key))
    ea, eb = ref.publish(), got.publish()
    assert [g.key for g in ea.groups] == [g.key for g in eb.groups] == [key]
    (ga,), (gb,) = ea.groups, eb.groups
    assert ga.has_geo == gb.has_geo == key.endswith("g")
    assert ga.n_programs == gb.n_programs == 18
    assert ga.shape_sig() == gb.shape_sig()
    for name in port_compile.GroupTables._fields:
        a = np.asarray(getattr(ga.tables, name))
        b = np_of(getattr(gb.tables, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name


def test_registry_checkpoint_payload_bytes_equal():
    ref, got = both_registries(world_docs())
    ref.publish(), got.publish()
    (pa, ha), (pb, hb) = ref.snapshot_payload(), got.snapshot_payload()
    assert pa == pb and ha == hb


# -- _pip_rows and the one-hot selects -----------------------------------------


def test_pip_rows_equal(monkeypatch):
    rng = np.random.default_rng(SEED)
    from torch_parity import random_zone_verts

    verts = random_zone_verts(rng, 24, 8, span=10.0)
    idx = rng.integers(0, 24, (300, 4, 2, 3))
    vg = verts[idx]                                     # [B, S, C, P, V, 2]
    px = rng.uniform(-12, 12, 300).astype(np.float32)
    py = rng.uniform(-12, 12, 300).astype(np.float32)
    lat = (slice(None), None, None, None)
    ref = np.asarray(ref_compile._pip_rows(
        jnp.asarray(px)[lat], jnp.asarray(py)[lat], jnp.asarray(vg)))
    got = port_compile._pip_rows(torch.from_numpy(px)[lat],
                                 torch.from_numpy(py)[lat],
                                 torch.from_numpy(vg)).numpy()
    np.testing.assert_array_equal(ref, got)
    assert 0.01 < got.mean() < 0.99
    # the row-chunked lane (there for memory) gives the same rows
    zi = torch.from_numpy(idx).to(torch.int64)
    args = (torch.from_numpy(verts), zi, torch.from_numpy(px),
            torch.from_numpy(py))
    whole = port_compile._geo_hits(*args)
    # 7 rows of 24 lattice points x 8 vertices per chunk
    monkeypatch.setattr(port_compile, "GEO_LANE_BUDGET_BYTES",
                        7 * 24 * 8 * port_compile.GEO_LANE_BYTES_PER_EDGE)
    chunked = port_compile._geo_hits(*args)
    np.testing.assert_array_equal(whole.numpy(), got)
    np.testing.assert_array_equal(chunked.numpy(), got)


def _loop_select(table, idx, fill):
    """The reference's one-hot form, in torch."""
    out = torch.full(idx.shape, fill, dtype=table.dtype)
    for c in range(table.shape[1]):
        out = torch.where(idx == c, table[:, c][:, None, None, None], out)
    return out


@pytest.mark.parametrize("what", ["attr", "ewma"])
def test_gather_select_equals_one_hot_loop(what):
    rng = np.random.default_rng(SEED + 1)
    if what == "attr":
        table = rng.integers(-1, 9, (64, 8)).astype(np.int32)
        fill = port_compile.NULL_ID
    else:
        table = rng.uniform(-100, 100, (64, 3)).astype(np.float32)
        table[0, 0] = -0.0
        fill = 0.0
    idx = rng.integers(-2, table.shape[1] + 2, (64, 4, 4, 8)).astype(np.int32)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    got = port_compile._take_rows(t, i, fill).numpy()
    loop = _loop_select(t, i, fill).numpy()
    assert got.tobytes() == loop.tobytes()
    if what == "attr":
        ref = np.asarray(ref_compile._attr_col(jnp.asarray(table),
                                               jnp.asarray(idx)))
        assert got.tobytes() == ref.tobytes()


# -- the prepare pass -----------------------------------------------------------

D, M, K = 64, 4, 3


def prepare_inputs(seed=SEED, B=512):
    rng = np.random.default_rng(seed)
    trail_ts = rng.integers(0, 1_005, (D, M)).astype(np.int32)
    trail_ts[rng.random((D, M)) < 0.25] = 0             # unseeded slots
    trail = (trail_ts,
             rng.choice([0, 500_000], (D, M)).astype(np.int32),
             np.round(rng.uniform(0, 100, (D, M)), 1).astype(np.float32),
             rng.uniform(0, 100, (D, M, K)).astype(np.float32))
    dev_attr = rng.integers(-1, 4, (D, 8)).astype(np.int32)
    asset_attr = rng.integers(-1, 3, (16, 8)).astype(np.int32)
    device_id = rng.integers(-2, D + 3, B).astype(np.int32)
    device_id[:B // 4] = rng.integers(0, 6, B // 4)     # duplicates
    cols = (device_id,
            rng.integers(-2, 18, B).astype(np.int32),              # asset
            rng.integers(995, 1_003, B).astype(np.int32),          # ts_s
            rng.choice([0, 500_000, 999_999_999], B).astype(np.int32),
            rng.integers(-1, M + 2, B).astype(np.int32),           # mtype
            np.round(rng.uniform(0, 100, B), 1).astype(np.float32),
            rng.choice([0, 0, 0, 1, 2, 5], B).astype(np.int32),    # type
            rng.random(B) < 0.9)                                   # accepted
    taus = np.asarray(DEFAULT_EWMA_TAUS, np.float32)
    return trail, (dev_attr, asset_attr), cols, taus


def run_prepare(pkg, trail, attrs, cols, taus):
    if pkg == "jax":
        feats, new = ref_compile.rules_prepare_batch(
            *(jnp.asarray(a) for a in trail + attrs + cols),
            jnp.asarray(taus))
        return ({k: np.array(v) for k, v in feats._asdict().items()},
                tuple(np.array(t) for t in new))
    tt = tuple(torch.from_numpy(a.copy()) for a in trail)
    feats, new = port_compile.rules_prepare_batch(
        *tt, *(torch.from_numpy(a) for a in attrs + cols),
        torch.from_numpy(taus))
    assert all(a is b for a, b in zip(new, tt))        # updated in place
    return ({k: v.numpy() for k, v in feats._asdict().items()},
            tuple(t.numpy() for t in new))


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_prepare_batch_equal(seed):
    args = prepare_inputs(seed)
    (fa, ta), (fb, tb) = run_prepare("jax", *args), run_prepare("torch", *args)
    for name in ("rate_valid", "dev_attr", "asset_attr"):
        assert fa[name].dtype == fb[name].dtype, name
        np.testing.assert_array_equal(fa[name], fb[name], err_msg=name)
    assert_ewma_close(fa["ewma"], fb["ewma"])
    ra, rb = fa["rate"].astype(np.float64), fb["rate"].astype(np.float64)
    bound = RATE_MAX_ULP * np.spacing(np.abs(fa["rate"]))
    assert (np.abs(ra - rb) <= bound).all()
    assert fb["rate_valid"].sum() > 20 and (fb["rate"] != 0).sum() > 20
    for i in range(3):                                   # trail ts, ns, v
        np.testing.assert_array_equal(ta[i], tb[i], err_msg=str(i))
    assert_ewma_close(ta[3], tb[3])
    assert (tb[0] != args[0][0]).sum() > 10              # the trail moved


def test_prepare_in_place_equals_scatter_last_by_time():
    """The in-place trail write is the functional scatter's result."""
    trail, attrs, cols, taus = prepare_inputs(SEED + 2)
    feats, new = run_prepare("torch", trail, attrs, cols, taus)
    device_id, _, ts_s, ts_ns, mtype, value, etype, acc = (
        torch.from_numpy(c) for c in cols)
    slot = torch.where(mtype >= 0, mtype % M, 0)
    flat = device_id.clamp(0, D - 1) * M + slot
    keep = acc & (etype == 0) & (device_id >= 0) & (device_id < D)
    s, ns, (v, e) = scatter_last_by_time(
        torch.from_numpy(trail[0]).reshape(-1),
        torch.from_numpy(trail[1]).reshape(-1),
        (torch.from_numpy(trail[2]).reshape(-1),
         torch.from_numpy(trail[3]).reshape(-1, K)),
        flat, ts_s, ts_ns, (value, torch.from_numpy(feats["ewma"])), keep)
    for got, want in zip(new, (s, ns, v, e)):
        assert got.reshape(-1).tobytes() == want.numpy().reshape(-1).tobytes()


# -- the group-eval pass, each structure key ----------------------------------


def eval_inputs(seed, B=384, n_tenants=6):
    rng = np.random.default_rng(seed)
    args = prepare_inputs(seed, B)
    feats, _ = run_prepare("jax", *args)
    cols = args[2]
    value = cols[5].copy()
    value[rng.random(B) < 0.05] = 2.0                   # the low clauses
    batch = dict(
        tenant_id=rng.integers(-1, n_tenants + 2, B).astype(np.int32),
        event_type=np.where(rng.random(B) < 0.45, 1, cols[6]).astype(np.int32),
        mtype_id=cols[4], value=value,
        lon=np.round(rng.uniform(-6, 16, B), 3).astype(np.float32) + 0.0007,
        lat=np.round(rng.uniform(-6, 16, B), 3).astype(np.float32) + 0.0003,
        accepted=cols[7])
    return feats, batch


EVAL_COLS = ("tenant_id", "event_type", "mtype_id", "value", "lon", "lat",
             "accepted")


@pytest.mark.parametrize("key", KEYS)
def test_group_eval_equal(key, monkeypatch):
    ref, got = both_registries(key_docs(key))
    (ga,), (gb,) = ref.publish().groups, got.publish().groups
    feats, batch = eval_inputs(SEED + 10 + KEYS.index(key))
    out_a = ref_compile.rules_group_eval(
        ga.tables, ref_compile.BatchFeatures(
            **{k: jnp.asarray(v) for k, v in feats.items()}),
        *(jnp.asarray(batch[c]) for c in EVAL_COLS), has_geo=ga.has_geo)
    out_b = gb.eval_fn(
        gb.tables, port_compile.BatchFeatures(
            **{k: torch.from_numpy(v) for k, v in feats.items()}),
        *(torch.from_numpy(batch[c]) for c in EVAL_COLS), has_geo=gb.has_geo)
    for name, a, b in zip(("fired", "code", "level", "pid"), out_a, out_b):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    fired = out_b[0].numpy()
    assert 0 < fired.sum() < fired.size
    if gb.has_geo:
        # the same outputs with the geo lane one row per chunk
        monkeypatch.setattr(port_compile, "GEO_LANE_BUDGET_BYTES", 1)
        chunked = port_compile.rules_group_eval(
            gb.tables, port_compile.BatchFeatures(
                **{k: torch.from_numpy(v) for k, v in feats.items()}),
            *(torch.from_numpy(batch[c]) for c in EVAL_COLS), has_geo=True)
        for a, b in zip(out_b, chunked):
            assert torch.equal(a, b)


# -- the engine ----------------------------------------------------------------


def make_engines(docs, attrs=True, capacity=64, **kw):
    out = []
    for cls, dev in ((RefEngine, {}), (PortEngine, {"device": "cpu"})):
        eng = cls(capacity=capacity, n_mtype_slots=M, asset_capacity=16,
                  queue_depth=4, resolve_mtype=resolve_mtype, **kw, **dev)
        for tenant, doc in docs:
            eng.registry.put_program(tenant, doc)
        if attrs:
            eng.attributes.set_many("device", np.arange(capacity), "tier",
                                    np.arange(capacity) % 4)
            eng.attributes.set("device", 9, "tier", -1)    # unset
            eng.attributes.set_many("asset", np.arange(16), "grade",
                                    np.arange(16) % 3)
        eng.refresh()
        out.append(eng)
    return out


def stream(seed, n=5, B=96, n_devices=64, n_tenants=8):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        b = make_batch(rng, B, n_devices, n_tenants, t0=1000 + 600 * i)
        b["value"] = (np.round(b["value"], 1) + 0.02).astype(np.float32)
        b["mtype_id"] = rng.integers(-1, 5, B).astype(np.int32)
        out.append(b)
    return out


def port_interp_alerts(eng, batches):
    trail = InterpTrail(eng.capacity, eng.n_mtype_slots,
                        len(DEFAULT_EWMA_TAUS))
    _, arrays = eng.attributes.snapshot_payload()
    progs = interp_programs(eng.registry)
    out = []
    for batch in batches:
        feats = interp_features(trail, batch, DEFAULT_EWMA_TAUS,
                                arrays["device"], arrays["asset"])
        for row, _tok, code, lvl in interp_eval(progs, batch, feats):
            out.append((int(batch["device_id"][row]),
                        int(batch["ts_s"][row]), code, lvl))
    return sorted(out)


def test_engine_stream_equals_reference_and_interp():
    ref, got = make_engines(world_docs())
    fa, fb = collect_engine_alerts(ref), collect_engine_alerts(got)
    batches = stream(SEED + 20)
    for b in batches:
        ref._eval_batch(dict(b))
        got._eval_batch(dict(b))
    assert sorted(fb) == sorted(fa)
    assert sorted(fb) == port_interp_alerts(got, batches)
    assert len(fb) > 20
    assert int(got.metrics.counter("rules.alerts").value) == len(fb)
    for t_ref, t_got in zip(ref._trail[:3], got._trail[:3]):
        np.testing.assert_array_equal(np.asarray(t_ref), t_got.numpy())
    assert_ewma_close(np.asarray(ref._trail[3]), got._trail[3])


def test_engine_matches_interp_on_reference_programs():
    """tests/test_rules.py's golden-equivalence engine, on the port."""
    eng = PortEngine(capacity=64, n_mtype_slots=4, asset_capacity=16,
                     queue_depth=4, device="cpu")
    eng.registry.put_program(1, doc_value(thr=40.0))
    eng.registry.put_program(1, doc_multi())
    eng.registry.put_program(2, doc_geo())
    eng.registry.put_program(3, doc_geo("r-out", inside=False))
    eng.registry.put_program(3, doc_attr())
    eng.registry.put_program(5, doc_value("r-low", thr=20.0, op="lt",
                                          level="info"))
    eng.attributes.set("device", 7, "tier", 2)
    eng.attributes.set("device", 9, "tier", 1)
    eng.attributes.set("asset", 3, "grade", 4)
    eng.refresh()
    fired = collect_engine_alerts(eng)
    rng = np.random.default_rng(42)
    batches = [make_batch(rng, 96, 64, 8, t0=1000 + 600 * i)
               for i in range(5)]
    for b in batches:
        eng._eval_batch(dict(b))
    assert sorted(fired) == port_interp_alerts(eng, batches)
    assert len(fired) > 0


def test_alert_rows_are_never_evaluated():
    _, eng = make_engines(world_docs())
    fired = collect_engine_alerts(eng)
    batch = stream(SEED + 21, n=1)[0]
    batch["event_type"][:] = int(EventType.ALERT)
    eng._eval_batch(dict(batch))
    assert fired == []


def test_enrichment_join_semantics():
    """Attr predicates join the published tables; unset (NULL_ID)
    attributes never match."""
    eng = PortEngine(capacity=16, n_mtype_slots=2, asset_capacity=8,
                     queue_depth=4, device="cpu")
    eng.registry.put_program(0, doc_attr(tier=2))
    eng.attributes.set("device", 3, "tier", 2)
    eng.attributes.set("device", 4, "tier", 1)
    eng.refresh()
    fired = collect_engine_alerts(eng)
    n = 3
    eng._eval_batch({
        "device_id": np.asarray([3, 4, 5], np.int32),
        "tenant_id": np.zeros(n, np.int32),
        "event_type": np.zeros(n, np.int32),
        "mtype_id": np.zeros(n, np.int32),
        "value": np.full(n, 50.0, np.float32),
        "lon": np.zeros(n, np.float32), "lat": np.zeros(n, np.float32),
        "ts_s": np.full(n, 10, np.int32), "ts_ns": np.zeros(n, np.int32),
        "asset_id": np.full(n, -1, np.int32)})
    assert [f[0] for f in fired] == [3]


def swap_engine(n_tenants=8):
    eng = PortEngine(capacity=32, n_mtype_slots=2, queue_depth=8,
                     device="cpu")
    for t in range(n_tenants):
        eng.registry.put_program(t, doc_value(f"r{t}", thr=30.0 + t))
    eng.refresh()
    return eng


def test_operand_swap_adds_no_signature():
    port_compile.reset_trace_cache()
    eng = swap_engine()
    batch = make_batch(np.random.default_rng(1), 64, 32, 8)
    eng._eval_batch(dict(batch))
    before = port_compile.compile_count()
    for i in range(5):
        eng.put_program(3, doc_value("r3", thr=10.0 + i, op="lt"))
        eng._eval_batch(dict(batch))
    assert port_compile.compile_count() == before > 0
    assert eng.registry.swaps >= 5
    # a new structure is a new signature
    eng.put_program(3, doc_geo("r-geo"))
    assert port_compile.compile_count() > before


def test_swap_under_live_traffic():
    eng = swap_engine()
    eng.start()
    try:
        fired = collect_engine_alerts(eng)
        cols = make_batch(np.random.default_rng(2), 64, 32, 8)
        mask = np.ones(64, bool)
        eng.submit_live(cols, mask)
        eng.drain()
        before = port_compile.compile_count()
        for i in range(6):
            if i == 3:
                eng.put_program(2, doc_value("r2", thr=5.0))
            eng.submit_live(cols, mask)
            eng.drain()
        assert port_compile.compile_count() == before
        assert int(eng.metrics.counter("rules.live_batches").value) == 7
        assert len(fired) > 0
    finally:
        eng.stop()


def test_epoch_isolation():
    eng = swap_engine()
    epoch_a = eng.registry.current_epoch()
    eng.put_program(0, doc_value("r0", thr=99.0))
    epoch_b = eng.registry.current_epoch()
    assert epoch_b.epoch > epoch_a.epoch
    (g_a,), (g_b,) = epoch_a.groups, epoch_b.groups
    # the old epoch's tables are untouched: a batch holding it still
    # evaluates the old threshold
    assert float(g_a.tables.pf.max()) != float(g_b.tables.pf.max())
    assert g_a.shape_sig() == g_b.shape_sig()
    assert g_a.eval_fn is g_b.eval_fn


@pytest.mark.parametrize("direction", ["jax->torch", "torch->jax"])
def test_checkpoint_round_trip_across_packages(direction):
    src_pkg = direction.split("->")[0]
    ref, got = make_engines(world_docs())
    src = ref if src_pkg == "jax" else got
    src.attributes.set("device", 3, "tier", 7)
    src.refresh()
    payload, header = src.snapshot_state()
    if src_pkg == "jax":
        dst = PortEngine(capacity=64, n_mtype_slots=M, asset_capacity=16,
                         queue_depth=4, resolve_mtype=resolve_mtype,
                         device="cpu")
    else:
        dst = RefEngine(capacity=64, n_mtype_slots=M, asset_capacity=16,
                        queue_depth=4, resolve_mtype=resolve_mtype)
    assert dst.restore_state(header, payload) == src.registry.program_count()
    assert dst.registry.structure_keys() == src.registry.structure_keys() \
        == sorted(KEYS)
    assert dst.attributes.columns("device") == src.attributes.columns(
        "device") == {"tier": 0}
    _, arrays = dst.attributes.snapshot_payload()
    assert arrays["device"][3, 0] == 7
    assert dst.registry.snapshot_payload() == src.registry.snapshot_payload()
    # the restored engine fires as the source does (both from a fresh
    # trail, the checkpoint's contract)
    src._trail = src._fresh_trail()
    f1, f2 = collect_engine_alerts(src), collect_engine_alerts(dst)
    for b in stream(SEED + 22, n=2):
        src._eval_batch(dict(b))
        dst._eval_batch(dict(b))
    assert sorted(f1) == sorted(f2) and len(f1) > 0


def test_structure_change_moves_program_between_groups():
    reg = PortRegistry(device="cpu")
    reg.put_program(0, doc_value("r0"))
    assert reg.structure_keys() == ["c2p4"]
    reg.put_program(0, doc_geo("r0"))
    assert reg.structure_keys() == ["c2p4g"]
    assert reg.program_count() == 1


def test_per_tenant_structure_slots_enforced():
    reg = PortRegistry(programs_per_tenant=2, device="cpu")
    reg.put_program(0, doc_value("a"))
    reg.put_program(0, doc_value("b"))
    with pytest.raises(port_dsl.RuleProgramError):
        reg.put_program(0, doc_value("c"))
    reg.put_program(0, doc_value("b", thr=99.0))    # in place: allowed


def test_bad_doc_never_dirties_a_group():
    reg = PortRegistry(device="cpu")
    reg.put_program(0, doc_value("a"))
    reg.publish()
    with pytest.raises(port_dsl.RuleProgramError):
        reg.put_program(0, {"token": "b", "alert": {"type": "t"},
                            "when": {"pred": "value", "op": "gt"}})
    assert reg.publish().epoch == 1


def test_attribute_store_column_limit_and_publish():
    store = AttributeStore(16, 8, max_columns=2, device="cpu")
    store.resolve("device", "a")
    store.resolve("device", "b")
    with pytest.raises(port_dsl.RuleProgramError):
        store.resolve("device", "c")
    e1 = store.publish()
    assert store.publish() is e1                    # nothing changed
    store.set("asset", 2, "grade", 5)
    e2 = store.publish()
    # only the changed table is uploaded; the epoch never aliases the host
    assert e2.device is e1.device and e2.asset is not e1.asset
    store.set("asset", 2, "grade", 6)
    assert int(e2.asset[2, 0]) == 5


def test_rules_metric_family_and_shape_gauges():
    ref = RefEngine(capacity=16, queue_depth=2)
    eng = PortEngine(capacity=16, queue_depth=2, device="cpu")
    assert eng.metrics.names() == ref.metrics.names()
    assert all(METRIC_NAME_RE.match(n) for n in eng.metrics.names())
    eng.registry.put_program(0, doc_value())
    eng.refresh()
    assert eng.metrics.gauge("rules.programs").value == 1
    assert eng.metrics.gauge("rules.groups").value == 1
    assert eng.metrics.gauge("rules.compiled_shapes").value >= 1
    assert eng.metrics.counter("rules.swaps").value >= 1
    stats = eng.stats()
    assert stats["programs"] == 1 and stats["structures"] == ["c2p4"]
    assert json.dumps(stats)


def test_engine_under_concurrent_submit_swap_and_snapshot():
    """Several submitters, a swapping thread and a snapshotting thread
    against one worker, with a short switch interval: every batch offered
    is either evaluated or counted as dropped, and nothing fails."""
    import sys
    import threading

    eng = swap_engine()
    eng.start()
    errors = []
    offered = [0]
    lock = threading.Lock()
    cols = make_batch(np.random.default_rng(3), 32, 32, 8)
    mask = np.ones(32, bool)

    def submitter():
        for _ in range(20):
            eng.submit_live(cols, mask)
            with lock:
                offered[0] += 1

    def swapper():
        try:
            for i in range(10):
                eng.put_program(i % 8, doc_value(f"r{i % 8}", thr=20.0 + i))
        except Exception as e:               # noqa: BLE001 (reported)
            errors.append(e)

    def snapshotter():
        try:
            for _ in range(5):
                eng.snapshot_state()
        except Exception as e:               # noqa: BLE001 (reported)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = ([threading.Thread(target=submitter) for _ in range(6)]
                   + [threading.Thread(target=swapper),
                      threading.Thread(target=snapshotter)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        eng.drain(timeout_s=60)
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    assert errors == []
    done = (eng.metrics.counter("rules.live_batches").value
            + eng.metrics.counter("rules.live_dropped").value)
    assert done == offered[0] == 120
    assert eng.registry.program_count() == 8
