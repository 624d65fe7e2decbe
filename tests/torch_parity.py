"""Shared fixtures for the parity tests of the PyTorch port.

One numpy fixture feeds both packages: the JAX reference gets ``jnp``
arrays, the port gets tensors on the CPU through
``sitewhere_tpu_torch.convert``.  The fixtures are small (D=256, B=512,
R=8, Z=8, V=8, M=4, K=3) and hit the cases where the two could part:
duplicate device rows with equal ``(ts_s, ts_ns)``, unregistered,
unassigned and tenant-mismatch rows, ``NULL_ID`` tenants, NaN/Inf rows,
rate rules with dt == 0, and several rules or zones firing on one row.
The wire-path section composes one deployment in each package for the
dispatcher, ingest and registry tests.
"""

from __future__ import annotations

import functools
import json

import jax.numpy as jnp
import numpy as np
import torch

from sitewhere_tpu.ops.geo import pad_polygon
from sitewhere_tpu.schema import (
    AssignmentStatus,
    ComparisonOp,
    DeviceState,
    EventBatch,
    Registry,
    RuleKind,
    RuleTable,
    ZoneCondition,
    ZoneTable,
)
from sitewhere_tpu_torch import convert

CAP, N_ACTIVE, N_TENANTS = 256, 200, 3
M, K = 4, 3
WIDTH = 512
N_RULES, N_ZONES, V = 8, 8, 8
# EWMA values go through exp(), whose XLA:CPU and torch results differ by
# up to one unit in the last place (ULP), then through 1 - exp(-dt/tau),
# which cancels, and a multiply-add that XLA:CPU contracts into an FMA.
# The error is therefore bounded in ULPs of the fixture's value scale
# (|value| < EWMA_SCALE), not of the result, which may be near zero.
EWMA_MAX_ULP = 4
EWMA_SCALE = np.float32(128.0)

CPU = torch.device("cpu")


def convex_polygon(rng, n, center, radius) -> np.ndarray:
    angles = np.sort(rng.uniform(0, 2 * np.pi, n))
    return np.stack([center[0] + radius * np.cos(angles),
                     center[1] + radius * np.sin(angles)],
                    axis=1).astype(np.float32)


def random_zone_verts(rng, z, v, span=50.0) -> np.ndarray:
    """``z`` random convex polygons of 3..v vertices, padded to ``v``."""
    polys = []
    for _ in range(z):
        n = int(rng.integers(3, v + 1))
        polys.append(pad_polygon(convex_polygon(
            rng, n, rng.uniform(-span, span, 2), rng.uniform(1, span / 2.5)),
            v))
    return np.stack(polys)


def make_tables(seed: int = 0):
    """JAX ``(Registry, RuleTable, ZoneTable)``."""
    rng = np.random.default_rng(seed)
    idx = np.arange(CAP)
    on = idx < N_ACTIVE
    tenant = np.where(on, idx % N_TENANTS, -1).astype(np.int32)
    tenant[10:20] = -1          # active devices owned by the NULL_ID tenant
    status = np.where(idx < N_ACTIVE - 20, int(AssignmentStatus.ACTIVE),
                      int(AssignmentStatus.MISSING)).astype(np.int32)
    registry = Registry(
        active=jnp.asarray(on),
        tenant_id=jnp.asarray(tenant),
        device_type_id=jnp.asarray(np.where(on, idx % 3, -1), jnp.int32),
        assignment_id=jnp.asarray(np.where(on, idx, -1), jnp.int32),
        assignment_status=jnp.asarray(status),
        area_id=jnp.asarray(np.where(on, idx % 4, -1), jnp.int32),
        customer_id=jnp.asarray(np.where(on, 2, -1), jnp.int32),
        asset_id=jnp.asarray(np.where(on, idx % 7, -1), jnp.int32),
        epoch=jnp.int32(3),
    )

    # rule r: (active, tenant, mtype, op, threshold, kind, window)
    spec = [
        (1, -1, -1, ComparisonOp.GT, 20.0, RuleKind.INSTANT, 0),
        (1, -1, 0, ComparisonOp.GT, 10.0, RuleKind.INSTANT, 0),
        (1, 1, -1, ComparisonOp.LT, 30.0, RuleKind.WINDOW_MEAN, 1),
        (1, -1, 1, ComparisonOp.GTE, 0.5, RuleKind.RATE_PER_S, 0),
        (1, -1, -1, ComparisonOp.EQ, 50.0, RuleKind.INSTANT, 0),
        (1, 0, 2, ComparisonOp.LTE, -0.5, RuleKind.RATE_PER_S, 2),
        (1, -1, -1, ComparisonOp.NEQ, 77.25, RuleKind.WINDOW_MEAN, 2),
        (0, -1, -1, ComparisonOp.GT, 0.0, RuleKind.INSTANT, 0),
    ]
    col = lambda i, dt: jnp.asarray(  # noqa: E731
        np.array([s[i] for s in spec]), dt)
    rules = RuleTable(
        active=col(0, jnp.bool_),
        tenant_id=col(1, jnp.int32),
        mtype_id=col(2, jnp.int32),
        op=col(3, jnp.int32),
        threshold=col(4, jnp.float32),
        alert_code=jnp.arange(100, 100 + N_RULES, dtype=jnp.int32),
        alert_level=jnp.asarray(np.arange(N_RULES) % 4, jnp.int32),
        kind=col(5, jnp.int32),
        window_idx=col(6, jnp.int32),
        ewma_tau_s=jnp.asarray([2.0, 20.0, 200.0], jnp.float32),
    )

    verts = random_zone_verts(rng, N_ZONES, V, span=20.0)
    verts[0] = pad_polygon([[0, 0], [10, 0], [10, 10], [0, 10]], V)
    verts[1] = pad_polygon([[-5, -5], [12, -5], [12, 12], [-5, 12]], V)
    verts[N_ZONES - 1] = 0.0    # an empty (all-zero) slot
    zones = ZoneTable(
        active=jnp.asarray(np.arange(N_ZONES) < N_ZONES - 1),
        tenant_id=jnp.asarray([-1, -1, 1, -1, 0, -1, 2, -1], jnp.int32),
        area_id=jnp.asarray([-1, -1, -1, 2, -1, 1, -1, -1], jnp.int32),
        verts=jnp.asarray(verts),
        nvert=jnp.full(N_ZONES, V, jnp.int32),
        condition=jnp.asarray(
            [int(ZoneCondition.ALERT_IF_INSIDE)] * 5
            + [int(ZoneCondition.ALERT_IF_OUTSIDE)] * 3, jnp.int32),
        alert_code=jnp.arange(200, 200 + N_ZONES, dtype=jnp.int32),
        alert_level=jnp.asarray(np.arange(N_ZONES) % 4, jnp.int32),
    )
    return registry, rules, zones


def make_state(seed: int = 1):
    """JAX DeviceState, seeded so rate rules see dt == 0 and dt < 0 rows."""
    rng = np.random.default_rng(seed)
    s = DeviceState.empty(CAP, M, K)
    ts = rng.integers(0, 1_005, (CAP, M)).astype(np.int32)
    ts[rng.random((CAP, M)) < 0.2] = 0      # unseeded slots
    return s.replace(
        last_event_ts_s=jnp.asarray(rng.integers(0, 1_005, CAP), jnp.int32),
        last_event_type=jnp.asarray(rng.integers(-1, 3, CAP), jnp.int32),
        last_values=jnp.asarray(rng.uniform(0, 50, (CAP, M)), jnp.float32),
        last_value_ts_s=jnp.asarray(ts),
        last_value_ts_ns=jnp.asarray(
            rng.choice([0, 500], (CAP, M)), jnp.int32),
        ewma_values=jnp.asarray(rng.uniform(0, 50, (CAP, M, K)), jnp.float32),
        presence_missing=jnp.asarray(rng.random(CAP) < 0.2),
        nonfinite_count=jnp.asarray(rng.integers(0, 3, CAP), jnp.int32),
    )


def make_cols(seed: int = 0, width: int = WIDTH, ts_base: int = 1_000):
    """Host event columns (numpy), as the batcher would decode them."""
    rng = np.random.default_rng(seed)
    device_id = rng.integers(-2, CAP + 10, width).astype(np.int32)
    device_id[: width // 4] = rng.integers(0, 8, width // 4)  # duplicates
    registry_tenant = np.where(device_id < N_ACTIVE, device_id % N_TENANTS,
                               -1)
    registry_tenant[(device_id >= 10) & (device_id < 20)] = -1
    tenant = np.where(rng.random(width) < 0.05,           # tenant mismatch
                      (registry_tenant + 1) % N_TENANTS,
                      registry_tenant).astype(np.int32)
    value = np.round(rng.uniform(0, 100, width), 1).astype(np.float32)
    value[rng.random(width) < 0.03] = 50.0                # EQ rule hits
    lat = rng.uniform(-20, 20, width).astype(np.float32)
    lon = rng.uniform(-20, 20, width).astype(np.float32)
    cols = dict(
        valid=rng.random(width) < 0.9,
        device_id=device_id,
        tenant_id=tenant,
        event_type=rng.choice([0, 0, 0, 1, 1, 2, 3, 5], width).astype(np.int32),
        # few distinct keys: equal (ts_s, ts_ns) on one device is common
        ts_s=rng.integers(ts_base, ts_base + 6, width).astype(np.int32),
        ts_ns=rng.choice([0, 500], width).astype(np.int32),
        mtype_id=rng.integers(-1, M + 2, width).astype(np.int32),
        value=value,
        lat=lat,
        lon=lon,
        elevation=rng.uniform(0, 10, width).astype(np.float32),
        alert_code=np.where(rng.random(width) < 0.3, 3, -1).astype(np.int32),
        alert_level=rng.integers(0, 3, width).astype(np.int32),
        command_id=np.full(width, -1, np.int32),
        payload_ref=np.arange(width, dtype=np.int32),
        update_state=rng.random(width) < 0.95,
    )
    registered = (cols["valid"] & (device_id >= 0) & (device_id < N_ACTIVE))
    bad = np.flatnonzero(registered)[:8]
    cols["value"][bad[0]] = np.nan
    cols["value"][bad[1]] = np.inf
    cols["lat"][bad[2]] = np.nan
    cols["lon"][bad[3]] = -np.inf
    cols["elevation"][bad[4]] = np.nan
    return cols


def jax_batch(cols) -> EventBatch:
    return EventBatch(**{k: jnp.asarray(v) for k, v in cols.items()})


def torch_inputs(registry, rules, zones, state, cols=None):
    """The port's counterparts of the JAX fixtures, on the CPU."""
    out = (convert.registry_from(registry, CPU),
           convert.rule_table_from(rules, CPU),
           convert.zone_table_from(zones, CPU),
           convert.device_state_from(state, CPU))
    if cols is not None:
        out += (convert.event_batch_from(jax_batch(cols), CPU),)
    return out


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_state_equal(ref, got) -> None:
    """Every DeviceState column exact, except the EWMAs (ULP bound)."""
    for f in ref.__dataclass_fields__:
        a, b = np_of(getattr(ref, f)), np_of(getattr(got, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if f == "ewma_values":
            assert_ewma_close(a, b)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def assert_packed_state_equal(ref_ps, got_ps) -> None:
    """A packed carry: the int plane exact; the float plane exact except
    its EWMA rows (ULP bound)."""
    np.testing.assert_array_equal(np_of(ref_ps.si), np_of(got_ps.si))
    a, b = np_of(ref_ps.sf), np_of(got_ps.sf)
    n_exact = 3 + ref_ps.num_mtype_slots
    np.testing.assert_array_equal(a[:n_exact], b[:n_exact])
    assert_ewma_close(a[n_exact:], b[n_exact:])


def assert_ewma_close(ref, got) -> None:
    """``|ref - got| <= EWMA_MAX_ULP`` ULPs of ``max(|ref|, EWMA_SCALE)``;
    NaN and Inf entries (candidates of poison rows) must match exactly."""
    ref, got = np_of(ref), np_of(got)
    assert ref.dtype == got.dtype == np.float32
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(ref[~fin], got[~fin])
    ref, got = ref[fin], got[fin]
    bound = EWMA_MAX_ULP * np.spacing(np.maximum(np.abs(ref), EWMA_SCALE))
    err = np.abs(ref.astype(np.float64) - got.astype(np.float64))
    assert (err <= bound).all(), (
        f"EWMA off by {float((err / bound).max()) * EWMA_MAX_ULP:.2f} "
        f"ULP of the value scale")


# -- the wire path: one deployment composed in both packages ----------------
#
# Width 64, registry capacity 128 (100 registered devices, every 10th in a
# second tenant, every 13th unassigned), 4 measurement slots, 3 rules of
# each kind (instant, EWMA window, rate), 4 zones.  Names, tenants and
# alert types are minted up front in one order, so both packages hold the
# same handles whichever lane decodes a payload.

WIRE_WIDTH, WIRE_CAP, WIRE_M, WIRE_DEVICES = 64, 128, 4, 100
WIRE_MTYPES = ("temp", "hum", "pres", "volt")
WIRE_ALERTS = ("overheat", "door", "tamper")
WIRE_TS0_MS = 1_700_000_000_000


class FakeClock:
    """The batchers' clock: time moves only when a test says so."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class RecordingStore:
    """Event store stand-in: keeps each append's egress columns and mask
    as numpy copies, and counts flushes."""

    def __init__(self):
        self.appends = []
        self.flushes = 0

    def append_columns(self, cols, mask=None):
        self.appends.append(({n: np.array(cols[n]) for n in cols},
                             np.array(mask)))

    def flush(self):
        self.flushes += 1


def _wire_rules(mgr, enums) -> None:
    op, kind = enums.ComparisonOp, enums.RuleKind
    spec = [
        ("temp", op.GT, 80.0, kind.INSTANT, None, None),
        (None, op.LT, 2.0, kind.INSTANT, None, "default"),
        ("hum", op.GTE, 90.0, kind.INSTANT, None, None),
        ("temp", op.GT, 60.0, kind.WINDOW_MEAN, 60.0, None),
        ("pres", op.LT, 20.0, kind.WINDOW_MEAN, 700.0, None),
        ("volt", op.NEQ, 50.0, kind.WINDOW_MEAN, 3000.0, "acme"),
        ("temp", op.GT, 5.0, kind.RATE_PER_S, None, None),
        ("hum", op.LT, -5.0, kind.RATE_PER_S, None, None),
        ("volt", op.GT, 1.0, kind.RATE_PER_S, None, "default"),
    ]
    for i, (mtype, o, thr, k, window, tenant) in enumerate(spec):
        mgr.create_rule(mtype, o, thr, WIRE_ALERTS[i % 3],
                        alert_level=i % 4, tenant=tenant, token=f"rule-{i}",
                        kind=k, window_s=window)


def wire_world(pkg: str, journal_root, ring_depth: int,
               emit_packed: bool = True, group: str = "pipeline",
               **dispatcher_kw):
    """The deployment in package ``pkg`` ("jax" or "torch"): a bare
    dispatcher over the real RegistryMirror, RuleManager,
    DeviceStateManager and Batcher, a Journal under ``journal_root``
    read by consumer ``group``, and a RecordingStore.  Returns a
    namespace of its parts."""
    import types

    if pkg == "jax":
        from sitewhere_tpu import schema as enums
        from sitewhere_tpu.ids import IdentityMap
        from sitewhere_tpu.ingest.batcher import Batcher
        from sitewhere_tpu.ingest.journal import Journal, JournalReader
        from sitewhere_tpu.pipeline.rules import RuleManager
        from sitewhere_tpu.runtime.dispatcher import PipelineDispatcher
        from sitewhere_tpu.services.device_management import RegistryMirror
        from sitewhere_tpu.state.manager import DeviceStateManager
        dev = {}
    else:
        from sitewhere_tpu_torch import schema as enums
        from sitewhere_tpu_torch.ids import IdentityMap
        from sitewhere_tpu_torch.ingest.batcher import Batcher
        from sitewhere_tpu_torch.ingest.journal import Journal, JournalReader
        from sitewhere_tpu_torch.pipeline.rules import RuleManager
        from sitewhere_tpu_torch.runtime.dispatcher import PipelineDispatcher
        from sitewhere_tpu_torch.services.device_management import (
            RegistryMirror,
        )
        from sitewhere_tpu_torch.state.manager import DeviceStateManager
        dev = {"device": "cpu"}

    identity = IdentityMap()
    identity.tenant.mint("default")
    identity.tenant.mint("acme")
    for name in WIRE_MTYPES:
        identity.mtype.mint(name)
    for name in WIRE_ALERTS + tuple(f"zone-{z}" for z in range(4)):
        identity.alert_type.mint(name)
    mirror = RegistryMirror(WIRE_CAP, max_zones=4, max_verts=8, **dev)
    for i in range(WIRE_DEVICES):
        d = identity.device.mint(f"dev-{i}")
        mirror.set_device_row(
            d, active=True, tenant_id=1 if i % 10 == 7 else 0,
            device_type_id=i % 3, assignment_id=i,
            assignment_status=int(enums.AssignmentStatus.MISSING
                                  if i % 13 == 5
                                  else enums.AssignmentStatus.ACTIVE),
            area_id=i % 4, customer_id=i % 5, asset_id=i % 7)
    squares = [[[0, 0], [10, 0], [10, 10], [0, 10]],
               [[-5, -5], [3, -5], [3, 3], [-5, 3]],
               [[20, 20], [30, 22], [25, 30]],
               [[-30, -30], [30, -30], [30, 30], [-30, 30]]]
    for z, poly in enumerate(squares):
        mirror.set_zone_row(
            z, active=True, tenant_id=-1 if z != 2 else 0,
            area_id=-1 if z != 1 else 1,
            verts_lonlat=np.asarray(poly, np.float32),
            condition=int(enums.ZoneCondition.ALERT_IF_OUTSIDE if z == 3
                          else enums.ZoneCondition.ALERT_IF_INSIDE),
            alert_code=identity.alert_type.lookup(f"zone-{z}"),
            alert_level=z % 4)
    rules = RuleManager(identity, capacity=16, **dev)
    _wire_rules(rules, enums)
    state = DeviceStateManager(
        WIRE_CAP, identity, num_mtype_slots=WIRE_M,
        tenant_id_of_device=lambda ids: mirror.tenant_id[ids],
        num_ewma_scales=3, **dev)
    clock = FakeClock()
    batcher = Batcher(
        width=WIRE_WIDTH, n_shards=1, registry_capacity=WIRE_CAP,
        resolve_device=identity.device.lookup,
        resolve_mtype=identity.mtype.mint,
        resolve_alert=identity.alert_type.mint,
        invocations=identity.invocation, deadline_ms=60_000.0,
        clock=clock, emit_packed=emit_packed)
    journal = Journal(str(journal_root), "events", fsync_every=1 << 30)
    reader = JournalReader(journal, group)
    store = RecordingStore()
    disp = PipelineDispatcher(
        batcher=batcher,
        registry_provider=mirror.publish_registry,
        state_manager=state,
        rules_provider=rules.publish,
        zones_provider=mirror.publish_zones,
        event_store=store,
        journal=journal,
        journal_reader=reader,
        resolve_tenant=identity.tenant.mint,
        ring_depth=ring_depth,
        **dispatcher_kw, **dev)
    return types.SimpleNamespace(
        disp=disp, identity=identity, mirror=mirror, rules=rules,
        state=state, batcher=batcher, journal=journal, reader=reader,
        store=store, clock=clock)


def wire_payload(rng, n: int, t_ms: int, kinds=("m", "l", "a"),
                 p=(0.6, 0.3, 0.1), ghosts: float = 0.05,
                 nan: bool = False) -> bytes:
    """``n`` NDJSON lines in the measurement/location/alert mix: a few
    unregistered tokens, few distinct timestamps (ties on one device),
    and with ``nan`` one measurement whose value is NaN."""
    lines = []
    for i in range(n):
        kind = kinds[int(rng.choice(len(kinds), p=p))]
        dev = (f"ghost-{int(rng.integers(0, 5))}" if rng.random() < ghosts
               else f"dev-{int(rng.integers(0, WIRE_DEVICES + 0))}")
        ts = t_ms + 250 * int(rng.integers(0, 3))
        if kind == "m":
            req = {"name": WIRE_MTYPES[int(rng.integers(0, WIRE_M))],
                   "value": round(float(rng.uniform(-10, 110)), 2),
                   "eventDate": ts}
            if nan and i == 0:
                req["value"] = float("nan")
            doc = {"deviceToken": dev, "type": "DeviceMeasurements",
                   "request": req}
        elif kind == "l":
            doc = {"deviceToken": dev, "type": "DeviceLocation",
                   "request": {"latitude": round(float(rng.uniform(-35, 35)), 3),
                               "longitude": round(float(rng.uniform(-35, 35)), 3),
                               "elevation": round(float(rng.uniform(0, 50)), 1),
                               "eventDate": ts}}
        else:
            doc = {"deviceToken": dev, "type": "DeviceAlert",
                   "request": {"type": WIRE_ALERTS[int(rng.integers(0, 3))],
                               "level": ("info", "warning", "error")[
                                   int(rng.integers(0, 3))],
                               "eventDate": ts}}
        lines.append(json.dumps(doc, separators=(",", ":")))
    return "\n".join(lines).encode()


def journal_files(journal):
    """Every file of a journal's directory, name -> bytes (flushed)."""
    import os

    journal.flush()
    return {name: open(os.path.join(journal.dir, name), "rb").read()
            for name in sorted(os.listdir(journal.dir))}


# -- the reference's own test modules, run against the port ------------------

def port_test_module(path, replace=()):
    """The reference test module at ``path`` with every ``sitewhere_tpu``
    import pointing at the port, each port ``Instance``, and each
    ``RegistryMirror``, ``TenantEngine`` and ``MultitenantEngineManager``
    the module imports at its top, on the CPU.
    ``replace``: ``(old, new)`` source edits applied first, for imports
    of names the port does not have.  ``tests/test_instance.py``'s
    helpers come from :func:`make_config` and :func:`seed_device` here."""
    import re
    from pathlib import Path

    path = Path(path)
    src = path.read_text()
    for old, new in replace:
        assert old in src, old
        src = src.replace(old, new)
    src = re.sub(r"\bsitewhere_tpu\.", "sitewhere_tpu_torch.", src)
    src = src.replace("from tests.test_instance import",
                      "from torch_parity import")
    src = src.replace(
        "from sitewhere_tpu_torch.instance import Instance, InstanceTemplate",
        "from sitewhere_tpu_torch.instance import InstanceTemplate\n"
        "from sitewhere_tpu_torch.instance import Instance")
    src = src.replace(
        "from sitewhere_tpu_torch.instance import Instance\n",
        "from torch_parity import CpuInstance as Instance\n")
    ns = {"__name__": f"port_{path.stem}", "__file__": str(path)}
    exec(compile(src, f"<port {path.stem}>", "exec"), ns)
    for name in ("RegistryMirror", "TenantEngine", "MultitenantEngineManager"):
        if name in ns:
            ns[name] = functools.partial(ns[name], device="cpu")
    return ns


class FakeStreams:
    """Thread-local "current stream" stand-in for ``torch.cuda``: patch
    ``torch.cuda.stream`` with :meth:`stream` and
    ``torch.cuda.current_stream`` with :meth:`current`.  A thread's
    current stream is ``default`` until it enters another."""

    def __init__(self, default="default-stream"):
        import threading

        self.default = default
        self.local = threading.local()

    def current(self, *args, **kw):
        return getattr(self.local, "stream", self.default)

    def stream(self, s):
        import contextlib

        @contextlib.contextmanager
        def ctx():
            prev = self.current()
            self.local.stream = s
            try:
                yield
            finally:
                self.local.stream = prev

        return ctx()


def CpuInstance(config=None, template=None, **kw):
    from sitewhere_tpu_torch.instance import Instance

    kw.setdefault("device", "cpu")
    return Instance(config, template, **kw)


def make_config(tmp_path, **pipeline):
    """``tests/test_instance.py make_config`` for the port."""
    from sitewhere_tpu_torch.runtime.config import Config

    return Config({
        "instance": {"id": "test-instance", "data_dir": str(tmp_path / "data")},
        "pipeline": {
            "width": 64, "registry_capacity": 1024, "mtype_slots": 4,
            "deadline_ms": 5.0, "n_shards": 1, **pipeline,
        },
        "presence": {"scan_interval_s": 3600.0, "missing_after_s": 1800},
    }, apply_env=False)


def seed_device(inst, token="dev-1", mtype=None):
    """``tests/test_instance.py seed_device``: one device of type
    ``sensor``, assigned."""
    inst.device_management.create_device_type(token="sensor", name="Sensor")
    inst.device_management.create_device(token=token, device_type="sensor")
    inst.device_management.create_device_assignment(device=token)


def reference_cases(path, skip=()):
    """``class.method`` / function ids of every test in the reference
    module at ``path``, apart from the names in ``skip``."""
    import re
    from pathlib import Path

    src = Path(path).read_text()
    tests = re.findall(r"^def (test_\w+)\(", src, re.M)
    for cls, body in re.findall(r"^class (Test\w+):\n((?:    .*\n|\n)+)",
                                src, re.M):
        tests += [f"{cls}.{m}" for m in
                  re.findall(r"^    def (test_\w+)\(", body, re.M)]
    return [t for t in tests
            if t.split(".")[-1] not in skip and t.split(".")[0] not in skip]


def port_cases(ns, skip=()):
    """Ids of every test in a :func:`port_test_module` namespace, apart
    from the names in ``skip``: ``name`` or ``Class.method``, with
    ``[i]`` for each parameter set of a parametrized test."""
    import inspect

    found = []
    for name, obj in ns.items():
        if name.startswith("test_") and inspect.isfunction(obj):
            found.append((name, obj))
        elif name.startswith("Test") and inspect.isclass(obj):
            found += [(f"{name}.{m}", fn) for m, fn in vars(obj).items()
                      if m.startswith("test_") and inspect.isfunction(fn)]
    out = []
    for case, fn in found:
        if case.split(".")[-1] in skip or case.split(".")[0] in skip:
            continue
        sets = _param_sets(fn)
        out += ([case] if sets is None
                else [f"{case}[{i}]" for i in range(len(sets))])
    return out


def _param_sets(fn):
    """The parameter dicts of ``fn``'s ``pytest.mark.parametrize`` marks
    (their product), or None when it has none."""
    import itertools

    marks = [m for m in getattr(fn, "pytestmark", [])
             if m.name == "parametrize"]
    if not marks:
        return None
    axes = []
    for mark in marks:
        names, values = mark.args[0], mark.args[1]
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",")]
        axes.append([dict(zip(names, _param_values(v, len(names))))
                     for v in values])
    return [{k: v for d in combo for k, v in d.items()}
            for combo in itertools.product(*axes)]


def _param_values(value, n_names):
    if hasattr(value, "values") and hasattr(value, "marks"):
        return value.values        # pytest.param(...)
    return value if n_names > 1 else (value,)


def run_port_case(ns, case, tmp_path, fixtures=None):
    """Run one reference case from a :func:`port_test_module` namespace;
    ``tmp_path`` and ``fixtures`` (name -> value) fill its parameters, a
    ``[i]`` suffix picks a parameter set, and the fixtures of the case's
    class, then the module's own (generators too, torn down afterwards),
    fill the rest.  As under pytest, the module's autouse fixtures run
    around the case, as do its class's ``setup_method`` and
    ``teardown_method``."""
    import inspect

    case, _, index = case.partition("[")
    owner = None
    if "." in case:
        cls, method = case.split(".")
        owner = ns[cls]()
        fn = getattr(owner, method)
    else:
        fn = ns[case]
    params = _param_sets(fn)[int(index[:-1])] if index else {}
    teardown = []

    def resolve(func, given):
        args = {}
        for param in inspect.signature(func).parameters:
            if param in given:
                args[param] = given[param]
            elif param == "tmp_path":
                args[param] = tmp_path
            elif fixtures and param in fixtures:
                args[param] = fixtures[param]
            else:
                # a fixture of the case's own class binds to its instance
                if owner is not None and hasattr(type(owner), param):
                    fixture = getattr(type(owner), param).__wrapped__
                    fixture = fixture.__get__(owner)
                else:
                    fixture = ns[param].__wrapped__
                value = fixture(**resolve(fixture, {}))
                if inspect.isgenerator(value):
                    teardown.append(value)
                    value = next(value)
                args[param] = value
        return args

    try:
        for obj in list(ns.values()):
            marker = getattr(obj, "_fixture_function_marker", None)
            if marker is not None and marker.autouse:
                fixture = obj.__wrapped__
                value = fixture(**resolve(fixture, {}))
                if inspect.isgenerator(value):
                    teardown.append(value)
                    next(value)
        _call_method_hook(owner, "setup_method", fn)
        try:
            fn(**resolve(fn, params))
        finally:
            _call_method_hook(owner, "teardown_method", fn)
    finally:
        for gen in reversed(teardown):
            next(gen, None)


def _call_method_hook(owner, name, fn):
    """``owner.<name>()``, with the test method when it takes one (as
    pytest calls ``setup_method`` / ``teardown_method``)."""
    import inspect

    hook = getattr(owner, name, None)
    if hook is None:
        return
    if inspect.signature(hook).parameters:
        hook(fn)
    else:
        hook()
