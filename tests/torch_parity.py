"""Shared fixtures for the parity tests of the PyTorch port.

One numpy fixture feeds both packages: the JAX reference gets ``jnp``
arrays, the port gets tensors on the CPU through
``sitewhere_tpu_torch.convert``.  The fixtures are small (D=256, B=512,
R=8, Z=8, V=8, M=4, K=3) and hit the cases where the two could part:
duplicate device rows with equal ``(ts_s, ts_ns)``, unregistered,
unassigned and tenant-mismatch rows, ``NULL_ID`` tenants, NaN/Inf rows,
rate rules with dt == 0, and several rules or zones firing on one row.
"""

from __future__ import annotations

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
