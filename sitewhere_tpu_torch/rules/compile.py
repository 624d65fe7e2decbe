"""The bucketing compiler: structure-shared passes over operand tables.

Counterpart of ``sitewhere_tpu/rules/compile.py``, its mesh half
(:func:`sharded_prepare`) included.  Programs sharing a
:func:`~sitewhere_tpu_torch.rules.dsl.structure_key` share ONE group-eval
pass; everything that distinguishes them (thresholds, comparison ops,
window choices, polygon rings, attribute ids, alert codes) is data in
padded operand tables indexed by a per-row program id.

Two passes per batch, plain torch on the device their inputs lie on:

- :func:`rules_prepare_batch` folds each row against the engine's trailing
  per-(device, mtype-slot) state (EWMA ladder and rate since the previous
  sample, through the fused step's :func:`fold_ewma_arrays`), writes the
  batch's winners into the trail (newest ``(ts_s, ts_ns)`` wins, the
  highest batch row on a tie) and gathers the metadata-join rows of the
  device and asset attribute tables.
- :func:`rules_group_eval` decodes the operand tables for up to ``S``
  programs per row-tenant and reduces the padded ``[B, S, C, P]``
  predicate lattice to fired/alert outputs.

Eager torch compiles nothing, so the reference's trace cache becomes a
signature cache: :func:`kernel_for` returns one callable per structure
key, and :func:`compile_count` counts the distinct signatures (structure
key, ``has_geo`` and table shapes for a group; trail and attribute-table
shapes for the prepare pass) that have run.  The reference's zero-
recompile swap contract reads here as "an operand swap adds no
signature".

Rounding: none of this may run under ``torch.compile``.  Fusion would
contract ``slope * (py - y1) + x1`` and the ``dt`` sum into FMAs the way
XLA:CPU does, and the card would part from the port's CPU run, which
rounds each product and sum on its own (as the geofence kernel does).
Eager kernels round each op once, on the CPU and the card alike.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, NamedTuple, Set, Tuple

import torch

from sitewhere_tpu_torch.ids import NULL_ID
from sitewhere_tpu_torch.ops.geo import guarded_slope
from sitewhere_tpu_torch.ops.scatter import winner_rows
from sitewhere_tpu_torch.pipeline.step import compare_select, fold_ewma_arrays
from sitewhere_tpu_torch.rules.dsl import (
    PK_ATTR,
    PK_GEO,
    PK_PAD,
    PK_RATE,
    PK_VALUE,
)
from sitewhere_tpu_torch.schema import EventType

# Transient memory of the geo lane.  The reference gathers the polygon
# pool to [B, S, C, P, V, 2] (537 MB at B = 131072 and structure c4p4g)
# and XLA fuses the crossing test over it; eager torch materializes each
# intermediate of _pip_rows at [B, S, C, P, V] (268 MB each in float32).
# The lane therefore runs in row chunks that keep the gather and the
# intermediates alive at once under this budget.  Chunking is there for
# memory only: every row's result is the same whatever the chunk.
GEO_LANE_BUDGET_BYTES = 1 << 30
# bytes alive per (row, predicate, vertex) while _pip_rows runs: the
# gathered vertex pair (8) and up to ten float32/bool temporaries
GEO_LANE_BYTES_PER_EDGE = 48


class GroupTables(NamedTuple):
    """Operand tables for ONE structure group (epoch-immutable tensors).

    ``kind``/``pf`` are ``[G, C, P]``; ``pint`` packs the four int
    operands ``(op, i0, i1, i2)`` as ``[G, C, P, 4]``.  ``meta`` packs
    per-program ``(tenant_id, alert_code, alert_level, active)`` as
    ``[G, 4]``; ``slots`` maps dense tenant id to up to ``S`` program rows
    (``[T, S]``, NULL_ID padded); ``verts`` is the group's polygon pool
    ``[Z, V, 2]`` (a 1-row dummy for geo-less structures)."""

    kind: torch.Tensor
    pint: torch.Tensor
    pf: torch.Tensor
    meta: torch.Tensor
    slots: torch.Tensor
    verts: torch.Tensor


class BatchFeatures(NamedTuple):
    """Per-row features of the prepare pass, read by every group pass."""

    ewma: torch.Tensor        # f32[B, K]   candidate EWMAs incl. this row
    rate: torch.Tensor        # f32[B]      value delta / dt vs prev sample
    rate_valid: torch.Tensor  # bool[B]     previous sample exists, dt > 0
    dev_attr: torch.Tensor    # i32[B, Ad]  device attribute row (NULL_ID unset)
    asset_attr: torch.Tensor  # i32[B, Aa]  asset attribute row


def _pip_rows(px: torch.Tensor, py: torch.Tensor,
              verts: torch.Tensor) -> torch.Tensor:
    """Ray-crossing containment for per-row gathered polygons
    (``verts[..., V, 2]`` aligned with the predicate lattice): the
    slope-first arithmetic and guarded denominator of
    :func:`~sitewhere_tpu_torch.ops.geo.points_in_polygons`, each product
    and sum rounded on its own."""
    x1 = verts[..., :, 0]
    y1 = verts[..., :, 1]
    x2 = torch.roll(x1, -1, dims=-1)
    y2 = torch.roll(y1, -1, dims=-1)
    pxe = px[..., None]
    pye = py[..., None]
    straddles = (y1 > pye) != (y2 > pye)
    slope = guarded_slope(x1, y1, x2, y2)
    x_cross = slope * (pye - y1) + x1
    crossing = straddles & (pxe < x_cross)
    return (crossing.to(torch.int32).sum(dim=-1) % 2) == 1


def _take_rows(table: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``table[b, idx[b, ...]]`` where ``0 <= idx < table.shape[1]``, else
    ``fill``: ``table[B, A]`` x ``idx[B, ...]`` -> ``idx``'s shape.

    The reference selects with a one-hot loop over the A columns (8
    attribute columns, 3 EWMA scales), one full lattice tensor per column,
    because a take-along lowers to a scalar gather loop on a TPU.  On the
    card ``torch.gather`` along the last dim selects the same values with
    no arithmetic, so the result is bitwise the same."""
    n_cols = table.shape[1]
    if n_cols == 0:
        return torch.full(idx.shape, fill, dtype=table.dtype,
                          device=table.device)
    ok = (idx >= 0) & (idx < n_cols)
    flat = idx.clamp(0, n_cols - 1).reshape(idx.shape[0], -1).to(torch.int64)
    got = torch.gather(table, 1, flat).reshape(idx.shape)
    return torch.where(ok, got, fill)


def _geo_hits(verts: torch.Tensor, zi: torch.Tensor, lon: torch.Tensor,
              lat: torch.Tensor) -> torch.Tensor:
    """``bool[B, S, C, P]``: each lattice point's row inside its polygon,
    evaluated in row chunks of at most GEO_LANE_BUDGET_BYTES of
    transients."""
    rows = zi.shape[0]
    per_row = max(1, zi[0].numel() * verts.shape[1] * GEO_LANE_BYTES_PER_EDGE)
    chunk = max(1, GEO_LANE_BUDGET_BYTES // per_row)
    if chunk >= rows:
        return _pip_rows(lon[:, None, None, None], lat[:, None, None, None],
                         verts[zi])
    inside = torch.empty(zi.shape, dtype=torch.bool, device=zi.device)
    for r0 in range(0, rows, chunk):
        r1 = min(rows, r0 + chunk)
        inside[r0:r1] = _pip_rows(lon[r0:r1, None, None, None],
                                  lat[r0:r1, None, None, None],
                                  verts[zi[r0:r1]])
    return inside


def rules_group_eval(
    tables: GroupTables,
    feats: BatchFeatures,
    tenant_id: torch.Tensor,
    event_type: torch.Tensor,
    mtype_id: torch.Tensor,
    value: torch.Tensor,
    lon: torch.Tensor,
    lat: torch.Tensor,
    accepted: torch.Tensor,
    *,
    has_geo: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Evaluate every program of one structure group over one batch.

    Returns ``(fired[B, S], code[B, S], level[B, S], pid[B, S])``: up to S
    programs per row-tenant, each firing its own alert.  Cost is
    O(B * S * C * P) whatever the group's program count.  Out-of-range
    tenant, program and polygon ids are clamped before they index, as the
    reference's ``jnp.clip`` gathers."""
    n_tenants, _ = tables.slots.shape
    n_progs = tables.kind.shape[0]
    lattice = (slice(None), None, None, None)    # [B] -> [B, 1, 1, 1]

    pid = tables.slots[tenant_id.clamp(0, n_tenants - 1).to(torch.int64)]
    g = pid.clamp(0, n_progs - 1).to(torch.int64)             # [B, S]
    meta = tables.meta[g]                                      # [B, S, 4]
    # BYO programs evaluate device telemetry; alert rows (this engine's
    # own re-injected alerts among them) are masked, so the re-injection
    # loop cannot amplify itself
    row_ok = accepted & (event_type != EventType.ALERT)
    ok = ((pid != NULL_ID) & row_ok[:, None]
          & (meta[..., 0] == tenant_id[:, None]) & (meta[..., 3] != 0))

    kind = tables.kind[g]                                      # [B, S, C, P]
    op, i0, i1, i2 = tables.pint[g].unbind(-1)
    f0 = tables.pf[g]

    # float lane: value / EWMA / rate vs threshold, on measurement rows
    # with the optional mtype filter (NULL_ID = any); rate needs a usable
    # previous sample
    is_meas = accepted & (event_type == EventType.MEASUREMENT)
    e_sel = _take_rows(feats.ewma, i1, 0.0)
    fval = torch.where(kind == PK_VALUE, value[lattice],
                       torch.where(kind == PK_RATE, feats.rate[lattice],
                                   e_sel))
    mtype_ok = (i0 == NULL_ID) | (i0 == mtype_id[lattice])
    fgate = (is_meas[lattice] & mtype_ok
             & ((kind != PK_RATE) | feats.rate_valid[lattice]))
    fhit = compare_select(op, fval, f0) & fgate

    # int lane: attribute joins (unset attributes and columns outside
    # the block never match) and event-type gates
    aval = torch.where(i2 == 1, _take_rows(feats.asset_attr, i1, NULL_ID),
                       _take_rows(feats.dev_attr, i1, NULL_ID))
    ahit = compare_select(op, aval, i0) & (aval != NULL_ID)
    ehit = compare_select(op, event_type[lattice], i0)

    if has_geo:
        zi = i1.clamp(0, tables.verts.shape[0] - 1).to(torch.int64)
        inside = _geo_hits(tables.verts, zi, lon, lat)
        is_loc = accepted & (event_type == EventType.LOCATION)
        ghit = torch.where(i0 == 1, inside, ~inside) & is_loc[lattice]
    else:
        ghit = torch.zeros(kind.shape, dtype=torch.bool, device=kind.device)

    res = torch.where(
        kind == PK_PAD, True,
        torch.where(kind <= PK_RATE, fhit,
                    torch.where(kind == PK_GEO, ghit,
                                torch.where(kind == PK_ATTR, ahit, ehit))))
    clause_real = (kind != PK_PAD).any(dim=-1)                 # [B, S, C]
    clause_hit = res.all(dim=-1) & clause_real
    fired = clause_hit.any(dim=-1) & ok                        # [B, S]
    code = torch.where(fired, meta[..., 1], NULL_ID)
    level = torch.where(fired, meta[..., 2], 0)
    return fired, code, level, pid


def rules_prepare_batch(
    trail_ts: torch.Tensor,
    trail_ns: torch.Tensor,
    trail_v: torch.Tensor,
    trail_ewma: torch.Tensor,
    dev_attr: torch.Tensor,
    asset_attr: torch.Tensor,
    device_id: torch.Tensor,
    asset_id: torch.Tensor,
    ts_s: torch.Tensor,
    ts_ns: torch.Tensor,
    mtype_id: torch.Tensor,
    value: torch.Tensor,
    event_type: torch.Tensor,
    accepted: torch.Tensor,
    taus: torch.Tensor,
) -> Tuple[BatchFeatures, Tuple[torch.Tensor, ...]]:
    """Per-row features of one batch, and the trail updated IN PLACE.

    The trail is the engine's per-(device, mtype-slot) last-sample / EWMA
    store, ``[D, M]``-shaped like ``DeviceState``, so window and rate
    predicates see the semantics ``rules/interp.py`` defines.  Returns
    ``(features, trail)``, the trail being the four tensors passed in.

    The donated trail: the reference's prepare donates the four trail
    buffers so XLA updates them in place.  Here the trail scatter is the
    winner map of :func:`~sitewhere_tpu_torch.ops.scatter.
    scatter_last_by_time` (``winner_rows``: dump slot for masked and
    out-of-range rows, the highest batch row on a tie), applied at the
    batch's own slots only: every row writes its slot's resolved value,
    which all rows of one slot share, so the duplicate writes agree.  The
    ``[D, M]`` blocks (192 MiB at 2^20 x 8) are never copied.

    Attribute rows gather NULL_ID for ids outside the tables (unset
    attributes never match a join predicate)."""
    n_dev, n_slot = trail_ts.shape
    n_scales = trail_ewma.shape[2]
    is_meas = accepted & (event_type == EventType.MEASUREMENT)

    ids = device_id.clamp(0, n_dev - 1)
    # mtype_id % M sits behind its >= 0 guard (torch's % is floor-mod,
    # as jnp's, but negative ids never reach it)
    slot = torch.where(mtype_id >= 0, mtype_id % n_slot, 0)
    flat32 = ids * n_slot + slot
    flat = flat32.to(torch.int64)
    ts_flat, ns_flat = trail_ts.view(-1), trail_ns.view(-1)
    v_flat, ewma_flat = trail_v.view(-1), trail_ewma.view(-1, n_scales)
    prev_ts, prev_ns = ts_flat[flat], ns_flat[flat]
    prev_v, ewma_prev = v_flat[flat], ewma_flat[flat]

    seeded = prev_ts > 0
    # the reference's dt (compile.py:253-255), which XLA:CPU may contract
    # into an FMA; here the product and the sum round apart
    dt = ((ts_s - prev_ts).to(torch.float32)
          + (ts_ns - prev_ns).to(torch.float32) * 1e-9).clamp_min(0.0)
    rate_valid = seeded & (dt > 0) & is_meas
    rate = torch.where(rate_valid, (value - prev_v) / dt.clamp_min(1e-9), 0.0)
    ewma_new = fold_ewma_arrays(prev_ts, prev_ns, ewma_prev,
                                ts_s, ts_ns, value, taus)   # [B, K]

    keep = is_meas & (device_id >= 0) & (device_id < n_dev)
    slot_row = winner_rows(flat32, ts_s, ts_ns, keep, n_dev * n_slot)
    win = slot_row[flat]                     # each row's slot's winner
    has = win >= 0
    wr = win.clamp_min(0).to(torch.int64)
    w_s, w_ns = ts_s[wr], ts_ns[wr]
    # apply_winners' rule: events win exact ties against the stored key
    newer = has & ((w_s > prev_ts) | ((w_s == prev_ts) & (w_ns >= prev_ns)))
    ts_flat.index_put_((flat,), torch.where(newer, w_s, prev_ts))
    ns_flat.index_put_((flat,), torch.where(newer, w_ns, prev_ns))
    v_flat.index_put_((flat,), torch.where(newer, value[wr], prev_v))
    ewma_flat.index_put_((flat,), torch.where(newer[:, None], ewma_new[wr],
                                              ewma_prev))

    n_da = dev_attr.shape[0]
    dev_ok = (device_id >= 0) & (device_id < n_da)
    da = torch.where(
        dev_ok[:, None],
        dev_attr[device_id.clamp(0, n_da - 1).to(torch.int64)], NULL_ID)
    n_aa = asset_attr.shape[0]
    asset_ok = (asset_id >= 0) & (asset_id < n_aa)
    aa = torch.where(
        asset_ok[:, None],
        asset_attr[asset_id.clamp(0, n_aa - 1).to(torch.int64)], NULL_ID)

    feats = BatchFeatures(ewma=ewma_new, rate=rate, rate_valid=rate_valid,
                          dev_attr=da, asset_attr=aa)
    return feats, (trail_ts, trail_ns, trail_v, trail_ewma)


# -- mesh-sharded prepare ----------------------------------------------------

def sharded_prepare(mesh, rows_per_shard: int) -> Callable:
    """The prepare pass over ``mesh``: the trail and the device-attribute
    table sharded by ``device_id // rows_per_shard`` exactly like device
    state, the batch and the (small) asset table replicated, the
    features summed over the shards.  Same arguments and results as
    :func:`prepare_kernel`'s callable.

    Each shard computes features only for the rows whose device it owns.
    Elsewhere it contributes an exact zero: ``-0.0``, the additive
    identity of an IEEE sum, through ``torch.where`` and never a product
    (``0 * inf`` is NaN), so the summed features equal the unsharded
    pass's bitwise, ``-0.0``, infinities and NaNs included.  The NULL_ID
    attribute fill rides an ``x + 1`` shift, so rows no shard owns still
    read as unset.  Trail updates stay shard-local, in place."""
    from sitewhere_tpu_torch.parallel.mesh import SHARD_AXIS, P
    from sitewhere_tpu_torch.parallel.shmap import PSUM, axis_index, shard_map

    shard1 = P(SHARD_AXIS)
    rep = P()
    in_specs = (
        shard1, shard1, shard1, shard1,          # trail ts/ns/v/ewma
        shard1, rep,                             # dev_attr, asset_attr
        rep, rep, rep, rep, rep, rep, rep, rep,  # batch columns
        rep,                                     # taus
    )
    out_specs = (PSUM, (shard1, shard1, shard1, shard1))
    n_shards = mesh.n_shards

    def local_prepare(trail_ts, trail_ns, trail_v, trail_ewma,
                      dev_attr, asset_attr, device_id, asset_id,
                      ts_s, ts_ns, mtype_id, value, event_type,
                      accepted, taus):
        offset = axis_index(SHARD_AXIS) * rows_per_shard
        local_id = device_id - offset
        owned = (local_id >= 0) & (local_id < rows_per_shard)
        feats, trail = rules_prepare_batch(
            trail_ts, trail_ns, trail_v, trail_ewma, dev_attr, asset_attr,
            torch.where(owned, local_id, NULL_ID), asset_id, ts_s, ts_ns,
            mtype_id, value, event_type, accepted & owned, taus)
        zero = torch.tensor(-0.0, dtype=torch.float32,
                            device=device_id.device)
        shifted = (
            torch.where(owned[:, None], feats.ewma, zero),
            torch.where(owned, feats.rate, zero),
            (feats.rate_valid & owned).to(torch.int32),
            torch.where(owned[:, None], feats.dev_attr + 1, 0),
            feats.asset_attr + 1,
        )
        return shifted, trail

    mapped = shard_map(local_prepare, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs)

    def prepare(*args):
        (ewma, rate, rate_valid, dev_attr, asset_attr), trail = mapped(
            *args)
        feats = BatchFeatures(
            ewma=ewma.shards[0], rate=rate.shards[0],
            rate_valid=rate_valid.shards[0] > 0,
            dev_attr=dev_attr.shards[0] - 1,
            # the asset table is replicated: every shard contributes the
            # same shifted row, so divide the sum back out
            asset_attr=asset_attr.shards[0] // n_shards - 1)
        return feats, trail

    return prepare


# -- the signature cache (the reference's trace cache) ------------------------

_CACHE_LOCK = threading.Lock()
_EVAL_KERNELS: Dict[str, Callable] = {}
_SIGNATURES: Set[tuple] = set()
_PREPARE_KERNEL = None


def _note(signature: tuple) -> None:
    with _CACHE_LOCK:
        _SIGNATURES.add(signature)


class _GroupPass:
    """:func:`rules_group_eval` for one structure key, recording each
    ``(key, has_geo, table shapes)`` signature it runs."""

    def __init__(self, key: str):
        self.key = key

    def __call__(self, tables: GroupTables, *args, has_geo: bool, **kw):
        _note((self.key, bool(has_geo))
              + tuple(tuple(t.shape) for t in tables))
        return rules_group_eval(tables, *args, has_geo=has_geo, **kw)


def _prepare_pass(*args):
    """:func:`rules_prepare_batch`, recording its trail and attribute
    table shapes as one signature."""
    _note(("prepare",) + tuple(tuple(a.shape) for a in args[:6]))
    return rules_prepare_batch(*args)


def kernel_for(key: str) -> Callable:
    """The group pass for a structure key: every group with the same key
    shares the SAME callable, so loading 100k programs mints at most
    ``dsl.MAX_STRUCTURE_KEYS`` of them."""
    with _CACHE_LOCK:
        fn = _EVAL_KERNELS.get(key)
        if fn is None:
            fn = _EVAL_KERNELS[key] = _GroupPass(key)
        return fn


def prepare_kernel() -> Callable:
    """The (single) prepare pass; it updates the trail in place."""
    global _PREPARE_KERNEL
    with _CACHE_LOCK:
        if _PREPARE_KERNEL is None:
            _PREPARE_KERNEL = _prepare_pass
        return _PREPARE_KERNEL


def compile_count() -> int:
    """Distinct signatures run by the rules passes (eager torch compiles
    nothing; this counts what would each be one executable in the
    reference): the number ``tools/rulebench.py`` bounds and the hot-swap
    tests assert is FLAT across an operand swap."""
    with _CACHE_LOCK:
        return len(_SIGNATURES)


def structure_keys_compiled() -> int:
    with _CACHE_LOCK:
        return len(_EVAL_KERNELS)


def reset_trace_cache() -> None:
    """Test/bench hook: drop every cached pass and signature."""
    global _PREPARE_KERNEL
    with _CACHE_LOCK:
        _EVAL_KERNELS.clear()
        _SIGNATURES.clear()
        _PREPARE_KERNEL = None


__all__ = [
    "GroupTables", "BatchFeatures", "rules_group_eval",
    "rules_prepare_batch", "kernel_for", "prepare_kernel",
    "compile_count", "structure_keys_compiled", "reset_trace_cache",
    "sharded_prepare",
    "GEO_LANE_BUDGET_BYTES",
]
