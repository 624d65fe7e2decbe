"""The fused inbound step: validate -> enrich -> rules -> state -> outputs.

Counterpart of ``sitewhere_tpu/pipeline/step.py``, stage for stage:

1. registry validation and enrichment as one packed ``[8, B]`` gather;
2. the NaN/Inf mask (poison rows persist but never reach rules or state);
3. ``[B, R]`` instant, EWMA and rate rules;
4. the ``[B, Z]`` geofence, through the CUDA kernel on the card;
5. four newest-wins winner maps with their state merges;
6. derived alerts, and the step metrics.

Every function is a plain function of tensors and runs on the device its
inputs lie on.  Nothing here updates an input in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from sitewhere_tpu_torch.ids import NULL_ID
from sitewhere_tpu_torch.ops.geo_cuda import points_in_polygons_auto
from sitewhere_tpu_torch.ops.scatter import apply_winners, bincount_fixed, winner_rows
from sitewhere_tpu_torch.schema import (
    DEFAULT_EWMA_TAUS,
    AssignmentStatus,
    ComparisonOp,
    DeviceState,
    EventBatch,
    EventType,
    Registry,
    RuleKind,
    RuleTable,
    ZoneCondition,
    ZoneTable,
)

NUM_EVENT_TYPES = 6

# (points float32[B, 2], verts float32[Z, V, 2]) -> bool[B, Z]
GeofenceFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class StepMetrics:
    """Per-step counters (int32 scalars; ``by_type`` int32[6])."""

    processed: torch.Tensor
    accepted: torch.Tensor
    unregistered: torch.Tensor
    unassigned: torch.Tensor
    threshold_alerts: torch.Tensor
    zone_alerts: torch.Tensor
    by_type: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PipelineOutputs:
    """Everything the host needs from one pipeline step."""

    accepted: torch.Tensor        # bool[B]
    unregistered: torch.Tensor    # bool[B]
    unassigned: torch.Tensor      # bool[B]
    nonfinite: torch.Tensor       # bool[B]
    device_type_id: torch.Tensor  # int32[B]
    assignment_id: torch.Tensor   # int32[B]
    area_id: torch.Tensor         # int32[B]
    customer_id: torch.Tensor     # int32[B]
    asset_id: torch.Tensor        # int32[B]
    rule_id: torch.Tensor         # int32[B] — NULL_ID if none fired
    zone_id: torch.Tensor         # int32[B] — NULL_ID if none fired
    present_now: torch.Tensor     # bool[D] — devices this step merged
    derived_alerts: EventBatch
    metrics: StepMetrics


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _null_unless(keep: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(keep, x, NULL_ID)


def validate_and_enrich(
    registry: Registry, batch: EventBatch
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Registry gather replacing the per-event device/assignment lookups:
    ``(accepted, unregistered, unassigned, enrich)``."""
    cap = registry.capacity
    ids = batch.device_id
    in_range = (ids >= 0) & (ids < cap)
    safe = ids.clamp(0, cap - 1).to(torch.int64)
    packed = torch.stack([
        _i32(registry.active),
        registry.tenant_id,
        registry.assignment_status,
        registry.device_type_id,
        registry.assignment_id,
        registry.area_id,
        registry.customer_id,
        registry.asset_id,
    ])[:, safe]  # [8, B]

    registered = in_range & (packed[0] != 0)
    tenant_ok = packed[1] == batch.tenant_id
    assigned = packed[2] == AssignmentStatus.ACTIVE

    valid = batch.valid
    unregistered = valid & ~(registered & tenant_ok)
    unassigned = valid & registered & tenant_ok & ~assigned
    accepted = valid & registered & tenant_ok & assigned

    enrich = {
        name: _null_unless(accepted, packed[3 + i])
        for i, name in enumerate(("device_type_id", "assignment_id",
                                  "area_id", "customer_id", "asset_id"))
    }
    return accepted, unregistered, unassigned, enrich


def _gather_meas_state(
    state: DeviceState, batch: EventBatch
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row previous measurement-slot state:
    ``(prev_ts, prev_ns, prev_value, ewma_prev[B, K])``."""
    cap = state.capacity
    m = state.num_mtype_slots
    ids_safe = batch.device_id.clamp(0, cap - 1)
    # floor-mod, as jnp's %: only rows with mtype_id >= 0 use it
    slot = torch.where(batch.mtype_id >= 0, batch.mtype_id % m, 0)
    flat = (ids_safe * m + slot).to(torch.int64)
    prev_ts = state.last_value_ts_s.reshape(-1)[flat]
    prev_ns = state.last_value_ts_ns.reshape(-1)[flat]
    prev_v = state.last_values.reshape(-1)[flat]
    ewma_prev = state.ewma_values.reshape(-1, state.num_ewma_scales)[flat]
    return prev_ts, prev_ns, prev_v, ewma_prev


def _gap_s(prev_ts, prev_ns, ts_s, ts_ns) -> torch.Tensor:
    """Seconds since the previous sample, sub-second resolution, >= 0."""
    return ((ts_s - prev_ts).to(torch.float32)
            + (ts_ns - prev_ns).to(torch.float32) * 1e-9).clamp_min(0.0)


def fold_ewma_arrays(
    prev_ts: torch.Tensor,
    prev_ns: torch.Tensor,
    ewma_prev: torch.Tensor,
    ts_s: torch.Tensor,
    ts_ns: torch.Tensor,
    value: torch.Tensor,
    taus: torch.Tensor,
) -> torch.Tensor:
    """Irregular-sampling EWMA fold: ``alpha = 1 - exp(-dt / tau)``; the
    first sample seeds the average.  Returns ``float32[B, K]``."""
    seeded = prev_ts > 0
    dt = _gap_s(prev_ts, prev_ns, ts_s, ts_ns)
    alpha = 1.0 - torch.exp(-dt[:, None] / taus[None, :].clamp_min(1e-9))
    v = value[:, None]
    return torch.where(seeded[:, None], ewma_prev + alpha * (v - ewma_prev), v)


def fold_ewma(state: DeviceState, batch: EventBatch,
              taus: torch.Tensor) -> torch.Tensor:
    """Per-row candidate EWMAs after folding this row's sample."""
    prev_ts, prev_ns, _, ewma_prev = _gather_meas_state(state, batch)
    return fold_ewma_arrays(prev_ts, prev_ns, ewma_prev,
                            batch.ts_s, batch.ts_ns, batch.value, taus)


def compare_select(op: torch.Tensor, val: torch.Tensor,
                   thr: torch.Tensor) -> torch.Tensor:
    """Data-driven :class:`ComparisonOp` dispatch; an unknown op compares
    as NEQ (``jnp.select``'s default)."""
    out = val != thr
    for code, hit in ((ComparisonOp.EQ, val == thr),
                      (ComparisonOp.LTE, val <= thr),
                      (ComparisonOp.GTE, val >= thr),
                      (ComparisonOp.LT, val < thr),
                      (ComparisonOp.GT, val > thr)):
        out = torch.where(op == code, hit, out)
    return out


def _first_firing(fired: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(fired_any, lowest firing column or NULL_ID)`` of ``bool[B, N]``.
    ``argmax`` returns the first maximum; CUDA's takes no bool, so cast."""
    fired_any = fired.any(dim=1)
    first = _i32(torch.argmax(fired.to(torch.uint8), dim=1))
    return fired_any, _null_unless(fired_any, first)


def eval_threshold_rules(
    rules: RuleTable, state: DeviceState, batch: EventBatch,
    accepted: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense ``[B, R]`` rule evaluation over measurement events:
    ``(fired_any, first_rule_id, ewma_candidates[B, K])``."""
    is_meas = accepted & (batch.event_type == EventType.MEASUREMENT)
    v = batch.value

    prev_ts, prev_ns, prev_v, ewma_prev = _gather_meas_state(state, batch)
    seeded = prev_ts > 0
    dt = _gap_s(prev_ts, prev_ns, batch.ts_s, batch.ts_ns)
    rate_valid = seeded & (dt > 0)
    rate = torch.where(rate_valid, (v - prev_v) / dt.clamp_min(1e-9), 0.0)

    ewma_new = fold_ewma_arrays(prev_ts, prev_ns, ewma_prev, batch.ts_s,
                                batch.ts_ns, v, rules.ewma_tau_s)  # [B, K]
    # The reference picks each rule's time-scale with a one-hot matmul at
    # HIGHEST precision; an index gather is the exact form of that pick.
    widx = rules.window_idx.clamp(0, rules.num_ewma_scales - 1).to(torch.int64)
    e_sel = ewma_new.index_select(1, widx)  # [B, R]

    kind = rules.kind[None, :]
    val = torch.where(
        kind == RuleKind.INSTANT, v[:, None],
        torch.where(kind == RuleKind.WINDOW_MEAN, e_sel, rate[:, None]))
    # a rate rule needs a previous sample with a positive gap
    kind_ok = (kind != RuleKind.RATE_PER_S) | rate_valid[:, None]
    hit = compare_select(rules.op[None, :], val, rules.threshold[None, :])

    tenant_ok = (rules.tenant_id[None, :] == NULL_ID) | (
        rules.tenant_id[None, :] == batch.tenant_id[:, None])
    mtype_ok = (rules.mtype_id[None, :] == NULL_ID) | (
        rules.mtype_id[None, :] == batch.mtype_id[:, None])
    fired = (hit & kind_ok & tenant_ok & mtype_ok
             & rules.active[None, :] & is_meas[:, None])
    fired_any, first = _first_firing(fired)
    return fired_any, first, ewma_new


def eval_zone_rules(
    zones: ZoneTable, batch: EventBatch, accepted: torch.Tensor,
    area_id: torch.Tensor, geofence: GeofenceFn = points_in_polygons_auto,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Geofence evaluation over location events: ``(fired_any,
    first_zone_id)``.  ``geofence`` is the containment test; the step's
    is the kernel on the card (``chip_smoke.py`` passes the plain version
    to rerun a ring against it)."""
    is_loc = accepted & (batch.event_type == EventType.LOCATION)
    pts = torch.stack([batch.lon, batch.lat], dim=-1)  # (x, y)
    inside = geofence(pts, zones.verts)  # [B, Z]

    tenant_ok = (zones.tenant_id[None, :] == NULL_ID) | (
        zones.tenant_id[None, :] == batch.tenant_id[:, None])
    area_ok = (zones.area_id[None, :] == NULL_ID) | (
        zones.area_id[None, :] == area_id[:, None])
    applies = zones.active[None, :] & tenant_ok & area_ok & is_loc[:, None]
    cond_inside = zones.condition[None, :] == ZoneCondition.ALERT_IF_INSIDE
    fired = applies & torch.where(cond_inside, inside, ~inside)
    return _first_firing(fired)


def default_taus(k: int, device: torch.device) -> torch.Tensor:
    """The default EWMA time-scales, repeated or cut to ``k``."""
    base = list(DEFAULT_EWMA_TAUS)
    return torch.tensor((base + [base[-1]] * k)[:k], dtype=torch.float32,
                        device=device)


def update_device_state(
    state: DeviceState, batch: EventBatch, accepted: torch.Tensor,
    ewma_candidates: Optional[torch.Tensor] = None,
) -> Tuple[DeviceState, torch.Tensor]:
    """Merge accepted events into last-known state (newest-wins per
    family): ``(new_state, present_now bool[capacity])``.  Rows with
    ``update_state=False`` never merge and never mark a device present."""
    ids = batch.device_id
    accepted = accepted & batch.update_state
    m = state.num_mtype_slots
    cap = state.capacity
    is_loc = accepted & (batch.event_type == EventType.LOCATION)
    is_alert = accepted & (batch.event_type == EventType.ALERT)
    # unknown measurement types (NULL_ID) are dropped, not aliased to slot 0
    is_meas = accepted & (batch.event_type == EventType.MEASUREMENT) & (
        batch.mtype_id >= 0)
    flat_ids = ids * m + batch.mtype_id % m
    ts_s, ts_ns = batch.ts_s, batch.ts_ns
    any_rows = winner_rows(ids, ts_s, ts_ns, accepted, cap)
    loc_rows = winner_rows(ids, ts_s, ts_ns, is_loc, cap)
    alert_rows = winner_rows(ids, ts_s, ts_ns, is_alert, cap)
    meas_rows = winner_rows(flat_ids, ts_s, ts_ns, is_meas, cap * m)

    new_s, new_ns, (new_type,) = apply_winners(
        any_rows, state.last_event_ts_s, state.last_event_ts_ns,
        (state.last_event_type,), ts_s, ts_ns, (batch.event_type,))
    present_now = any_rows >= 0
    presence = state.presence_missing & ~present_now

    loc_s, loc_ns, (lat, lon, elev) = apply_winners(
        loc_rows, state.last_location_ts_s, state.last_location_ts_ns,
        (state.last_lat, state.last_lon, state.last_elevation),
        ts_s, ts_ns, (batch.lat, batch.lon, batch.elevation))

    alert_s, alert_ns, (alert_code,) = apply_winners(
        alert_rows, state.last_alert_ts_s, state.last_alert_ts_ns,
        (state.last_alert_code,), ts_s, ts_ns, (batch.alert_code,))

    if ewma_candidates is None:
        ewma_candidates = fold_ewma(
            state, batch, default_taus(state.num_ewma_scales, ids.device))
    k = state.num_ewma_scales
    val_s, val_ns, (values, ewma) = apply_winners(
        meas_rows,
        state.last_value_ts_s.reshape(-1),
        state.last_value_ts_ns.reshape(-1),
        (state.last_values.reshape(-1), state.ewma_values.reshape(-1, k)),
        ts_s, ts_ns, (batch.value, ewma_candidates))

    mshape = state.last_value_ts_s.shape
    new_state = state.replace(
        last_event_ts_s=new_s,
        last_event_ts_ns=new_ns,
        last_event_type=new_type,
        presence_missing=presence,
        last_location_ts_s=loc_s,
        last_location_ts_ns=loc_ns,
        last_lat=lat,
        last_lon=lon,
        last_elevation=elev,
        last_alert_ts_s=alert_s,
        last_alert_ts_ns=alert_ns,
        last_alert_code=alert_code,
        last_value_ts_s=val_s.reshape(mshape),
        last_value_ts_ns=val_ns.reshape(mshape),
        last_values=values.reshape(mshape),
        ewma_values=ewma.reshape(state.ewma_values.shape),
    )
    return new_state, present_now


def _build_derived_alerts(
    batch: EventBatch,
    rules: RuleTable,
    zones: ZoneTable,
    rule_id: torch.Tensor,
    zone_id: torch.Tensor,
) -> EventBatch:
    """Alert events fired by rules, ready for re-injection; a zone alert
    takes priority over a threshold alert on the same source event."""
    zone_fired = zone_id != NULL_ID
    fired = (rule_id != NULL_ID) | zone_fired
    safe_rule = rule_id.clamp(0, rules.capacity - 1).to(torch.int64)
    safe_zone = zone_id.clamp(0, zones.capacity - 1).to(torch.int64)
    code = torch.where(zone_fired, zones.alert_code[safe_zone],
                       rules.alert_code[safe_rule])
    level = torch.where(zone_fired, zones.alert_level[safe_zone],
                        rules.alert_level[safe_rule])
    empty = EventBatch.empty(batch.width, device=batch.valid.device)
    return empty.replace(
        valid=fired,
        device_id=_null_unless(fired, batch.device_id),
        tenant_id=_null_unless(fired, batch.tenant_id),
        event_type=torch.full_like(batch.event_type, int(EventType.ALERT)),
        ts_s=batch.ts_s,
        ts_ns=batch.ts_ns,
        alert_code=_null_unless(fired, code),
        alert_level=torch.where(fired, level, 0),
        payload_ref=batch.payload_ref,
        update_state=torch.zeros_like(fired),
    )


def pipeline_step(
    registry: Registry,
    state: DeviceState,
    rules: RuleTable,
    zones: ZoneTable,
    batch: EventBatch,
    geofence: GeofenceFn = points_in_polygons_auto,
) -> Tuple[DeviceState, PipelineOutputs]:
    """The fused inbound step: ``(new_state, outputs)``."""
    accepted, unregistered, unassigned, enrich = validate_and_enrich(
        registry, batch)
    # Numeric integrity: NaN/Inf rows still persist (accepted stays raw)
    # but are masked out of rules and state.
    finite = (torch.isfinite(batch.value) & torch.isfinite(batch.lat)
              & torch.isfinite(batch.lon) & torch.isfinite(batch.elevation))
    nonfinite = batch.valid & ~finite
    clean = accepted & finite
    rule_fired, rule_id, ewma_candidates = eval_threshold_rules(
        rules, state, batch, clean)
    zone_fired, zone_id = eval_zone_rules(
        zones, batch, clean, enrich["area_id"], geofence)
    new_state, present_now = update_device_state(
        state, batch, clean, ewma_candidates)
    # per-device NaN/Inf strikes: one scatter-add with a dump slot
    cap = state.capacity
    ids = batch.device_id
    nf_idx = torch.where(nonfinite & (ids >= 0) & (ids < cap), ids, cap)
    nf = torch.cat([new_state.nonfinite_count,
                    new_state.nonfinite_count.new_zeros(1)])
    nf = nf.index_add(0, nf_idx.to(torch.int64),
                      torch.ones_like(nf_idx))[:cap]
    new_state = new_state.replace(nonfinite_count=nf)
    derived = _build_derived_alerts(batch, rules, zones, rule_id, zone_id)

    metrics = StepMetrics(
        processed=_i32(batch.valid.sum()),
        accepted=_i32(accepted.sum()),
        unregistered=_i32(unregistered.sum()),
        unassigned=_i32(unassigned.sum()),
        threshold_alerts=_i32(rule_fired.sum()),
        zone_alerts=_i32(zone_fired.sum()),
        by_type=bincount_fixed(batch.event_type, accepted, NUM_EVENT_TYPES),
    )
    outputs = PipelineOutputs(
        accepted=accepted,
        unregistered=unregistered,
        unassigned=unassigned,
        nonfinite=nonfinite,
        rule_id=rule_id,
        zone_id=zone_id,
        present_now=present_now,
        derived_alerts=derived,
        metrics=metrics,
        **enrich,
    )
    return new_state, outputs
