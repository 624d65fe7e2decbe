"""Plain reference of the served path, for a sample of devices.

What the dispatcher, its packed step and its egress must deliver to the
sink, worked out again in NumPy (and plain PyTorch for the geofence) from
the world and the rows the benchmark generated.  The semantics are
SiteWhere's inbound processing and rule processors as the port states
them:

1. A row is accepted when its device is registered, of the row's tenant
   and assigned (ACTIVE); accepted rows are stored with the device's
   type, assignment, area, customer and asset.
2. A row with a non-finite value or coordinate is stored but reaches
   neither the rules nor the state.
3. Threshold rules over measurement rows, ``[row, rule]``: the value
   (INSTANT), the EWMA of the rule's time-scale (WINDOW_MEAN: ``alpha =
   1 - exp(-dt / tau)``, the first sample seeds it) or the rate ``(v -
   prev) / dt`` (RATE_PER_S: only with a previous sample and ``dt > 0``);
   the lowest firing rule.
4. Zone rules over location rows: ray-crossing containment (a frozen copy
   of ``sitewhere_tpu_torch/ops/geo.py:42``), the lowest firing zone.
5. Device state, newest ``(ts_s, ts_ns)`` wins per device (per device and
   measurement slot for values and EWMAs), the later row on ties, and an
   event at least as new as the state replaces it.  Every row of one
   batch reads the state as it was before that batch, so which rows share
   a batch matters: the plans' row ranges are an input.
6. A firing row yields one derived ALERT row (a zone's over a rule's),
   stored with the source's event time and ``payload_ref``; it never
   touches state.
7. A device whose non-finite rows reach ``QUARANTINE_AFTER`` gets one
   STATE_CHANGE row.

``precision="bfloat16"`` rounds every floating input and every operation's
result to bfloat16: the control that the comparison must reject.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

NULL_ID = -1
MEASUREMENT, LOCATION, ALERT = 0, 1, 2
ASSIGNMENT_ACTIVE = 1
KIND_INSTANT, KIND_WINDOW_MEAN, KIND_RATE = 0, 1, 2
ZONE_INSIDE = 0
QUARANTINE_AFTER = 3
ENRICHMENT = ("device_type_id", "assignment_id", "area_id", "customer_id",
              "asset_id")


@dataclasses.dataclass
class Outcome:
    """What reached the sink for the sampled devices, and their state."""

    stored_refs: np.ndarray     # int64: stored stream rows (refs)
    alerts: np.ndarray          # int64 [n, 5]: ref, code, level, ts_s, ts_ns
    state_changes: np.ndarray   # int64 [S]: STATE_CHANGE rows stored
    state: Dict[str, np.ndarray]  # DeviceState fields, sampled rows


def to_bfloat16(x) -> np.ndarray:
    """float32 rounded to the nearest bfloat16 (ties to even), as float32."""
    x = np.asarray(x, np.float32)
    u = x.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return np.where(np.isnan(x), x, r.view(np.float32))


def _rounder(precision: str):
    if precision == "float32":
        return lambda x: np.asarray(x, np.float32)
    if precision == "bfloat16":
        return to_bfloat16
    raise ValueError(f"unknown precision {precision!r}")


# -- the geofence (frozen copy of sitewhere_tpu_torch/ops/geo.py:34-62) ------


def guarded_slope(x1, y1, x2, y2):
    denom = torch.where(y2 == y1, torch.ones_like(y1), y2 - y1)
    return (x2 - x1) / denom


def points_in_polygons(points: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """``bool[B, Z]`` ray-crossing containment of ``points`` ``[B, 2]`` (x,
    y) in the padded rings ``verts`` ``[Z, V, 2]``; the crossing abscissa
    is rounded after the multiply and after the add."""
    px = points[:, 0][:, None, None]
    py = points[:, 1][:, None, None]
    x1 = verts[None, :, :, 0]
    y1 = verts[None, :, :, 1]
    x2 = torch.roll(verts[:, :, 0], -1, dims=-1)[None]
    y2 = torch.roll(verts[:, :, 1], -1, dims=-1)[None]
    straddles = (y1 > py) != (y2 > py)
    slope = guarded_slope(x1, y1, x2, y2)
    x_cross = slope * (py - y1) + x1
    crossing = straddles & (px < x_cross)
    return (crossing.to(torch.int32).sum(dim=-1) % 2) == 1


def first_zone(points: np.ndarray, tenant: np.ndarray, area: np.ndarray,
               zones: Dict[str, np.ndarray], precision: str,
               device="cpu") -> np.ndarray:
    """The lowest firing zone of each point, or NULL_ID."""
    n = points.shape[0]
    out = np.full(n, NULL_ID, np.int64)
    if n == 0:
        return out
    dtype = torch.float32 if precision == "float32" else torch.bfloat16
    verts = torch.as_tensor(zones["verts"]).to(device=device, dtype=dtype)
    z_count, v_count = verts.shape[0], verts.shape[1]
    zt = torch.as_tensor(zones["tenant_id"], device=device)
    za = torch.as_tensor(zones["area_id"], device=device)
    active = torch.as_tensor(zones["active"], device=device)
    inside_cond = torch.as_tensor(zones["condition"], device=device) == ZONE_INSIDE
    chunk = max(1, (1 << 26) // (z_count * v_count))
    for a in range(0, n, chunk):
        p = torch.as_tensor(points[a:a + chunk]).to(device=device, dtype=dtype)
        t = torch.as_tensor(tenant[a:a + chunk], device=device)
        ar = torch.as_tensor(area[a:a + chunk], device=device)
        inside = points_in_polygons(p, verts)
        applies = (active[None, :]
                   & ((zt[None, :] == NULL_ID) | (zt[None, :] == t[:, None]))
                   & ((za[None, :] == NULL_ID) | (za[None, :] == ar[:, None])))
        fired = applies & torch.where(inside_cond[None, :], inside, ~inside)
        hit = fired.any(dim=1)
        first = torch.argmax(fired.to(torch.uint8), dim=1)
        out[a:a + chunk] = torch.where(hit, first, NULL_ID).cpu().numpy()
    return out


# -- state -------------------------------------------------------------------


def empty_state(s: int, m: int, k: int) -> Dict[str, np.ndarray]:
    """The initial state of ``s`` devices (the port's ``DeviceState.empty``
    values)."""
    z = lambda *shape: np.zeros(shape, np.int64)  # noqa: E731
    return dict(
        last_event_ts_s=z(s), last_event_ts_ns=z(s),
        last_event_type=np.full(s, NULL_ID, np.int64),
        last_values=np.zeros((s, m), np.float32),
        last_value_ts_s=z(s, m), last_value_ts_ns=z(s, m),
        last_lat=np.zeros(s, np.float32), last_lon=np.zeros(s, np.float32),
        last_elevation=np.zeros(s, np.float32),
        last_location_ts_s=z(s), last_location_ts_ns=z(s),
        last_alert_code=np.full(s, NULL_ID, np.int64),
        last_alert_ts_s=z(s), last_alert_ts_ns=z(s),
        presence_missing=np.zeros(s, bool),
        ewma_values=np.zeros((s, m, k), np.float32),
        nonfinite_count=z(s),
    )


def _winners(key, ts_s, ts_ns, ref, rows):
    """Per distinct ``key`` among ``rows``: the row with the newest
    ``(ts_s, ts_ns)``, the later stream row on ties: ``(keys, rows)``."""
    if rows.size == 0:
        return rows, rows
    order = np.lexsort((ref[rows], ts_ns[rows], ts_s[rows], key[rows]))
    s = rows[order]
    k = key[s]
    last = np.ones(s.size, bool)
    last[:-1] = k[1:] != k[:-1]
    return k[last], s[last]


def _newer(w_s, w_ns, cur_s, cur_ns):
    return (w_s > cur_s) | ((w_s == cur_s) & (w_ns >= cur_ns))


def _compare(op, val, thr):
    out = val != thr                       # NEQ and unknown codes
    for code, hit in ((4, val == thr), (3, val <= thr), (2, val >= thr),
                      (1, val < thr), (0, val > thr)):
        out = np.where(op == code, hit, out)
    return out


def outcome(world: Dict, rows: Dict[str, np.ndarray], sample: np.ndarray,
            plans: np.ndarray, mtype_slots: int, precision: str = "float32",
            zone_device="cpu", ambiguity: float = 0.0
            ) -> Tuple[Outcome, np.ndarray]:
    """The reference outcome for the sampled devices ``sample`` (sorted
    handles), given their rows in stream order (``rows``, with ``ref``)
    and the plans' stream-row ranges ``plans`` ``[P, 2]`` (first, last) in
    the order they were stepped.  Also returns the refs of rows whose
    threshold-rule decision lies within ``ambiguity`` of a WINDOW_MEAN
    threshold, which the comparison leaves out."""
    f = _rounder(precision)
    reg, rules, zones = world["registry"], world["rules"], world["zones"]
    cap = reg["active"].shape[0]
    m, k = mtype_slots, rules["ewma_tau_s"].shape[0]
    s_count = sample.size
    dev = rows["device_id"].astype(np.int64)
    c = np.searchsorted(sample, dev)
    ref = rows["ref"].astype(np.int64)
    et = rows["event_type"]
    ts_s = rows["ts_s"].astype(np.int64)
    ts_ns = rows["ts_ns"].astype(np.int64)
    mt = rows["mtype_id"].astype(np.int64)
    v, lat, lon, elev = (f(rows[n]) for n in ("value", "lat", "lon",
                                               "elevation"))
    tenant = np.zeros(dev.size, np.int64)   # every row in the default tenant

    in_range = (dev >= 0) & (dev < cap)
    safe = np.clip(dev, 0, cap - 1)
    accepted = (in_range & reg["active"][safe]
                & (reg["tenant_id"][safe] == tenant)
                & (reg["assignment_status"][safe] == ASSIGNMENT_ACTIVE))
    finite = (np.isfinite(v) & np.isfinite(lat) & np.isfinite(lon)
              & np.isfinite(elev))
    clean = accepted & finite
    area = np.where(accepted, reg["area_id"][safe], NULL_ID)

    # zone rules: stateless, all location rows at once
    zone_id = np.full(dev.size, NULL_ID, np.int64)
    loc = np.nonzero(clean & (et == LOCATION))[0]
    zone_id[loc] = first_zone(np.stack([lon[loc], lat[loc]], axis=-1),
                              tenant[loc], area[loc], zones, precision,
                              zone_device)

    r_active = rules["active"]
    r_tenant, r_mtype = rules["tenant_id"], rules["mtype_id"]
    r_op, r_kind = rules["op"], rules["kind"]
    r_thr = f(rules["threshold"])
    r_widx = np.clip(rules["window_idx"], 0, k - 1)
    taus = f(np.maximum(rules["ewma_tau_s"], np.float32(1e-9)))
    rule_id = np.full(dev.size, NULL_ID, np.int64)
    ambiguous = np.zeros(dev.size, bool)

    st = empty_state(s_count, m, k)
    slot = np.where(mt >= 0, mt % m, 0)
    bounds = np.stack([np.searchsorted(ref, plans[:, 0], "left"),
                       np.searchsorted(ref, plans[:, 1], "right")], axis=1)
    for a, b in bounds:
        if a == b:
            continue
        span = np.arange(a, b)
        # threshold rules over the plan's clean measurement rows, from the
        # state before the plan
        meas = span[clean[span] & (et[span] == MEASUREMENT)]
        cand_ewma = None
        if meas.size:
            cm, sm = c[meas], slot[meas]
            prev_ts = st["last_value_ts_s"][cm, sm]
            prev_ns = st["last_value_ts_ns"][cm, sm]
            prev_v = st["last_values"][cm, sm]
            prev_e = st["ewma_values"][cm, sm]
            vm = v[meas]
            seeded = prev_ts > 0
            dt = f(f((ts_s[meas] - prev_ts).astype(np.float32))
                   + f(f((ts_ns[meas] - prev_ns).astype(np.float32))
                       * np.float32(1e-9)))
            dt = np.maximum(dt, np.float32(0.0))
            rate_valid = seeded & (dt > 0)
            rate = np.where(rate_valid,
                            f(f(vm - prev_v) / np.maximum(dt, np.float32(1e-9))),
                            np.float32(0.0))
            alpha = f(np.float32(1.0) - f(np.exp(f(-dt[:, None] / taus[None, :]))))
            cand_ewma = np.where(
                seeded[:, None],
                f(prev_e + f(alpha * f(vm[:, None] - prev_e))), vm[:, None])
            e_sel = cand_ewma[:, r_widx]
            kind = r_kind[None, :]
            val = np.where(kind == KIND_INSTANT, vm[:, None],
                           np.where(kind == KIND_WINDOW_MEAN, e_sel,
                                    rate[:, None]))
            kind_ok = (kind != KIND_RATE) | rate_valid[:, None]
            applies = (((r_tenant[None, :] == NULL_ID)
                        | (r_tenant[None, :] == tenant[meas][:, None]))
                       & ((r_mtype[None, :] == NULL_ID)
                          | (r_mtype[None, :] == mt[meas][:, None]))
                       & r_active[None, :])
            fired = (_compare(r_op[None, :], val, r_thr[None, :]) & kind_ok
                     & applies)
            hit = fired.any(axis=1)
            rule_id[meas] = np.where(hit, np.argmax(fired, axis=1), NULL_ID)
            if ambiguity > 0:
                near = (np.abs(e_sel - r_thr[None, :]) <= ambiguity) & (
                    kind == KIND_WINDOW_MEAN) & applies
                ambiguous[meas] = near.any(axis=1)

        # state merges, newest wins
        upd = span[clean[span]]
        keys, win = _winners(c, ts_s, ts_ns, ref, upd)
        new = _newer(ts_s[win], ts_ns[win], st["last_event_ts_s"][keys],
                     st["last_event_ts_ns"][keys])
        kk, ww = keys[new], win[new]
        st["last_event_ts_s"][kk] = ts_s[ww]
        st["last_event_ts_ns"][kk] = ts_ns[ww]
        st["last_event_type"][kk] = et[ww]
        st["presence_missing"][keys] = False

        keys, win = _winners(c, ts_s, ts_ns, ref, upd[et[upd] == LOCATION])
        new = _newer(ts_s[win], ts_ns[win], st["last_location_ts_s"][keys],
                     st["last_location_ts_ns"][keys])
        kk, ww = keys[new], win[new]
        st["last_location_ts_s"][kk] = ts_s[ww]
        st["last_location_ts_ns"][kk] = ts_ns[ww]
        st["last_lat"][kk] = lat[ww]
        st["last_lon"][kk] = lon[ww]
        st["last_elevation"][kk] = elev[ww]

        keys, win = _winners(c, ts_s, ts_ns, ref, upd[et[upd] == ALERT])
        new = _newer(ts_s[win], ts_ns[win], st["last_alert_ts_s"][keys],
                     st["last_alert_ts_ns"][keys])
        kk, ww = keys[new], win[new]
        st["last_alert_ts_s"][kk] = ts_s[ww]
        st["last_alert_ts_ns"][kk] = ts_ns[ww]
        st["last_alert_code"][kk] = rows["alert_code"][ww]

        mrows = upd[(et[upd] == MEASUREMENT) & (mt[upd] >= 0)]
        if mrows.size:
            flat = c * m + slot
            keys, win = _winners(flat, ts_s, ts_ns, ref, mrows)
            kc, ks = keys // m, keys % m
            new = _newer(ts_s[win], ts_ns[win],
                         st["last_value_ts_s"][kc, ks],
                         st["last_value_ts_ns"][kc, ks])
            kc, ks, ww = kc[new], ks[new], win[new]
            st["last_value_ts_s"][kc, ks] = ts_s[ww]
            st["last_value_ts_ns"][kc, ks] = ts_ns[ww]
            st["last_values"][kc, ks] = v[ww]
            # the winner's candidate EWMA, folded from the pre-plan state
            at = np.searchsorted(meas, ww)
            st["ewma_values"][kc, ks] = cand_ewma[at]

    # non-finite strikes and the quarantine's STATE_CHANGE rows
    bad = ~finite & in_range
    np.add.at(st["nonfinite_count"], c[bad], 1)
    s_in = (sample >= 0) & (sample < cap)
    s_safe = np.clip(sample, 0, cap - 1)
    registered = (s_in & reg["active"][s_safe] & (reg["tenant_id"][s_safe] == 0)
                  & (reg["assignment_status"][s_safe] == ASSIGNMENT_ACTIVE))
    state_changes = ((st["nonfinite_count"] >= QUARANTINE_AFTER)
                     & registered).astype(np.int64)

    # derived alerts: a zone's over a rule's
    fired_rows = np.nonzero((zone_id != NULL_ID) | (rule_id != NULL_ID))[0]
    zf = zone_id[fired_rows]
    rf = rule_id[fired_rows]
    zs = np.clip(zf, 0, None)
    rs = np.clip(rf, 0, None)
    code = np.where(zf != NULL_ID, zones["alert_code"][zs],
                    rules["alert_code"][rs])
    level = np.where(zf != NULL_ID, zones["alert_level"][zs],
                     rules["alert_level"][rs])
    alerts = np.stack([ref[fired_rows], code, level, ts_s[fired_rows],
                       ts_ns[fired_rows]], axis=1).astype(np.int64)
    out = Outcome(stored_refs=np.sort(ref[accepted]),
                  alerts=alerts.reshape(-1, 5),
                  state_changes=state_changes, state=st)
    return out, np.sort(ref[ambiguous])
