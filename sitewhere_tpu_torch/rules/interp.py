"""Reference interpreter: the golden semantics for rule programs.

The port's own copy of ``sitewhere_tpu/rules/interp.py`` (numpy only).
Nothing on the live path calls it: the tests and the card-side checks of
``chip_smoke.py`` hold the torch passes against it.

Slow, obvious numpy — one program, one row, one predicate at a time.
``rules/compile.py`` is REQUIRED to agree with this module bit-for-bit
on fired alerts and enrichment values (the tier-1 golden-equivalence
tests drive both over the same random program/event streams, including
the mesh-sharded prepare path), so every semantic question about the
DSL is answered HERE, in straight-line code:

- float predicates (value / ewma / rate) apply only to MEASUREMENT rows
  and honor the optional mtype filter; rate additionally needs a seeded
  previous sample with positive dt;
- the trailing state folds with the irregular-sampling EWMA
  (``alpha = 1 - exp(-dt/tau)``, float32 throughout) and each
  (device, mtype-slot) stores the batch's newest-(ts_s, ts_ns) row,
  highest batch row winning exact ties — the ``scatter_last_by_time``
  contract;
- geo predicates apply to LOCATION rows; containment uses the same
  slope-first ray-crossing arithmetic as ``ops/geo``;
- attr predicates join the device/asset attribute tables; unset
  attributes (NULL_ID) never match;
- ALERT rows are never evaluated (re-injection loop guard);
- a clause of nothing but padding never fires.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from sitewhere_tpu_torch.ids import NULL_ID
from sitewhere_tpu_torch.rules.dsl import (
    ATTR_TABLE_ASSET,
    CanonicalPred,
    CanonicalProgram,
    PK_ATTR,
    PK_EVENT_TYPE,
    PK_EWMA,
    PK_GEO,
    PK_PAD,
    PK_RATE,
    PK_VALUE,
)
from sitewhere_tpu_torch.schema import ComparisonOp, EventType


class InterpTrail:
    """Host mirror of the engine's trailing per-(device, slot) state."""

    def __init__(self, capacity: int, n_mtype_slots: int, n_scales: int):
        self.D = int(capacity)
        self.M = int(n_mtype_slots)
        self.K = int(n_scales)
        self.ts_s = np.zeros((self.D, self.M), np.int32)
        self.ts_ns = np.zeros((self.D, self.M), np.int32)
        self.value = np.zeros((self.D, self.M), np.float32)
        self.ewma = np.zeros((self.D, self.M, self.K), np.float32)


def _compare(op: int, val, thr) -> bool:
    if op == ComparisonOp.GT:
        return bool(val > thr)
    if op == ComparisonOp.LT:
        return bool(val < thr)
    if op == ComparisonOp.GTE:
        return bool(val >= thr)
    if op == ComparisonOp.LTE:
        return bool(val <= thr)
    if op == ComparisonOp.EQ:
        return bool(val == thr)
    return bool(val != thr)


def _point_in_polygon(px: float, py: float, ring) -> bool:
    verts = np.asarray(ring, np.float32)
    if len(verts) < 8:  # mirror the pool's pad-with-last-vertex contract
        pad = np.repeat(verts[-1:], 8 - len(verts), axis=0)
        verts = np.concatenate([verts, pad])
    crossings = 0
    V = len(verts)
    for i in range(V):
        x1, y1 = np.float32(verts[i][0]), np.float32(verts[i][1])
        x2, y2 = (np.float32(verts[(i + 1) % V][0]),
                  np.float32(verts[(i + 1) % V][1]))
        straddles = (y1 > py) != (y2 > py)
        denom = np.float32(1.0) if y2 == y1 else y2 - y1
        slope = (x2 - x1) / denom
        x_cross = slope * (np.float32(py) - y1) + x1
        if straddles and np.float32(px) < x_cross:
            crossings += 1
    return crossings % 2 == 1


def interp_features(
    trail: InterpTrail,
    cols: Dict[str, np.ndarray],
    taus: Sequence[float],
    dev_attr: np.ndarray,
    asset_attr: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Per-row features for one batch + in-place trail update.

    Mirrors ``rules_prepare_batch``: fold every row against the
    PRE-batch trail, then store each slot's winner.  All float math in
    float32."""
    B = len(cols["device_id"])
    K = trail.K
    taus32 = np.asarray(taus, np.float32)
    accepted = np.asarray(cols.get("accepted",
                                   np.ones(B, bool))).astype(bool)
    ewma_new = np.zeros((B, K), np.float32)
    rate = np.zeros(B, np.float32)
    rate_valid = np.zeros(B, bool)
    da = np.full((B, dev_attr.shape[1]), NULL_ID, np.int32)
    aa = np.full((B, asset_attr.shape[1]), NULL_ID, np.int32)

    for b in range(B):
        did = int(cols["device_id"][b])
        mt = int(cols["mtype_id"][b])
        slot = mt % trail.M if mt >= 0 else 0
        d = min(max(did, 0), trail.D - 1)
        prev_ts = np.int32(trail.ts_s[d, slot])
        prev_ns = np.int32(trail.ts_ns[d, slot])
        prev_v = np.float32(trail.value[d, slot])
        seeded = prev_ts > 0
        dt = np.float32(max(
            np.float32(np.int32(cols["ts_s"][b]) - prev_ts)
            + np.float32(np.int32(cols["ts_ns"][b]) - prev_ns)
            * np.float32(1e-9), np.float32(0.0)))
        v = np.float32(cols["value"][b])
        is_meas = (accepted[b]
                   and int(cols["event_type"][b]) == EventType.MEASUREMENT)
        if seeded:
            alpha = np.float32(1.0) - np.exp(
                -dt / np.maximum(taus32, np.float32(1e-9)))
            ewma_new[b] = trail.ewma[d, slot] + alpha * (
                v - trail.ewma[d, slot])
        else:
            ewma_new[b] = v
        if seeded and dt > 0 and is_meas:
            rate_valid[b] = True
            rate[b] = (v - prev_v) / np.maximum(dt, np.float32(1e-9))
        if 0 <= did < dev_attr.shape[0]:
            da[b] = dev_attr[did]
        aid = int(cols.get("asset_id", np.full(B, NULL_ID))[b])
        if 0 <= aid < asset_attr.shape[0]:
            aa[b] = asset_attr[aid]

    # winner scatter: newest (ts_s, ts_ns), highest row on ties, events
    # winning exact ties against the stored slot key
    winners: Dict[Tuple[int, int], int] = {}
    for b in range(B):
        did = int(cols["device_id"][b])
        mt = int(cols["mtype_id"][b])
        is_meas = (accepted[b]
                   and int(cols["event_type"][b]) == EventType.MEASUREMENT)
        if not is_meas or not (0 <= did < trail.D):
            continue
        slot = mt % trail.M if mt >= 0 else 0
        key = (did, slot)
        cur = winners.get(key)
        if cur is None or (
                (int(cols["ts_s"][b]), int(cols["ts_ns"][b]), b)
                >= (int(cols["ts_s"][cur]), int(cols["ts_ns"][cur]), cur)):
            winners[key] = b
    for (did, slot), b in winners.items():
        w_s, w_ns = int(cols["ts_s"][b]), int(cols["ts_ns"][b])
        if (w_s, w_ns) >= (int(trail.ts_s[did, slot]),
                           int(trail.ts_ns[did, slot])):
            trail.ts_s[did, slot] = w_s
            trail.ts_ns[did, slot] = w_ns
            trail.value[did, slot] = np.float32(cols["value"][b])
            trail.ewma[did, slot] = ewma_new[b]

    return {"ewma": ewma_new, "rate": rate, "rate_valid": rate_valid,
            "dev_attr": da, "asset_attr": aa}


def _eval_pred(pred: CanonicalPred, b: int, cols, feats) -> bool:
    et = int(cols["event_type"][b])
    if pred.kind == PK_PAD:
        return True
    if pred.kind in (PK_VALUE, PK_EWMA, PK_RATE):
        if et != EventType.MEASUREMENT:
            return False
        if pred.i0 != NULL_ID and pred.i0 != int(cols["mtype_id"][b]):
            return False
        if pred.kind == PK_VALUE:
            val = np.float32(cols["value"][b])
        elif pred.kind == PK_EWMA:
            val = np.float32(feats["ewma"][b, pred.i1])
        else:
            if not feats["rate_valid"][b]:
                return False
            val = np.float32(feats["rate"][b])
        return _compare(pred.op, val, np.float32(pred.f0))
    if pred.kind == PK_GEO:
        if et != EventType.LOCATION:
            return False
        inside = _point_in_polygon(float(cols["lon"][b]),
                                   float(cols["lat"][b]), pred.polygon)
        return inside if pred.i0 == 1 else not inside
    if pred.kind == PK_ATTR:
        attrs = (feats["asset_attr"] if pred.i2 == ATTR_TABLE_ASSET
                 else feats["dev_attr"])
        val = int(attrs[b, pred.i1])
        if val == NULL_ID:
            return False
        return _compare(pred.op, val, pred.i0)
    # PK_EVENT_TYPE
    return _compare(pred.op, et, pred.i0)


def interp_eval(
    programs: Sequence[Tuple[int, CanonicalProgram, int]],
    cols: Dict[str, np.ndarray],
    feats: Dict[str, np.ndarray],
) -> List[Tuple[int, str, int, int]]:
    """Evaluate ``(tenant_dense, program, alert_code)`` triples over one
    prepared batch.  Returns fired ``(row, token, alert_code,
    alert_level)`` tuples in (row, token) order."""
    B = len(cols["device_id"])
    accepted = np.asarray(cols.get("accepted",
                                   np.ones(B, bool))).astype(bool)
    out: List[Tuple[int, str, int, int]] = []
    for b in range(B):
        if not accepted[b]:
            continue
        if int(cols["event_type"][b]) == EventType.ALERT:
            continue
        tid = int(cols["tenant_id"][b])
        for tenant, prog, code in programs:
            if tenant != tid:
                continue
            fired = any(
                all(_eval_pred(p, b, cols, feats) for p in clause)
                for clause in prog.clauses if clause)
            if fired:
                out.append((b, prog.token, code, prog.alert_level))
    out.sort(key=lambda t: (t[0], t[1]))
    return out


__all__ = ["InterpTrail", "interp_features", "interp_eval"]
