"""Declarative streaming queries compiled to one windowed operator.

Counterpart of ``sitewhere_tpu/analytics/query.py``.  A query is declared
once (:class:`WindowQuery` / :class:`SessionQuery` /
:class:`PatternQuery`), compiles to one operator, and the same operator
runs in live mode (the dispatcher's enriched batches) and retrospective
mode (sealed event-store chunks): the operator carries per-device state
(open windows, open sessions, pattern stages) between calls, so any split
of the same event sequence into batches yields the same matches.

Window semantics: tumbling windows are epoch-aligned (``ts // window_s``)
and finalize when a later window arrives for the device (or on flush);
sliding windows (``length`` > 1) combine the trailing ``length`` hops
through per-device rings of the last finalized hops.  Sessions close when
an inter-event gap exceeds ``gap_s`` (or on flush).  Patterns are
:mod:`.cep` programs.

Port notes:

- The operators sort each batch with the rows they keep first, so every
  segment is a run of sorted rows: float sums are
  ``torch.segment_reduce`` over those runs (deterministic on the card, a
  row-order sum on the CPU), and a segment's device, window, start and
  end are read at its first and last row.  The kept rows sort exactly as
  the reference sorts them; only the rows it drops sort elsewhere.
- ``mode="drop"`` scatters go through a dump slot
  (:func:`.windows.scatter_set`); the ring push keeps the reference's
  win-max pre-pass, so no live slot is written twice by one scatter.
- The reference pads each batch to a power of two to bound its jit
  recompiles; torch has none to bound, so the port evaluates the batch
  at its own length.  Padding rows are invalid and sort last, so the
  matches and the carried state are the same either way.
- A compiled query's batch ends with ONE copy to the host: the matched
  rows, compacted on the card, and (window queries) the occupancy count.
  ``copies`` counts the copies, a second one only when more rows matched
  than the compacted block held.
- The spec classes pickle under the reference's module and class names
  (:mod:`.checkpoint`), so either package restores the other's
  ``analytics`` checkpoint section.
"""

from __future__ import annotations

import copyreg
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from sitewhere_tpu_torch.analytics.cep import (
    CepProgram,
    CepState,
    PatternEvaluator,
    PatternStep,
    as_f32,
    pack_rows,
    unpack_rows,
)
from sitewhere_tpu_torch.analytics.windows import (
    AGGREGATES,
    BIG_I32,
    F32_MAX,
    INF,
    INT_MIN,
    compare,
    f32,
    scatter_set,
    segment_rows,
    segment_sum,
    sort_order,
    sqrt_rn,
)
from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.schema import ComparisonOp, EventType

_I32 = torch.int32
_F32 = torch.float32

SESSION_AGGREGATES = ("count", "duration_s")


# ---------------------------------------------------------------------------
# query specs (the REST-facing declarative layer)
# ---------------------------------------------------------------------------


def _reduce_as_reference(self):
    """Pickle as the reference's class of the same name (the class
    attribute ``_PICKLE_AS`` names it; :mod:`.checkpoint` writes it)."""
    return copyreg.__newobj__, (type(self),), dict(self.__dict__)


@dataclasses.dataclass
class WindowQuery:
    """Tumbling/sliding windowed aggregate predicate over measurements."""

    _PICKLE_AS = ("sitewhere_tpu.analytics.query", "WindowQuery")

    name: str
    threshold: float
    agg: str = "mean"
    op: int = int(ComparisonOp.GT)
    window_s: int = 300
    length: int = 1          # trailing hops; 1 = tumbling
    mtype: Optional[str] = None
    min_count: int = 1
    kind: str = "window"

    def __post_init__(self):
        if self.agg not in AGGREGATES:
            raise ValueError(f"unknown aggregate {self.agg!r}")
        if self.window_s <= 0 or self.length < 1:
            raise ValueError("window_s must be > 0 and length >= 1")

    __reduce__ = _reduce_as_reference


@dataclasses.dataclass
class SessionQuery:
    """Gap-based session predicate (count or duration)."""

    _PICKLE_AS = ("sitewhere_tpu.analytics.query", "SessionQuery")

    name: str
    threshold: float
    gap_s: int = 300
    agg: str = "count"
    op: int = int(ComparisonOp.GT)
    mtype: Optional[str] = None
    kind: str = "session"

    def __post_init__(self):
        if self.agg not in SESSION_AGGREGATES:
            raise ValueError(f"unknown session aggregate {self.agg!r}")
        if self.gap_s <= 0:
            raise ValueError("gap_s must be > 0")

    __reduce__ = _reduce_as_reference


@dataclasses.dataclass
class PatternQuery:
    """CEP pattern: ordered steps, optionally over a window-cross
    feature ("5-min mean crossed X within Y of an alert")."""

    _PICKLE_AS = ("sitewhere_tpu.analytics.query", "PatternQuery")

    name: str
    steps: List[PatternStep]
    window_s: int = 300
    cross_op: int = int(ComparisonOp.GT)
    cross_threshold: float = 0.0
    cross_mtype: Optional[str] = None
    kind: str = "pattern"

    def __post_init__(self):
        if not self.steps:
            raise ValueError("a pattern needs at least one step")

    __reduce__ = _reduce_as_reference


@dataclasses.dataclass
class QueryMatch:
    """One match, host-facing."""

    query: str
    kind: str
    device_id: int
    ts_s: int                # window/session/pattern END time
    start_ts_s: int          # window/session start, pattern first step
    value: float             # the aggregate (or final event value)
    count: int = 0

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


_EVENT_TYPE_BY_NAME = {et.name.lower(): int(et) for et in EventType}


def parse_query(doc: Dict[str, object], resolve_mtype=None) -> object:
    """One REST body -> query spec (ValueError on junk).  ``kind``
    selects the family; enum fields accept names or values;
    ``resolve_mtype`` maps a pattern step's measurement name to its
    handle."""
    doc = dict(doc)
    kind = str(doc.get("kind", "window")).lower()
    name = doc.get("name")
    if not name or not isinstance(name, str):
        raise ValueError("query needs a string 'name'")

    def _op(raw, field="op"):
        if isinstance(raw, str):
            try:
                return int(ComparisonOp[raw.upper()])
            except KeyError:
                raise ValueError(f"bad {field}: {raw!r}") from None
        try:
            return int(ComparisonOp(int(raw)))
        except (TypeError, ValueError):
            raise ValueError(f"bad {field}: {raw!r}") from None

    if kind == "window":
        return WindowQuery(
            name=name,
            threshold=float(doc.get("threshold", 0.0)),
            agg=str(doc.get("agg", "mean")).lower(),
            op=_op(doc.get("op", "gt")),
            window_s=int(doc.get("windowS", doc.get("window_s", 300))),
            length=int(doc.get("length", 1)),
            mtype=doc.get("mtype"),
            min_count=int(doc.get("minCount", doc.get("min_count", 1))),
        )
    if kind == "session":
        return SessionQuery(
            name=name,
            threshold=float(doc.get("threshold", 0.0)),
            gap_s=int(doc.get("gapS", doc.get("gap_s", 300))),
            agg=str(doc.get("agg", "count")).lower(),
            op=_op(doc.get("op", "gt")),
            mtype=doc.get("mtype"),
        )
    if kind == "pattern":
        raw_steps = doc.get("steps")
        if not isinstance(raw_steps, list) or not raw_steps:
            raise ValueError("pattern needs a non-empty 'steps' list")
        steps = []
        for s in raw_steps:
            s = dict(s)
            et = s.get("eventType", s.get("event_type", -1))
            if isinstance(et, str):
                et_i = _EVENT_TYPE_BY_NAME.get(et.lower())
                if et_i is None:
                    raise ValueError(f"bad eventType {et!r}")
            else:
                et_i = int(et)
            mtype_id = -1
            mtype = s.get("mtype")
            if mtype is not None and resolve_mtype is not None:
                mtype_id = int(resolve_mtype(str(mtype)))
            steps.append(PatternStep(
                event_type=et_i,
                mtype_id=mtype_id,
                has_value="threshold" in s,
                op=_op(s.get("op", "gt")),
                threshold=float(s.get("threshold", 0.0)),
                window_cross=bool(s.get("windowCross",
                                        s.get("window_cross", False))),
                within_s=int(s.get("withinS", s.get("within_s", 0))),
            ))
        return PatternQuery(
            name=name, steps=steps,
            window_s=int(doc.get("windowS", doc.get("window_s", 300))),
            cross_op=_op(doc.get("crossOp", doc.get("cross_op", "gt")),
                         "crossOp"),
            cross_threshold=float(doc.get(
                "crossThreshold", doc.get("cross_threshold", 0.0))),
            cross_mtype=doc.get("crossMtype", doc.get("cross_mtype")),
        )
    raise ValueError(f"unknown query kind {kind!r}")


def describe_query(spec) -> Dict[str, object]:
    """Spec -> jsonable doc (the GET shape; re-POSTable)."""
    return dataclasses.asdict(spec)


# ---------------------------------------------------------------------------
# windowed operator (tumbling + sliding)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WindowOpState:
    """Per-device open window + ring of the last L finalized hops."""

    win: torch.Tensor       # int32[D] (-1 = none open)
    cnt: torch.Tensor       # float32[D]
    sm: torch.Tensor        # float32[D]
    ssq: torch.Tensor       # float32[D]
    mn: torch.Tensor        # float32[D]
    mx: torch.Tensor        # float32[D]
    ring_win: torch.Tensor  # int32[D, L] (-1 empty slot)
    ring_cnt: torch.Tensor  # float32[D, L]
    ring_sum: torch.Tensor  # float32[D, L]
    ring_ssq: torch.Tensor  # float32[D, L]
    ring_min: torch.Tensor  # float32[D, L]
    ring_max: torch.Tensor  # float32[D, L]

    @classmethod
    def empty(cls, capacity: int, length: int,
              device: DeviceLike = None) -> "WindowOpState":
        d, l = capacity, max(1, length)
        dev = resolve_device(device)

        def full(shape, v, dt):
            return torch.full(shape, v, dtype=dt, device=dev)

        return cls(
            win=full((d,), -1, _I32), cnt=full((d,), 0.0, _F32),
            sm=full((d,), 0.0, _F32), ssq=full((d,), 0.0, _F32),
            mn=full((d,), F32_MAX, _F32), mx=full((d,), -F32_MAX, _F32),
            ring_win=full((d, l), -1, _I32),
            ring_cnt=full((d, l), 0.0, _F32),
            ring_sum=full((d, l), 0.0, _F32),
            ring_ssq=full((d, l), 0.0, _F32),
            ring_min=full((d, l), F32_MAX, _F32),
            ring_max=full((d, l), -F32_MAX, _F32))


def _agg_value(agg: str, cnt, sm, ssq, mn, mx, span_s: float):
    n = torch.clamp(cnt, min=1.0)
    if agg == "count":
        return cnt
    if agg == "sum":
        return sm
    if agg == "mean":
        return sm / n
    if agg == "min":
        return mn
    if agg == "max":
        return mx
    if agg == "std":
        # XLA:CPU fuses the reference's ``ssq/n - m*m`` into one FMA (one
        # rounding); float64 gives that rounding on the CPU and the card
        m = sm / n
        var = ((ssq / n).double() - m.double() * m.double()).to(_F32)
        return sqrt_rn(torch.clamp(var, min=0.0))
    if agg == "rate":
        # the reference's jit folds the division by its constant span into
        # a multiply by the float32 reciprocal
        return cnt * torch.reciprocal(f32(span_s, cnt.device))
    raise ValueError(f"unknown aggregate {agg!r}")


def _sorted_segments(device_id, ts_s, ok, capacity, gap=None,
                     window_s=None):
    """The batch sorted by (device, ts) with the rows the operator keeps
    (``ok`` and a device in range) first, and its segments: one per
    (device, window) (``window_s``) or per gap-closed session (``gap``).
    Returns ``(order, dev, ts, okr, win, seg, lengths, first, last,
    dev_first_row)``."""
    okin = ok & (device_id >= 0) & (device_id < capacity)
    order = sort_order(device_id, ts_s, okin)
    dev = device_id[order]
    ts = ts_s[order]
    okr = okin[order]
    n = dev.shape[0]
    idx = torch.arange(n, device=dev.device)
    prev = torch.clamp(idx - 1, min=0)
    prev_ok = torch.where(idx > 0, okr[prev], False)
    prev_dev = torch.where(prev_ok, dev[prev], -1)
    dev_first_row = okr & (~prev_ok | (prev_dev != dev))
    win = None
    if window_s is not None:
        win = torch.where(okr, torch.div(ts, int(window_s),
                                         rounding_mode="floor"), -2)
        prev_win = torch.where(prev_ok, win[prev], -2)
        split = prev_win != win
    else:
        prev_ts = torch.where(prev_ok, ts[prev], 0)
        split = ts - prev_ts > int(gap)
    boundary = okr & (~prev_ok | (prev_dev != dev) | split)
    seg, lengths, first, last = segment_rows(okr, boundary)
    return order, dev, ts, okr, win, seg, lengths, first, last, dev_first_row


def _per_segment(x, first, lengths, okr, dead, empty):
    """A per-segment int from each segment's first row: ``dead`` for the
    segment of dropped rows, ``empty`` for empty segments (the
    reference's segment-max values for both)."""
    return torch.where(lengths > 0, torch.where(okr[first], x[first], dead),
                       empty)


def window_eval(state: WindowOpState, device_id, ts_s, value, ok,
                threshold, *, window_s: int, length: int, agg: str, op: int,
                min_count: int):
    """One batch through the windowed operator.

    Returns ``(new_state, out)`` where ``out`` is a dict of per-segment
    arrays (size B): in-batch finalized-window matches plus the carried
    open windows this batch's arrivals finalized.  ``ok`` is the
    caller's row filter (measurement + mtype)."""
    n = device_id.shape[0]
    tdev = device_id.device
    capacity = state.win.shape[0]
    L = max(1, length)
    (order, dev, ts, okr, win, seg, lengths, first, last,
     dev_first_row) = _sorted_segments(device_id, ts_s, ok, capacity,
                                       window_s=window_s)
    val = value[order]
    nseg = n + 1
    ar = torch.arange(nseg, device=tdev)
    seg_cnt = torch.where(ar < n, lengths, 0).to(_F32)
    v = torch.where(okr, val, 0.0)
    seg_sum = segment_sum(v, lengths)
    seg_ssq = segment_sum(v * v, lengths)
    seg_min = torch.segment_reduce(torch.where(okr, val, F32_MAX), "min",
                                   lengths=lengths, initial=INF)
    seg_max = torch.segment_reduce(torch.where(okr, val, -F32_MAX), "max",
                                   lengths=lengths, initial=-INF)
    seg_dev = _per_segment(dev, first, lengths, okr, -1, INT_MIN)
    seg_win = _per_segment(win, first, lengths, okr, -2, INT_MIN)
    seg_first = (lengths > 0) & dev_first_row[first]
    live = seg_dev >= 0
    next_dev = torch.cat([seg_dev[1:], seg_dev.new_full((1,), -1)])
    seg_last = live & (next_dev != seg_dev)

    sd = torch.clamp(seg_dev, 0, capacity - 1).to(torch.int64)
    c_win = state.win[sd]
    c_active = live & seg_first & (c_win >= 0)
    same = c_active & (c_win == seg_win)
    m_cnt = seg_cnt + torch.where(same, state.cnt[sd], 0.0)
    m_sum = seg_sum + torch.where(same, state.sm[sd], 0.0)
    m_ssq = seg_ssq + torch.where(same, state.ssq[sd], 0.0)
    m_min = torch.minimum(seg_min, torch.where(same, state.mn[sd], F32_MAX))
    m_max = torch.maximum(seg_max, torch.where(same, state.mx[sd], -F32_MAX))
    carry_final = c_active & (c_win != seg_win)
    final = live & ~seg_last
    span_s = float(window_s) * L

    # per-device carry info gathered per segment (trailing needs it on
    # every segment of the device, not only the first)
    first_win_dev = scatter_set(
        torch.full((capacity,), -2, dtype=_I32, device=tdev),
        torch.where(live & seg_first, sd, capacity), seg_win)
    c_win_dev = state.win[sd]
    carry_final_dev = (c_win_dev >= 0) & (first_win_dev[sd] >= 0) \
        & (c_win_dev != first_win_dev[sd])
    carried = (state.cnt[sd], state.sm[sd], state.ssq[sd], state.mn[sd],
               state.mx[sd])

    def fold(T, use, vals):
        c, s_, q, lo, hi = vals
        return [T[0] + torch.where(use, c, 0.0),
                T[1] + torch.where(use, s_, 0.0),
                T[2] + torch.where(use, q, 0.0),
                torch.minimum(T[3], torch.where(use, lo, F32_MAX)),
                torch.maximum(T[4], torch.where(use, hi, -F32_MAX))]

    def trailing(T, t_win, include_batch: bool):
        """Trailing-L combination ending at hop ``t_win`` per segment."""
        T = list(T)
        if L == 1:
            return T
        if include_batch:
            # a device's in-batch windows occupy consecutive segments with
            # strictly increasing window index, so every in-range prior
            # hop lives within the previous L-1 segments
            for j in range(1, L):
                pidx = torch.clamp(ar - j, min=0)
                use = (ar >= j) & live[pidx] & (seg_dev[pidx] == seg_dev) \
                    & (seg_win[pidx] > t_win - L) & (seg_win[pidx] < t_win)
                T = fold(T, use, (m_cnt[pidx], m_sum[pidx], m_ssq[pidx],
                                  m_min[pidx], m_max[pidx]))
            # the carried window the batch just closed also counts
            use_c = carry_final_dev & (c_win_dev > t_win - L) \
                & (c_win_dev < t_win)
            T = fold(T, use_c, carried)
        # pre-batch ring snapshot: slots strictly inside (t_win-L, t_win)
        r_win = state.ring_win[sd]                 # [nseg, L]
        slot = torch.arange(L, device=tdev)[None, :]
        use_r = (r_win > (t_win - L)[:, None]) & (r_win < t_win[:, None]) \
            & (slot != torch.remainder(t_win, L)[:, None])
        ring = (state.ring_cnt[sd], state.ring_sum[sd], state.ring_ssq[sd],
                state.ring_min[sd], state.ring_max[sd])
        acc = [torch.zeros_like(T[0]), torch.zeros_like(T[0]),
               torch.zeros_like(T[0]), torch.full_like(T[0], F32_MAX),
               torch.full_like(T[0], -F32_MAX)]
        for k in range(L):
            acc = fold(acc, use_r[:, k], tuple(r[:, k] for r in ring))
        return [T[0] + acc[0], T[1] + acc[1], T[2] + acc[2],
                torch.minimum(T[3], acc[3]), torch.maximum(T[4], acc[4])]

    t_cnt, t_sum, t_ssq, t_min, t_max = trailing(
        (m_cnt, m_sum, m_ssq, m_min, m_max), seg_win, include_batch=True)
    seg_value = _agg_value(agg, t_cnt, t_sum, t_ssq, t_min, t_max, span_s)
    thr = f32(float(threshold), tdev)
    match = final & (t_cnt >= min_count) & compare(op, seg_value, thr)

    cf_cnt, cf_sum, cf_ssq, cf_min, cf_max = trailing(
        carried, c_win, include_batch=False)
    carry_value = _agg_value(agg, cf_cnt, cf_sum, cf_ssq, cf_min, cf_max,
                             span_s)
    carry_match = carry_final & (cf_cnt >= min_count) & compare(
        op, carry_value, thr)

    # ring update: push every window finalized this batch; on slot
    # collision (a device spanning >= L hops in one batch) the LATEST
    # window wins, decided by a win-max pre-pass so no scatter writes a
    # live slot twice
    if L > 1:
        dump = capacity * L
        fin_seg = final
        key_seg = torch.where(fin_seg, sd * L + torch.remainder(seg_win, L),
                              dump)
        fin_carry = live & seg_first & carry_final
        key_carry = torch.where(fin_carry, sd * L + torch.remainder(c_win, L),
                                dump)
        slot_win = torch.full((dump + 1,), -1, dtype=_I32, device=tdev)
        slot_win.scatter_reduce_(0, key_seg, torch.where(fin_seg, seg_win, -1),
                                 "amax", include_self=True)
        slot_win.scatter_reduce_(0, key_carry,
                                 torch.where(fin_carry, c_win, -1),
                                 "amax", include_self=True)
        win_seg = fin_seg & (slot_win[key_seg] == seg_win)
        win_car = fin_carry & (slot_win[key_carry] == c_win)
        tgt_seg = torch.where(win_seg, key_seg, dump)
        tgt_car = torch.where(win_car, key_carry, dump)

        def push(ring, v_seg, v_car):
            # the in-batch windows first, then the carried one, as the
            # reference's two scatters
            ext = torch.cat([ring.reshape(-1), ring.new_zeros(1)])
            ext[tgt_seg] = v_seg
            ext[tgt_car] = v_car
            return ext[:-1].reshape(capacity, L)

        state = dataclasses.replace(
            state,
            ring_win=push(state.ring_win, seg_win, c_win),
            ring_cnt=push(state.ring_cnt, m_cnt, carried[0]),
            ring_sum=push(state.ring_sum, m_sum, carried[1]),
            ring_ssq=push(state.ring_ssq, m_ssq, carried[2]),
            ring_min=push(state.ring_min, m_min, carried[3]),
            ring_max=push(state.ring_max, m_max, carried[4]))

    # new open-window carry: each device's last segment
    tgt = torch.where(seg_last, sd, capacity)
    state = dataclasses.replace(
        state,
        win=scatter_set(state.win, tgt, seg_win),
        cnt=scatter_set(state.cnt, tgt, m_cnt),
        sm=scatter_set(state.sm, tgt, m_sum),
        ssq=scatter_set(state.ssq, tgt, m_ssq),
        mn=scatter_set(state.mn, tgt, m_min),
        mx=scatter_set(state.mx, tgt, m_max))
    out = {
        "match": match[:n], "device": seg_dev[:n],
        "win_start": ((seg_win - (L - 1)) * window_s)[:n],
        "win_end": ((seg_win + 1) * window_s)[:n],
        "value": seg_value[:n], "count": t_cnt[:n],
        "carry_match": carry_match[:n],
        "carry_win_start": ((c_win - (L - 1)) * window_s)[:n],
        "carry_win_end": ((c_win + 1) * window_s)[:n],
        "carry_value": carry_value[:n], "carry_count": cf_cnt[:n],
        "occupied": live.sum().to(_I32),
    }
    return state, out


def window_flush(state: WindowOpState, threshold, *, window_s: int,
                 length: int, agg: str, op: int, min_count: int):
    """Finalize every open window (shutdown / end-of-history)."""
    L = max(1, length)
    span_s = float(window_s) * L
    cnt, sm, ssq, mn, mx = (state.cnt, state.sm, state.ssq, state.mn,
                            state.mx)
    if L > 1:
        t_win = state.win
        slot = torch.arange(L, device=t_win.device)[None, :]
        use = (state.ring_win > (t_win - L)[:, None]) \
            & (state.ring_win < t_win[:, None]) \
            & (slot != torch.remainder(t_win, L)[:, None])
        acc = [torch.zeros_like(cnt), torch.zeros_like(cnt),
               torch.zeros_like(cnt), torch.full_like(cnt, F32_MAX),
               torch.full_like(cnt, -F32_MAX)]
        for k in range(L):
            u = use[:, k]
            acc = [acc[0] + torch.where(u, state.ring_cnt[:, k], 0.0),
                   acc[1] + torch.where(u, state.ring_sum[:, k], 0.0),
                   acc[2] + torch.where(u, state.ring_ssq[:, k], 0.0),
                   torch.minimum(acc[3], torch.where(
                       u, state.ring_min[:, k], F32_MAX)),
                   torch.maximum(acc[4], torch.where(
                       u, state.ring_max[:, k], -F32_MAX))]
        cnt, sm, ssq = cnt + acc[0], sm + acc[1], ssq + acc[2]
        mn, mx = torch.minimum(mn, acc[3]), torch.maximum(mx, acc[4])
    value = _agg_value(agg, cnt, sm, ssq, mn, mx, span_s)
    thr = f32(float(threshold), cnt.device)
    match = (state.win >= 0) & (cnt >= min_count) & compare(op, value, thr)
    return {"match": match,
            "win_start": (state.win - (L - 1)) * window_s,
            "win_end": (state.win + 1) * window_s,
            "value": value, "count": cnt}


# ---------------------------------------------------------------------------
# session operator
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SessionOpState:
    """Per-device open session (start/last/count; start=-1 none)."""

    start: torch.Tensor  # int32[D]
    last: torch.Tensor   # int32[D]
    cnt: torch.Tensor    # int32[D]

    @classmethod
    def empty(cls, capacity: int,
              device: DeviceLike = None) -> "SessionOpState":
        dev = resolve_device(device)
        return cls(
            start=torch.full((capacity,), -1, dtype=_I32, device=dev),
            last=torch.zeros(capacity, dtype=_I32, device=dev),
            cnt=torch.zeros(capacity, dtype=_I32, device=dev))


def _session_value(agg: str, cnt, start, end):
    if agg == "count":
        return cnt.to(_F32)
    if agg == "duration_s":
        return (end - start).to(_F32)
    raise ValueError(f"unknown session aggregate {agg!r}")


def session_eval(state: SessionOpState, device_id, ts_s, ok, gap_s,
                 threshold, *, agg: str, op: int):
    """One batch through the session operator (gap-closed sessions)."""
    n = device_id.shape[0]
    tdev = device_id.device
    capacity = state.start.shape[0]
    gap = int(gap_s)
    (order, dev, ts, okr, _, seg, lengths, first, last,
     dev_first_row) = _sorted_segments(device_id, ts_s, ok, capacity,
                                       gap=gap)
    nseg = n + 1
    ar = torch.arange(nseg, device=tdev)
    kept = (ar < n) & (lengths > 0)
    seg_cnt = torch.where(ar < n, lengths, 0).to(_I32)
    seg_start = torch.where(kept, ts[first], BIG_I32)
    seg_end = torch.where(kept, ts[last], torch.where(
        lengths > 0, -BIG_I32, INT_MIN).to(_I32))
    seg_dev = _per_segment(dev, first, lengths, okr, -1, INT_MIN)
    seg_first = (lengths > 0) & dev_first_row[first]
    live = seg_dev >= 0
    next_dev = torch.cat([seg_dev[1:], seg_dev.new_full((1,), -1)])
    seg_last = live & (next_dev != seg_dev)

    sd = torch.clamp(seg_dev, 0, capacity - 1).to(torch.int64)
    c_active = live & seg_first & (state.start[sd] >= 0)
    extends = c_active & (seg_start - state.last[sd] <= gap)
    m_start = torch.where(extends, state.start[sd], seg_start)
    m_cnt = seg_cnt + torch.where(extends, state.cnt[sd], 0)
    carry_final = c_active & ~extends
    final = live & ~seg_last
    thr = f32(float(threshold), tdev)
    seg_value = _session_value(agg, m_cnt, m_start, seg_end)
    match = final & compare(op, seg_value, thr)
    # carry outputs read the PRE-update state (the session the batch just
    # closed)
    carry_start = state.start[sd]
    carry_end = state.last[sd]
    carry_cnt = state.cnt[sd]
    carry_value = _session_value(agg, carry_cnt, carry_start, carry_end)
    carry_match = carry_final & compare(op, carry_value, thr)

    tgt = torch.where(seg_last, sd, capacity)
    state = dataclasses.replace(
        state,
        start=scatter_set(state.start, tgt, m_start),
        last=scatter_set(state.last, tgt, seg_end),
        cnt=scatter_set(state.cnt, tgt, m_cnt))
    return state, {
        "match": match[:n], "device": seg_dev[:n],
        "start": m_start[:n], "end": seg_end[:n],
        "value": seg_value[:n], "count": m_cnt[:n],
        "carry_match": carry_match[:n],
        "carry_start": carry_start[:n], "carry_end": carry_end[:n],
        "carry_count": carry_cnt[:n], "carry_value": carry_value[:n],
    }


def session_flush(state: SessionOpState, threshold, *, agg: str, op: int):
    value = _session_value(agg, state.cnt, state.start, state.last)
    thr = f32(float(threshold), state.cnt.device)
    match = (state.start >= 0) & compare(op, value, thr)
    return {"match": match, "start": state.start, "end": state.last,
            "value": value, "count": state.cnt}


# ---------------------------------------------------------------------------
# compiled queries (spec + state + host extraction)
# ---------------------------------------------------------------------------


def _state_to_arrays(state) -> Dict[str, np.ndarray]:
    """Operator state -> host arrays (the checkpoint payload)."""
    return {f.name: getattr(state, f.name).cpu().numpy()
            for f in dataclasses.fields(state)}


def _state_from_arrays(empty, arrays: Dict[str, np.ndarray]):
    """Rebuild an operator state from exported arrays, or None when the
    field set or shapes no longer match the current operator."""
    flds = dataclasses.fields(empty)
    if set(arrays) != {f.name for f in flds}:
        return None
    updates = {}
    for f in flds:
        cur = getattr(empty, f.name)
        arr = np.asarray(arrays[f.name])
        if tuple(arr.shape) != tuple(cur.shape):
            return None
        host = np.ascontiguousarray(
            arr.astype(torch.empty(0, dtype=cur.dtype).numpy().dtype,
                       copy=False))
        updates[f.name] = torch.from_numpy(host).to(cur.device)
    return dataclasses.replace(empty, **updates)


@dataclasses.dataclass
class Staged:
    """One batch's columns on the device (see :func:`stage_columns`)."""

    device_id: torch.Tensor   # int32[n]
    ts_s: torch.Tensor        # int32[n]
    event_type: torch.Tensor  # int32[n]
    mtype_id: torch.Tensor    # int32[n]
    value: torch.Tensor       # float32[n]
    valid: torch.Tensor       # bool[n]


def stage_columns(cols: Dict[str, np.ndarray], device) -> Staged:
    """A batch's columns on ``device``: one int32 block, the values and
    the valid mask, one copy each.  An empty batch becomes one invalid
    row (the operators leave their state as an empty batch would)."""
    n = len(cols["device_id"])
    b = max(n, 1)
    ints = np.zeros((4, b), np.int32)
    ints[0] = -1
    for i, k in enumerate(("device_id", "ts_s", "event_type", "mtype_id")):
        ints[i, :n] = np.asarray(cols[k], np.int32)
    value = np.zeros(b, np.float32)
    value[:n] = np.asarray(cols["value"], np.float32)
    valid = np.zeros(b, bool)
    valid[:n] = True
    if "valid" in cols:
        valid[:n] &= np.asarray(cols["valid"], bool)[:n]
    ti = torch.from_numpy(ints).to(device)
    return Staged(ti[0], ti[1], ti[2], ti[3],
                  torch.from_numpy(value).to(device),
                  torch.from_numpy(valid).to(device))


class CompiledQuery:
    """Base class: stages a batch, runs the operator, extracts matches
    from one host copy."""

    #: schema tag of export_state()'s array set (the reference's)
    STATE_VERSION = 1

    def __init__(self, spec, capacity: int, mtype_id: int = -1,
                 device: DeviceLike = None):
        self.spec = spec
        self.capacity = int(capacity)
        self.mtype_id = int(mtype_id)
        self.device = resolve_device(device)
        self.matches_emitted = 0
        # window operators update this per eval: fraction of devices
        # holding an open window (the occupancy gauge's source)
        self.last_occupancy: Optional[float] = None
        # host copies made (a list, shared with a pattern's evaluator)
        self.copies = [0]
        self._cap = 256

    def reset(self) -> None:
        raise NotImplementedError

    def export_state(self) -> Dict[str, np.ndarray]:
        """Carried per-device operator state as host arrays."""
        return _state_to_arrays(self._carried_state())

    def import_state(self, arrays: Dict[str, np.ndarray]) -> bool:
        """Adopt exported state; False resets to empty (shape/schema
        drift) and the caller's journal replay re-derives it."""
        state = _state_from_arrays(self._empty_state(), arrays)
        if state is None:
            self.reset()
            return False
        self._adopt_state(state)
        return True

    def _carried_state(self):
        raise NotImplementedError

    def _empty_state(self):
        raise NotImplementedError

    def _adopt_state(self, state) -> None:
        raise NotImplementedError

    def eval_cols(self, cols: Dict[str, np.ndarray]) -> List[QueryMatch]:
        """One host batch (numpy columns) through the operator."""
        return self.eval_staged(stage_columns(cols, self.device))

    def eval_staged(self, b: Staged) -> List[QueryMatch]:
        raise NotImplementedError

    def _fetch(self, masks, fields, header=()):
        """One copy of the rows of ``masks`` (each with its ``fields``),
        compacted on the device; returns ``(header, rows)`` per mask
        group in order, rows as int32 host arrays."""
        mask = torch.cat(masks)
        cols = [torch.cat(f) for f in zip(*fields)]
        cap = min(self._cap, mask.shape[0])
        host = pack_rows(mask, cols, cap, list(header)).cpu().numpy()
        self.copies[0] += 1
        head, rows = unpack_rows(host, mask, cols, cap, self.copies)
        if len(rows) * 2 > self._cap:
            self._cap = 1 << int(2 * len(rows)).bit_length()
        return head, rows

    def _matches(self, kind: str, rows: np.ndarray) -> List[QueryMatch]:
        """Rows of (device, end, start, value bits, count) -> matches,
        ordered by (end, device)."""
        values = as_f32(rows[:, 3]).tolist()
        counts = (as_f32(rows[:, 4]).tolist() if kind == "window"
                  else rows[:, 4].tolist())
        matches = [
            QueryMatch(query=self.spec.name, kind=kind, device_id=r[0],
                       ts_s=r[1], start_ts_s=r[2], value=v, count=int(c))
            for r, v, c in zip(rows.tolist(), values, counts)]
        matches.sort(key=lambda m: (m.ts_s, m.device_id))
        self.matches_emitted += len(matches)
        return matches

    def _flush_matches(self, kind: str, out) -> List[QueryMatch]:
        ids = torch.arange(self.capacity, dtype=_I32, device=self.device)
        _, rows = self._fetch([out["match"]], [(
            ids, out["win_end" if kind == "window" else "end"],
            out["win_start" if kind == "window" else "start"],
            out["value"], out["count"])])
        matches = self._matches(kind, rows)
        self.reset()
        return matches


class CompiledWindowQuery(CompiledQuery):
    def __init__(self, spec: WindowQuery, capacity: int,
                 mtype_id: int = -1, device: DeviceLike = None):
        super().__init__(spec, capacity, mtype_id, device)
        self.state = self._empty_state()

    def reset(self) -> None:
        self.state = self._empty_state()

    def _carried_state(self):
        return self.state

    def _empty_state(self):
        return WindowOpState.empty(self.capacity, self.spec.length,
                                   self.device)

    def _adopt_state(self, state) -> None:
        self.state = state

    def _row_filter(self, b: Staged):
        ok = b.valid & (b.event_type == int(EventType.MEASUREMENT))
        if self.mtype_id >= 0:
            ok = ok & (b.mtype_id == self.mtype_id)
        return ok

    def eval_staged(self, b: Staged) -> List[QueryMatch]:
        s = self.spec
        self.state, out = window_eval(
            self.state, b.device_id, b.ts_s, b.value, self._row_filter(b),
            s.threshold, window_s=s.window_s, length=s.length, agg=s.agg,
            op=s.op, min_count=s.min_count)
        head, rows = self._fetch(
            [out["carry_match"], out["match"]],
            [(out["device"], out["carry_win_end"], out["carry_win_start"],
              out["carry_value"], out["carry_count"]),
             (out["device"], out["win_end"], out["win_start"],
              out["value"], out["count"])],
            header=[(self.state.win >= 0).sum()])
        self.last_occupancy = float(int(head[1]) / self.capacity)
        return self._matches("window", rows)

    def flush(self) -> List[QueryMatch]:
        s = self.spec
        return self._flush_matches("window", window_flush(
            self.state, s.threshold, window_s=s.window_s, length=s.length,
            agg=s.agg, op=s.op, min_count=s.min_count))


class CompiledSessionQuery(CompiledQuery):
    def __init__(self, spec: SessionQuery, capacity: int,
                 mtype_id: int = -1, device: DeviceLike = None):
        super().__init__(spec, capacity, mtype_id, device)
        self.state = self._empty_state()

    def reset(self) -> None:
        self.state = self._empty_state()

    def _carried_state(self):
        return self.state

    def _empty_state(self):
        return SessionOpState.empty(self.capacity, self.device)

    def _adopt_state(self, state) -> None:
        self.state = state

    def eval_staged(self, b: Staged) -> List[QueryMatch]:
        s = self.spec
        ok = b.valid
        if self.mtype_id >= 0:
            ok = ok & (b.event_type == int(EventType.MEASUREMENT)) \
                & (b.mtype_id == self.mtype_id)
        self.state, out = session_eval(
            self.state, b.device_id, b.ts_s, ok, s.gap_s, s.threshold,
            agg=s.agg, op=s.op)
        _, rows = self._fetch(
            [out["carry_match"], out["match"]],
            [(out["device"], out["carry_end"], out["carry_start"],
              out["carry_value"], out["carry_count"]),
             (out["device"], out["end"], out["start"], out["value"],
              out["count"])])
        return self._matches("session", rows)

    def flush(self) -> List[QueryMatch]:
        s = self.spec
        return self._flush_matches("session", session_flush(
            self.state, s.threshold, agg=s.agg, op=s.op))


class CompiledPatternQuery(CompiledQuery):
    def __init__(self, spec: PatternQuery, capacity: int,
                 cross_mtype_id: int = -1, device: DeviceLike = None):
        super().__init__(spec, capacity, cross_mtype_id, device)
        self.program = CepProgram.compile(
            spec.steps, window_s=spec.window_s, cross_op=spec.cross_op,
            cross_threshold=spec.cross_threshold,
            cross_mtype=cross_mtype_id, device=self.device)
        self.evaluator = PatternEvaluator(self.program, capacity,
                                          self.device)
        self.copies = self.evaluator.copies

    def reset(self) -> None:
        self.evaluator.reset()

    def _carried_state(self):
        return self.evaluator.state

    def _empty_state(self):
        return CepState.empty(self.capacity, self.device)

    def _adopt_state(self, state) -> None:
        self.evaluator.state = state

    def eval_staged(self, b: Staged) -> List[QueryMatch]:
        raw = self.evaluator.eval_batch(b.device_id, b.ts_s, b.event_type,
                                        b.mtype_id, b.value, b.valid)
        matches = [
            QueryMatch(query=self.spec.name, kind="pattern",
                       device_id=m["device_id"], ts_s=m["ts_s"],
                       start_ts_s=m["first_ts_s"], value=m["value"], count=1)
            for m in raw]
        self.matches_emitted += len(matches)
        return matches

    def flush(self) -> List[QueryMatch]:
        self.reset()   # patterns have no deferred windows to finalize
        return []


def compile_query(spec, capacity: int, resolve_mtype=None,
                  device: DeviceLike = None):
    """Spec -> compiled query on ``device`` (the card unless named)."""
    def handle(name):
        if name is None or resolve_mtype is None:
            return -1
        return int(resolve_mtype(str(name)))

    if isinstance(spec, WindowQuery):
        return CompiledWindowQuery(spec, capacity, handle(spec.mtype),
                                   device)
    if isinstance(spec, SessionQuery):
        return CompiledSessionQuery(spec, capacity, handle(spec.mtype),
                                    device)
    if isinstance(spec, PatternQuery):
        return CompiledPatternQuery(spec, capacity,
                                    handle(spec.cross_mtype), device)
    raise ValueError(f"not a query spec: {spec!r}")


__all__ = [
    "CompiledQuery", "PatternQuery", "QueryMatch", "SessionOpState",
    "SessionQuery", "Staged", "WindowOpState", "WindowQuery",
    "compile_query", "describe_query", "parse_query", "session_eval",
    "session_flush", "stage_columns", "window_eval", "window_flush",
]
