"""CEP layer: per-device pattern state machines as batched torch passes.

Counterpart of ``sitewhere_tpu/analytics/cep.py``.  A pattern is a small
table of states x event-predicate transitions evaluated with vectorized
gather/select over a whole batch, carrying per-device state between
batches; the same passes run on the live batch and on replayed history.

Pattern semantics (the reference's contract):

- events are processed in (device, ts) order; ties keep arrival order;
- a machine at stage ``s`` advances on the EARLIEST not-yet-consumed event
  matching step ``s``'s predicate, provided it arrives within
  ``within_s[s]`` of the previous step's event (``within_s <= 0``: no
  deadline);
- an event past the deadline resets the machine, and restarts it (stage
  1) when it matches step 0;
- reaching the final stage emits a match and re-arms at stage 0.

:func:`cep_pass` makes one winner election per device per step with a
scatter-min, so one call yields at most one match per device;
:class:`PatternEvaluator` loops it while ``progress`` is nonzero, the
same number of passes as the reference.  Each pass ends with ONE copy to
the host: its progress count and its matches, compacted on the device.

Float contract of the window-cross feature: running window sums are
prefix-sum differences inside a batch.  Torch's cumsum associates
differently from XLA's (and the CPU's accumulates in float64), so the two
agree exactly only while the prefix sums are exact in float32, e.g.
values on a 1/8 grid with every |prefix sum| under 2^21.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sitewhere_tpu_torch.analytics.windows import (
    BIG_I32,
    compare,
    compare_traced,
    scatter_reduce,
    scatter_set,
    sort_order,
)
from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.schema import ComparisonOp, EventType

_I32 = torch.int32


@dataclasses.dataclass
class PatternStep:
    """One state-transition predicate of a pattern.

    ``event_type``/``mtype_id`` of -1 are wildcards; ``op``/``threshold``
    apply to the event value only when ``has_value``; ``window_cross``
    requires the window-cross feature to fire on the event; ``within_s``
    bounds the gap from the previous step (ignored on step 0; <= 0 means
    no deadline).  Pickled under the reference's name (see
    :mod:`.checkpoint`).
    """

    _PICKLE_AS = ("sitewhere_tpu.analytics.cep", "PatternStep")

    event_type: int = -1
    mtype_id: int = -1
    has_value: bool = False
    op: int = int(ComparisonOp.GT)
    threshold: float = 0.0
    window_cross: bool = False
    within_s: int = 0

    def __reduce__(self):
        import copyreg

        return copyreg.__newobj__, (type(self),), dict(self.__dict__)


@dataclasses.dataclass
class CepState:
    """Per-device pattern + window-accumulator state, carried between
    batches."""

    stage: torch.Tensor      # int32[D] — current pattern stage
    stage_ts: torch.Tensor   # int32[D] — ts of the last advancing event
    first_ts: torch.Tensor   # int32[D] — ts of the step-0 event
    frontier: torch.Tensor   # int32[D] — last consumed row idx (per batch)
    win: torch.Tensor        # int32[D] — open tumbling window (-1 none)
    win_cnt: torch.Tensor    # float32[D]
    win_sum: torch.Tensor    # float32[D]

    @classmethod
    def empty(cls, capacity: int, device: DeviceLike = None) -> "CepState":
        dev = resolve_device(device)

        def full(v, dt):
            return torch.full((capacity,), v, dtype=dt, device=dev)

        return cls(stage=full(0, _I32), stage_ts=full(0, _I32),
                   first_ts=full(0, _I32), frontier=full(-1, _I32),
                   win=full(-1, _I32), win_cnt=full(0.0, torch.float32),
                   win_sum=full(0.0, torch.float32))


@dataclasses.dataclass
class CepProgram:
    """A compiled pattern: step tables as tensors + the window-cross
    feature's configuration (``n_steps`` is the pass count)."""

    n_steps: int
    step_event_type: torch.Tensor  # int32[K]
    step_mtype: torch.Tensor       # int32[K]
    step_has_value: torch.Tensor   # bool[K]
    step_op: torch.Tensor          # int32[K]
    step_threshold: torch.Tensor   # float32[K]
    step_cross: torch.Tensor       # bool[K]
    step_within: torch.Tensor      # int32[K]
    cross_enabled: bool = False
    window_s: int = 300
    cross_op: int = int(ComparisonOp.GT)
    cross_threshold: float = 0.0
    cross_mtype: int = -1

    @classmethod
    def compile(cls, steps: List[PatternStep], *, window_s: int = 300,
                cross_op: int = int(ComparisonOp.GT),
                cross_threshold: float = 0.0, cross_mtype: int = -1,
                device: DeviceLike = None) -> "CepProgram":
        if not steps:
            raise ValueError("a pattern needs at least one step")
        dev = resolve_device(device)

        def col(attr, dt):
            return torch.tensor([getattr(s, attr) for s in steps], dtype=dt,
                                device=dev)

        return cls(
            n_steps=len(steps),
            step_event_type=col("event_type", _I32),
            step_mtype=col("mtype_id", _I32),
            step_has_value=col("has_value", torch.bool),
            step_op=col("op", _I32),
            step_threshold=col("threshold", torch.float32),
            step_cross=col("window_cross", torch.bool),
            step_within=col("within_s", _I32),
            cross_enabled=any(s.window_cross for s in steps),
            window_s=int(window_s), cross_op=int(cross_op),
            cross_threshold=float(cross_threshold),
            cross_mtype=int(cross_mtype))

    def tables(self) -> Tuple[torch.Tensor, ...]:
        return (self.step_event_type, self.step_mtype, self.step_has_value,
                self.step_op, self.step_threshold, self.step_cross,
                self.step_within)


def cep_features(state: CepState, device_id, ts_s, event_type, mtype_id,
                 value, valid, *, window_s: int, cross_op: int,
                 cross_threshold, cross_mtype, cross_enabled: bool):
    """Sort the batch and derive the window-cross feature.

    Returns ``(new_state, order, cross)``: ``order`` is the (device, ts)
    sort (int32) the pattern passes consume; ``cross[i]`` (sorted order)
    fires when event i pushes its device's running tumbling-window mean
    across the threshold (edge-triggered)."""
    n = device_id.shape[0]
    order = sort_order(device_id, ts_s, valid)
    if not cross_enabled:
        return state, order.to(_I32), torch.zeros(
            n, dtype=torch.bool, device=device_id.device)
    dev = device_id[order]
    ts = ts_s[order]
    ok = valid[order]
    et = event_type[order]
    mt = mtype_id[order]
    val = value[order]
    cross_mtype = int(cross_mtype)
    capacity = state.win.shape[0]
    mrow = (ok & (dev >= 0) & (dev < capacity)
            & (et == int(EventType.MEASUREMENT))
            & ((cross_mtype < 0) | (mt == cross_mtype)) & torch.isfinite(val))
    win = torch.where(mrow, torch.div(ts, int(window_s),
                                      rounding_mode="floor"), -2)
    idx = torch.arange(n, device=device_id.device)
    lastm_incl = torch.cummax(torch.where(mrow, idx, -1), 0).values
    prev_m = torch.where(idx > 0, lastm_incl[torch.clamp(idx - 1, min=0)], -1)
    pm = torch.clamp(prev_m, min=0)
    prev_dev = torch.where(prev_m >= 0, dev[pm], -1)
    prev_win = torch.where(prev_m >= 0, win[pm], -2)
    boundary = mrow & ((prev_m < 0) | (prev_dev != dev) | (prev_win != win))
    seg = torch.where(mrow, torch.cumsum(boundary, 0) - 1, n)
    prefix_cnt = torch.cumsum(mrow.to(torch.float32), 0)
    prefix_sum = torch.cumsum(torch.where(mrow, val, 0.0), 0)
    seg_start = scatter_reduce(BIG_I32, n + 1, seg,
                               torch.where(mrow, idx, BIG_I32), "amin")
    start_i = torch.clamp(seg_start[torch.clamp(seg, max=n)], 0, n - 1)
    rcnt = (prefix_cnt - prefix_cnt[start_i]
            + mrow[start_i].to(torch.float32))
    rsum = (prefix_sum - prefix_sum[start_i]
            + torch.where(mrow[start_i], val[start_i], 0.0))
    dev_safe = torch.clamp(dev, 0, capacity - 1).to(torch.int64)
    dev_first_seg = boundary & ((prev_m < 0) | (prev_dev != dev))
    first_seg_of_dev = scatter_reduce(
        0, n + 1, seg, dev_first_seg.to(torch.int64), "amax")[
            torch.clamp(seg, max=n)] > 0
    same_win = first_seg_of_dev & (state.win[dev_safe] == win) & mrow
    tot_cnt = rcnt + torch.where(same_win, state.win_cnt[dev_safe], 0.0)
    tot_sum = rsum + torch.where(same_win, state.win_sum[dev_safe], 0.0)
    mean_after = tot_sum / torch.clamp(tot_cnt, min=1.0)
    before_cnt = tot_cnt - 1.0
    mean_before = (tot_sum - val) / torch.clamp(before_cnt, min=1.0)
    thr = torch.tensor(cross_threshold, dtype=torch.float32,
                       device=device_id.device)
    sat_after = compare(cross_op, mean_after, thr)
    sat_before = compare(cross_op, mean_before, thr)
    cross = mrow & sat_after & ((before_cnt < 0.5) | ~sat_before)
    # new carry: each device's LAST measurement row closes the batch
    last_incl = scatter_reduce(
        -1, capacity, torch.where(mrow, dev_safe, capacity),
        torch.where(mrow, idx, -1), "amax")
    has_m = last_incl >= 0
    li = torch.clamp(last_incl, 0, n - 1)
    state = dataclasses.replace(
        state,
        win=torch.where(has_m, win[li], state.win).to(_I32),
        win_cnt=torch.where(has_m, tot_cnt[li], state.win_cnt),
        win_sum=torch.where(has_m, tot_sum[li], state.win_sum))
    return state, order.to(_I32), cross


def cep_pass(state: CepState, program_arrays, dev, ts, et, mt, val, ok,
             cross, *, n_steps: int):
    """K vectorized transition passes over one sorted batch.

    Returns ``(state, matched[D], match_first_ts[D], match_ts[D],
    match_val[D], progress)``; at most one match per device per call."""
    (s_et, s_mt, s_hasv, s_op, s_thr, s_cross, s_within) = program_arrays
    n = dev.shape[0]
    capacity = state.stage.shape[0]
    tdev = dev.device
    idx = torch.arange(n, device=tdev)
    idx32 = idx.to(_I32)
    dev_safe = torch.clamp(dev, 0, capacity - 1).to(torch.int64)
    in_cap = ok & (dev >= 0) & (dev < capacity)

    matched = torch.zeros(capacity, dtype=torch.bool, device=tdev)
    match_first = torch.zeros(capacity, dtype=_I32, device=tdev)
    match_ts = torch.zeros(capacity, dtype=_I32, device=tdev)
    match_val = torch.zeros(capacity, dtype=torch.float32, device=tdev)
    progress = torch.zeros((), dtype=_I32, device=tdev)
    stage, stage_ts, first_ts, frontier = (
        state.stage, state.stage_ts, state.first_ts, state.frontier)

    def row_pred(step_idx):
        k = torch.clamp(step_idx, 0, n_steps - 1).to(torch.int64)
        p = (s_et[k] < 0) | (s_et[k] == et)
        p &= (s_mt[k] < 0) | (s_mt[k] == mt)
        p &= ~s_hasv[k] | compare_traced(s_op[k], val, s_thr[k])
        p &= ~s_cross[k] | cross
        return p

    for _ in range(n_steps):
        s = stage[dev_safe]
        fresh = idx32 > frontier[dev_safe]
        within = s_within[torch.clamp(s, 0, n_steps - 1).to(torch.int64)]
        in_time = (s == 0) | (within <= 0) | (
            ts <= stage_ts[dev_safe] + within)
        cand_adv = in_cap & fresh & in_time & row_pred(s)
        cand_restart = (in_cap & fresh & (s > 0) & ~in_time
                        & row_pred(torch.zeros_like(s)))
        cand = cand_adv | cand_restart
        tgt_c = torch.where(cand, dev_safe, capacity)
        winner = scatter_reduce(n, capacity, tgt_c,
                                torch.where(cand, idx32, n), "amin")
        is_win = cand & (idx32 == winner[dev_safe])
        progress = progress + is_win.sum().to(_I32)
        restart = cand_restart & is_win
        new_stage_row = torch.where(restart, 1, s + 1)
        new_first_row = torch.where(restart | (s == 0), ts,
                                    first_ts[dev_safe])
        hit = is_win & (new_stage_row >= n_steps)
        tgt = torch.where(is_win, dev_safe, capacity)
        stage = scatter_set(stage, tgt, torch.where(hit, 0, new_stage_row))
        stage_ts = scatter_set(stage_ts, tgt, ts)
        first_ts = scatter_set(first_ts, tgt, new_first_row)
        frontier = scatter_set(frontier, tgt, idx32)
        hit_tgt = torch.where(hit, dev_safe, capacity)
        matched = scatter_set(matched, hit_tgt, True)
        match_first = scatter_set(match_first, hit_tgt, new_first_row)
        match_ts = scatter_set(match_ts, hit_tgt, ts)
        match_val = scatter_set(match_val, hit_tgt, val)

    state = dataclasses.replace(state, stage=stage, stage_ts=stage_ts,
                                first_ts=first_ts, frontier=frontier)
    return state, matched, match_first, match_ts, match_val, progress


def pack_rows(mask: torch.Tensor, fields: List[torch.Tensor], cap: int,
              header: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Compact the rows of ``mask`` on the device into one int32 block
    ``[1 + cap, F]``: row 0 holds the match count and then ``header``;
    rows ``1..`` the first ``cap`` matched rows' fields (float fields as
    their bits), in row order.  One copy of it is one host transfer."""
    width = len(fields)
    cols = torch.stack([f.view(_I32) if f.dtype == torch.float32
                        else f.to(_I32) for f in fields], dim=1)
    pos = torch.cumsum(mask, 0) - 1
    tgt = torch.where(mask & (pos < cap), pos, cap)
    buf = torch.zeros((cap + 1, width), dtype=_I32, device=mask.device)
    buf[tgt] = cols
    head = [mask.sum()] + list(header or [])
    head = torch.stack([h.to(_I32) for h in head])
    row0 = torch.zeros((1, width), dtype=_I32, device=mask.device)
    row0[0, :head.shape[0]] = head
    return torch.cat([row0, buf[:cap]])


def unpack_rows(host: np.ndarray, mask, fields, cap: int, copies: list):
    """The host side of :func:`pack_rows`: ``(header, rows)``; when more
    rows matched than ``cap`` holds, the rest come in a second copy
    (counted in ``copies``)."""
    count = int(host[0, 0])
    rows = host[1:1 + min(count, cap)]
    if count > cap:
        copies[0] += 1
        rows = pack_rows(mask, fields, int(count)).cpu().numpy()[1:]
    return host[0], rows


def as_f32(col: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(col).view(np.float32)


class PatternEvaluator:
    """Host loop of one compiled pattern: carries :class:`CepState`
    across batches and loops :func:`cep_pass` until quiescent.

    Per pass, one host copy holds the pass's progress and its matches;
    ``passes`` and ``copies`` count them over the evaluator's life."""

    def __init__(self, program: CepProgram, capacity: int,
                 device: DeviceLike = None):
        self.program = program
        self.capacity = int(capacity)
        self.device = resolve_device(device)
        self.state = CepState.empty(self.capacity, self.device)
        self.passes = 0
        self.copies = [0]
        self._cap = 256

    def reset(self) -> None:
        self.state = CepState.empty(self.capacity, self.device)

    def eval_batch(self, device_id, ts_s, event_type, mtype_id, value,
                   valid) -> List[Dict[str, object]]:
        """Evaluate one batch (tensors on the evaluator's device); returns
        match dicts (device_id, first_ts_s, ts_s, value), ordered by
        (ts_s, device_id)."""
        p = self.program
        # fresh per-batch frontier: rows of THIS batch are all unseen
        self.state = dataclasses.replace(
            self.state, frontier=torch.full_like(self.state.frontier, -1))
        self.state, order, cross = cep_features(
            self.state, device_id, ts_s, event_type, mtype_id, value, valid,
            window_s=p.window_s, cross_op=p.cross_op,
            cross_threshold=p.cross_threshold, cross_mtype=p.cross_mtype,
            cross_enabled=p.cross_enabled)
        o = order.to(torch.int64)
        dev, ts, et, mt, val, ok = (device_id[o], ts_s[o], event_type[o],
                                    mtype_id[o], value[o], valid[o])
        tables = p.tables()
        ids = torch.arange(self.capacity, dtype=_I32, device=self.device)
        matches: List[Dict[str, object]] = []
        while True:
            (self.state, matched, m_first, m_ts, m_val,
             progress) = cep_pass(self.state, tables, dev, ts, et, mt, val,
                                  ok, cross, n_steps=p.n_steps)
            fields = [ids, m_first, m_ts, m_val]
            cap = self._cap
            host = pack_rows(matched, fields, cap, [progress]).cpu().numpy()
            self.passes += 1
            self.copies[0] += 1
            head, rows = unpack_rows(host, matched, fields, cap, self.copies)
            if len(rows):
                self._cap = max(self._cap, 1 << int(2 * len(rows)).bit_length())
                vals = as_f32(rows[:, 3])
                for r, v in zip(rows.tolist(), vals.tolist()):
                    matches.append({"device_id": r[0], "first_ts_s": r[1],
                                    "ts_s": r[2], "value": v})
            if int(head[1]) == 0:
                break
        matches.sort(key=lambda m: (m["ts_s"], m["device_id"]))
        return matches


__all__ = ["CepProgram", "CepState", "PatternEvaluator", "PatternStep",
           "cep_features", "cep_pass"]
