"""Window kernel library: tumbling/sliding aggregation + sessionization.

Counterpart of ``sitewhere_tpu/analytics/windows.py`` in torch.  Two
families, both struct-of-array code on one device:

- **Grid kernels** over the ``[D, W]`` (device x window) layout:
  :func:`aggregate_windows` reduces N events into dense per-(device,
  window) count/sum/sumsq/min/max statistics, and
  :func:`sliding_aggregates` turns the tumbling grid into trailing-L
  sliding statistics.  Charts (:mod:`.charts`) run on these too.
- **Segment kernels** over sorted event rows: :func:`sort_by_device_time`
  (two stable argsorts, invalid rows last) and :func:`sessionize`, the
  gap-based session assignment by segment-boundary cumsum.

Float sums are order dependent, and a CUDA ``index_add_`` or
``scatter_add_`` adds in whatever order its atomics land.  Every float
sum here is therefore a segmented reduction over rows sorted by their
segment (``torch.segment_reduce`` with lengths): deterministic on the
card, and on the CPU a row-order sum, as XLA:CPU's scatter-add is.  Min
and max commute, so they scatter (``scatter_reduce``); int counts use
``bincount``.

Numerical note (the reference's): variance is the sumsq form
(``ssq/n - mean^2``, clamped at 0), well conditioned for values up to
~1e3.
"""

from __future__ import annotations

import dataclasses

import torch

from sitewhere_tpu_torch.schema import ComparisonOp

BIG_I32 = 2**31 - 1
INT_MIN = -2**31
F32_MAX = 3.0e38
INF = float("inf")


def compare(op: int, value, threshold):
    """Static-op comparison (python dispatch; ``op`` is a config int)."""
    op = int(op)
    if op == int(ComparisonOp.GT):
        return value > threshold
    if op == int(ComparisonOp.LT):
        return value < threshold
    if op == int(ComparisonOp.GTE):
        return value >= threshold
    if op == int(ComparisonOp.LTE):
        return value <= threshold
    if op == int(ComparisonOp.EQ):
        return value == threshold
    if op == int(ComparisonOp.NEQ):
        return value != threshold
    raise ValueError(f"unknown comparison op {op}")


def compare_traced(op: torch.Tensor, value, threshold):
    """Per-row comparison: ``op`` is a tensor of ops, one per row."""
    outs = torch.stack([
        value > threshold, value < threshold,
        value >= threshold, value <= threshold,
        value == threshold, value != threshold,
    ])
    sel = torch.clamp(op, 0, 5).to(torch.int64)[None, ...]
    return torch.gather(outs, 0, sel)[0]


def f32(x: float, device) -> torch.Tensor:
    """A float32 scalar ON ``device``: a divisor that is a Python number
    or a CPU scalar makes CUDA multiply by its reciprocal, which rounds
    differently from the division the reference does."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.  Torch's vectorized float32
    ``sqrt`` on the CPU may miss by one ULP; the float64 root rounded to
    float32 is the correctly rounded one, as XLA and CUDA give."""
    return torch.sqrt(x.double()).to(torch.float32)


def scatter_set(base: torch.Tensor, tgt: torch.Tensor,
                values) -> torch.Tensor:
    """``base.at[tgt].set(values, mode="drop")`` for targets in
    ``[0, len(base)]``: index ``len(base)`` is a dump slot.  Returns a
    new tensor; live targets must not repeat."""
    ext = torch.cat([base, base[:1]])
    ext[tgt] = values
    return ext[:-1]


def scatter_reduce(fill, size: int, tgt: torch.Tensor, values: torch.Tensor,
                   reduce: str) -> torch.Tensor:
    """``full(size, fill).at[tgt].{min,max}(values, mode="drop")`` with a
    dump slot at ``size``."""
    out = torch.full((size + 1,), fill, dtype=values.dtype,
                     device=values.device)
    out.scatter_reduce_(0, tgt, values, reduce, include_self=True)
    return out[:size]


def segment_sum(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Sum of each run of rows, rows sorted by segment (deterministic)."""
    return torch.segment_reduce(data, "sum", lengths=lengths)


# ---------------------------------------------------------------------------
# grid kernels ([D, W] layout)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WindowAggregates:
    """Dense per-(device, window) aggregates: the [D, W] stats grid."""

    counts: torch.Tensor   # int32[D, W]
    sums: torch.Tensor     # float32[D, W]
    sumsqs: torch.Tensor   # float32[D, W]
    mins: torch.Tensor     # float32[D, W] (+FLT_MAX where empty)
    maxs: torch.Tensor     # float32[D, W] (-FLT_MAX where empty)

    @property
    def n_devices(self) -> int:
        return self.counts.shape[0]

    @property
    def n_windows(self) -> int:
        return self.counts.shape[1]

    def means(self) -> torch.Tensor:
        return self.sums / torch.clamp(self.counts, min=1).to(torch.float32)

    def variances(self) -> torch.Tensor:
        n = torch.clamp(self.counts, min=1).to(torch.float32)
        m = self.sums / n
        return torch.clamp(self.sumsqs / n - m * m, min=0.0)

    def stds(self) -> torch.Tensor:
        return sqrt_rn(self.variances())

    def rates(self, window_s: float) -> torch.Tensor:
        return self.counts.to(torch.float32) / f32(window_s,
                                                   self.counts.device)

    def aggregate(self, agg: str, window_s: float = 1.0) -> torch.Tensor:
        """One named aggregate surface over the grid."""
        if agg == "count":
            return self.counts.to(torch.float32)
        if agg == "sum":
            return self.sums
        if agg == "mean":
            return self.means()
        if agg == "min":
            return torch.where(self.counts > 0, self.mins, 0.0)
        if agg == "max":
            return torch.where(self.counts > 0, self.maxs, 0.0)
        if agg == "std":
            return self.stds()
        if agg == "rate":
            return self.rates(window_s)
        raise ValueError(f"unknown aggregate {agg!r}")

    def occupancy(self) -> torch.Tensor:
        """Fraction of grid cells holding at least one event."""
        return (self.counts > 0).to(torch.float32).mean()


AGGREGATES = ("count", "sum", "mean", "min", "max", "std", "rate")


def aggregate_windows(device_id: torch.Tensor, window_idx: torch.Tensor,
                      value: torch.Tensor, valid: torch.Tensor,
                      n_devices: int, n_windows: int) -> WindowAggregates:
    """Reduce N events into the [D, W] aggregate grid: rows sorted by
    cell (stable), then one segmented reduction per field."""
    cells = n_devices * n_windows
    ok = (valid & (device_id >= 0) & (device_id < n_devices)
          & (window_idx >= 0) & (window_idx < n_windows)
          & torch.isfinite(value))
    flat = torch.where(ok, device_id.to(torch.int64) * n_windows
                       + window_idx.to(torch.int64), cells)
    order = torch.argsort(flat, stable=True)
    lengths = torch.bincount(flat, minlength=cells + 1)
    v = torch.where(ok, value, 0.0)[order]
    sums = segment_sum(v, lengths)
    sumsqs = segment_sum(v * v, lengths)
    mins = torch.segment_reduce(torch.where(ok, value, F32_MAX)[order],
                                "min", lengths=lengths, initial=F32_MAX)
    maxs = torch.segment_reduce(torch.where(ok, value, -F32_MAX)[order],
                                "max", lengths=lengths, initial=-F32_MAX)
    shape = (n_devices, n_windows)
    return WindowAggregates(
        counts=lengths[:cells].to(torch.int32).reshape(shape),
        sums=sums[:cells].reshape(shape),
        sumsqs=sumsqs[:cells].reshape(shape),
        mins=mins[:cells].reshape(shape),
        maxs=maxs[:cells].reshape(shape),
    )


def sliding_aggregates(agg: WindowAggregates,
                       length: int) -> WindowAggregates:
    """Trailing-``length``-hop sliding aggregates at every hop: window w
    covers hops (w-length, w], folded left to right from the identity."""
    if length < 1:
        raise ValueError("sliding length must be >= 1")
    w = agg.n_windows

    def roll(x, init, op):
        pad = torch.full((x.shape[0], length - 1), init, dtype=x.dtype,
                         device=x.device)
        padded = torch.cat([pad, x], dim=1)
        acc = torch.full_like(x, init)
        for j in range(length):
            acc = op(acc, padded[:, j:j + w])
        return acc

    return WindowAggregates(
        counts=roll(agg.counts, 0, torch.add),
        sums=roll(agg.sums, 0.0, torch.add),
        sumsqs=roll(agg.sumsqs, 0.0, torch.add),
        mins=roll(agg.mins, F32_MAX, torch.minimum),
        maxs=roll(agg.maxs, -F32_MAX, torch.maximum),
    )


# ---------------------------------------------------------------------------
# segment kernels (sorted event rows)
# ---------------------------------------------------------------------------


def sort_order(device_id: torch.Tensor, ts_s: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """:func:`sort_by_device_time` as int64 indices (for indexing)."""
    dev = torch.where(valid, device_id, BIG_I32)
    order = torch.argsort(ts_s, stable=True)
    return order[torch.argsort(dev[order], stable=True)]


def sort_by_device_time(device_id: torch.Tensor, ts_s: torch.Tensor,
                        valid: torch.Tensor) -> torch.Tensor:
    """Stable (device, ts) sort order with invalid rows LAST (int32, the
    reference's dtype); ties keep arrival order."""
    return sort_order(device_id, ts_s, valid).to(torch.int32)


def segment_rows(okr: torch.Tensor, boundary: torch.Tensor):
    """Segments of sorted rows whose ``okr`` rows come first: returns
    ``(seg, lengths, first, last)`` — each row's segment (``n`` for the
    rest), the ``n + 1`` segment lengths (the last one holds the other
    rows) and each segment's first and last row, clamped into range."""
    n = okr.shape[0]
    seg = torch.where(okr, torch.cumsum(boundary, 0) - 1, n)
    lengths = torch.bincount(seg, minlength=n + 1)
    ends = torch.cumsum(lengths, 0)
    first = torch.clamp(ends - lengths, max=n - 1)
    last = torch.clamp(ends - 1, 0, n - 1)
    return seg, lengths, first, last


@dataclasses.dataclass
class SessionAssignment:
    """Sessionization output: per-event ids + per-session stats (session
    arrays sized N, ``n_sessions`` of them live; sessions numbered in
    (device, start-time) order)."""

    session_id: torch.Tensor    # int32[N], -1 for invalid rows
    n_sessions: torch.Tensor    # int32[]
    device_id: torch.Tensor     # int32[N] per session (dead: -1)
    start_ts_s: torch.Tensor    # int32[N]
    end_ts_s: torch.Tensor      # int32[N]
    counts: torch.Tensor        # int32[N]


def sessionize(device_id: torch.Tensor, ts_s: torch.Tensor,
               valid: torch.Tensor, gap_s) -> SessionAssignment:
    """Gap-based session assignment: two events of one device share a
    session iff their gap is at most ``gap_s``; sessions never span
    devices."""
    n = device_id.shape[0]
    order = sort_order(device_id, ts_s, valid)
    dev_s = device_id[order]
    ts_sorted = ts_s[order]
    ok = valid[order]
    idx = torch.arange(n, device=device_id.device)
    prev = torch.clamp(idx - 1, min=0)
    prev_dev = torch.where(idx > 0, dev_s[prev], -1)
    prev_ts = torch.where(idx > 0, ts_sorted[prev], 0)
    prev_ok = torch.where(idx > 0, ok[prev], False)
    boundary = ok & (~prev_ok | (dev_s != prev_dev)
                     | (ts_sorted - prev_ts > int(gap_s)))
    seg, lengths, first, last = segment_rows(ok, boundary)
    sid_sorted = torch.where(ok, seg, -1)
    n_sessions = torch.amax(torch.cat([sid_sorted, seg.new_full((1,), -1)])) + 1
    live = idx < n_sessions
    session_id = torch.zeros(n, dtype=torch.int32, device=device_id.device)
    session_id[order] = sid_sorted.to(torch.int32)
    return SessionAssignment(
        session_id=session_id,
        n_sessions=n_sessions.to(torch.int32),
        device_id=torch.where(live, dev_s[first[:n]], -1).to(torch.int32),
        start_ts_s=torch.where(live, ts_sorted[first[:n]], 0).to(torch.int32),
        end_ts_s=torch.where(live, ts_sorted[last[:n]], 0).to(torch.int32),
        counts=torch.where(live, lengths[:n], 0).to(torch.int32),
    )


__all__ = [
    "AGGREGATES", "SessionAssignment", "WindowAggregates",
    "aggregate_windows", "compare", "compare_traced", "sessionize",
    "sliding_aggregates", "sort_by_device_time",
]
