"""Tenant metering plane: per-tenant usage attribution for the pipeline.

Counterpart of ``sitewhere_tpu/runtime/metering.py``, copied whole with
the imports renamed.  The port's packed step computes the same
per-tenant block (``pipeline/packed.py pack_outputs``).

The overload ladder and tenant fairness both need to know *which
tenant* is consuming the fleet — per-tenant rule cost must feed the overload ladder, and the
fairness story needs attribution before it can assert a noisy tenant
isn't starving a quiet one.  The shape is FaaS-style pay-per-invocation
accounting (PAPERS.md 2512.09917): every unit of work is billed to an
owner at the point it is spent, cheaply enough to leave on.

Two halves:

- **Device side** (``pipeline/packed.py``): the packed metrics vector
  carries a ``TENANT_METER_SLOTS``-bucket scatter block — accepted rows,
  state writes, and nonfinite rows segment-summed by
  ``tenant_id % slots`` inside the compiled step.  It rides the one
  shared D2H fetch per ring (zero extra host syncs) and psums across
  shards like every other metrics scalar.

- **Host side** (this module): :func:`attribute_block` resolves buckets
  to real tenants (the host holds the batch's exact tenant column, so a
  single-tenant bucket attributes exactly and a collision apportions by
  row share), and :class:`UsageLedger` accumulates per-tenant usage —
  admitted/shed/dead-lettered rows, state writes, sealed bytes, outbound
  fan-out rows, decode and analytics eval seconds — behind a count-min +
  space-saving sketch pair so O(100k) tenants cost O(top_k) memory.

The ledger exposes a governed ``tenant.*`` metric family (top-K tenants
labeled, the long tail aggregated under ``other``), powers
``GET /api/tenants/usage``, snapshots through the checkpoint plane
(:meth:`UsageLedger.snapshot_payload` / :meth:`restore_payload`), and
feeds ``runtime/overload.py``: :meth:`rate_scale` turns a tenant's
measured share of the windowed row stream into a DEGRADED-state budget
multiplier, so heavy tenants tighten first.

Accuracy contract (space-saving, Metwally et al.): with capacity ``k``
over a stream of N offers, every reported count overestimates truth by
at most its reported ``error`` ≤ N/k, and any tenant with true count
above N/k is guaranteed tracked.  The count-min sketch answers point
estimates for UNtracked tenants (drill-down of a long-tail tenant) with
overestimate ≤ 2N/width at 1 - (1/2)^depth confidence.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from sitewhere_tpu_torch.pipeline.packed import (
    TENANT_METER_COUNTERS,
    TENANT_METER_SLOTS,
)

# Per-tenant ledger fields.  The first three arrive from the device
# block; the rest are charged host-side at the stage that spends them.
USAGE_ROW_COUNTERS = (
    "rows",              # admitted (accepted) rows
    "state_writes",      # rows merged into DeviceState
    "nonfinite_rows",    # rows masked for NaN/Inf on device
    "shed_rows",         # rows refused by the overload ladder
    "dead_letter_rows",  # rows parked in the dead-letter lane
    "outbound_rows",     # rows fanned out to outbound connectors
    "sealed_bytes",      # bytes sealed into segment-store history
)
USAGE_TIME_COUNTERS = (
    "decode_s",          # ingest decode share (row-proportional)
    "eval_s",            # live analytics eval share (row-proportional)
)
USAGE_COUNTERS = USAGE_ROW_COUNTERS + USAGE_TIME_COUNTERS

_CHECKPOINT_VERSION = 1

# count-min row hashes: h_i(key) = ((a_i*key + b_i) mod p) mod width.
# Fixed constants — restore must hash identically across processes.
_CM_PRIME = (1 << 31) - 1
_CM_SALTS = ((1103515245, 12345), (69069, 362437), (1664525, 1013904223),
             (22695477, 1), (134775813, 1), (214013, 2531011))
_CM_A = np.array([a for a, _ in _CM_SALTS], np.int64)[:, None]
_CM_B = np.array([b for _, b in _CM_SALTS], np.int64)[:, None]


class CountMin:
    """Count-min sketch over integer keys (conservative point reads).

    ``depth × width`` int64 counters; :meth:`add` bumps one cell per
    row, :meth:`estimate` reads the min — an overestimate by at most
    2N/width with probability ≥ 1 - (1/2)^depth.  Answers "how many
    rows did tenant t ever send" for tenants the space-saving sketch
    is NOT tracking, at fixed memory independent of tenant count.
    """

    def __init__(self, width: int = 1024, depth: int = 4):
        if depth > len(_CM_SALTS):
            raise ValueError(f"depth > {len(_CM_SALTS)} unsupported")
        self.width = int(width)
        self.depth = int(depth)
        self.table = np.zeros((self.depth, self.width), np.int64)
        self._row_base = np.arange(self.depth, dtype=np.int64)[:, None] \
            * self.width
        self.total = 0

    def _cells(self, key: int) -> List[int]:
        k = int(key) & 0x7FFFFFFF
        return [((a * k + b) % _CM_PRIME) % self.width
                for a, b in _CM_SALTS[:self.depth]]

    def add(self, key: int, amount: int = 1) -> None:
        self.total += int(amount)
        for row, col in enumerate(self._cells(key)):
            self.table[row, col] += int(amount)

    def add_many(self, keys, amounts) -> None:
        """Vectorized :meth:`add` over parallel key/amount arrays (the
        per-plan charge path) — hash-identical to the scalar form."""
        keys = np.asarray(keys, np.int64) & 0x7FFFFFFF
        amounts = np.asarray(amounts, np.int64)
        self.total += int(amounts.sum())
        d = self.depth
        cols = ((_CM_A[:d] * keys + _CM_B[:d]) % _CM_PRIME) % self.width
        np.add.at(self.table.reshape(-1), (self._row_base + cols).ravel(),
                  np.broadcast_to(amounts, cols.shape).ravel())

    def estimate(self, key: int) -> int:
        return int(min(self.table[row, col]
                       for row, col in enumerate(self._cells(key))))


class SpaceSaving:
    """Space-saving top-K heavy hitters (Metwally et al. 2005).

    Tracks at most ``capacity`` keys as ``key → [count, error]``.  An
    untracked key evicts the current minimum, inheriting its count as
    both floor and ``error`` bound: reported count ∈ [true, true+error],
    and every key whose true count exceeds total/capacity is guaranteed
    present — exactly the guarantee the top-K metric labels need.
    """

    def __init__(self, capacity: int = 32):
        self.capacity = max(1, int(capacity))
        self._entries: Dict[int, List[int]] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: int) -> bool:
        return int(key) in self._entries

    def offer(self, key: int, amount: int = 1) -> Optional[int]:
        """Count ``amount`` occurrences of ``key``.  Returns the key
        EVICTED to make room (the caller folds its exact ledger row
        into the long-tail aggregate), or None."""
        key = int(key)
        amount = int(amount)
        entry = self._entries.get(key)
        if entry is not None:
            entry[0] += amount
            return None
        if len(self._entries) < self.capacity:
            self._entries[key] = [amount, 0]
            return None
        victim = min(self._entries, key=lambda k: self._entries[k][0])
        floor = self._entries.pop(victim)[0]
        self._entries[key] = [floor + amount, floor]
        return victim

    def topk(self, k: Optional[int] = None) -> List[Tuple[int, int, int]]:
        """``[(key, count, error)]`` sorted by count descending."""
        ranked = sorted(self._entries.items(),
                        key=lambda kv: (-kv[1][0], kv[0]))
        if k is not None:
            ranked = ranked[:k]
        return [(key, cnt, err) for key, (cnt, err) in ranked]

    def state(self) -> Dict[str, List[int]]:
        return {str(k): list(v) for k, v in self._entries.items()}

    def load(self, state: Dict[str, List[int]]) -> None:
        self._entries = {int(k): [int(v[0]), int(v[1])]
                         for k, v in state.items()}


def attribute_block(block: np.ndarray,
                    tenant_ids: np.ndarray,
                    slots: int = TENANT_METER_SLOTS,
                    ) -> Tuple[Dict[int, Dict[str, float]], int]:
    """Resolve the device-side bucket block to exact tenants.

    ``block`` is the fetched ``[len(TENANT_METER_COUNTERS), slots]``
    per-bucket counts; ``tenant_ids`` is the batch's host tenant column
    (the dispatcher already holds it — no extra sync).  A bucket whose
    batch rows all belong to one tenant attributes exactly (the common
    case: slots ≫ tenants-per-batch); a collision apportions the
    bucket's counts across its tenants proportional to their row share.
    Returns ``({tenant: {counter: amount}}, collided_buckets)``.
    """
    out: Dict[int, Dict[str, float]] = {}
    totals = block.sum(axis=0)
    if not totals.any():
        return out, 0
    ids = np.asarray(tenant_ids)
    if len(ids) == 0:
        return out, 0
    if int(ids.min()) < 0:
        ids = ids[ids >= 0]
        if len(ids) == 0:
            return out, 0  # padding rows only — nothing real to bill
    # Tenant handles are small dense ints, so bincount+nonzero is the
    # cheap unique(return_counts=True); fall back for pathological ids.
    hi = int(ids.max())
    if hi < (1 << 20):
        per = np.bincount(ids)
        tenants = np.nonzero(per)[0]
        rows_per = per[tenants]
    else:
        tenants, rows_per = np.unique(ids, return_counts=True)
    buckets = tenants % slots
    occupancy = np.bincount(buckets, minlength=slots)
    active = totals[buckets] != 0
    # Fast path — every active bucket owned by exactly one tenant: one
    # gather for all of them, then plain-python dict builds.  This is
    # the per-plan hot path; no per-bucket numpy calls.
    if int(occupancy.max()) <= 1:
        cols = block[:, buckets[active]].astype(float).T.tolist()
        for t, vals in zip(tenants[active].tolist(), cols):
            out[t] = dict(zip(TENANT_METER_COUNTERS, vals))
        return out, 0
    single = active & (occupancy[buckets] == 1)
    cols = block[:, buckets[single]].astype(float).T.tolist()
    for t, vals in zip(tenants[single].tolist(), cols):
        out[t] = dict(zip(TENANT_METER_COUNTERS, vals))
    coll = active & (occupancy[buckets] > 1)
    collided = 0
    for b in np.unique(buckets[coll]).tolist():
        collided += 1
        sel = buckets == b
        shares = rows_per[sel].astype(float)
        shares /= max(shares.sum(), 1.0)
        for m, frac in zip(tenants[sel].tolist(), shares.tolist()):
            acc = out.setdefault(m, dict.fromkeys(TENANT_METER_COUNTERS, 0.0))
            for ci, name in enumerate(TENANT_METER_COUNTERS):
                acc[name] += float(block[ci, b]) * frac
    return out, collided


class _WindowSlice:
    __slots__ = ("start", "rows", "total", "eval_s")

    def __init__(self, start: float):
        self.start = start
        self.rows: Dict[int, float] = {}
        self.total = 0.0
        # per-tenant metered eval seconds (rules + analytics) charged
        # while this slice was current — the quota denominator rotates
        # with the window, so an over-quota refusal clears by itself
        self.eval_s: Dict[int, float] = {}


class UsageLedger:
    """Sliding-window per-tenant usage with sketch-bounded memory.

    Exact per-tenant counters are kept only for tenants the
    space-saving sketch currently tracks (≤ ``top_k``); an evicted
    tenant's exact row folds into the ``other`` aggregate, and its
    lifetime row count stays answerable through the count-min sketch.
    A ring of ``window_slices`` time slices holds recent per-tenant row
    counts for :meth:`shares`/:meth:`rate_scale` — the overload ladder
    reacts to CURRENT share, not lifetime totals.

    Thread-safe: charged from dispatcher egress, the sealer pool,
    outbound workers, and the analytics eval worker concurrently.
    """

    def __init__(self, top_k: int = 32,
                 window_s: float = 60.0, window_slices: int = 12,
                 sketch_width: int = 1024, sketch_depth: int = 4,
                 fair_share_frac: float = 0.25,
                 min_rate_frac: float = 0.1,
                 fold_every: int = 32,
                 clock: Callable[[], float] = time.monotonic):
        self.top_k = int(top_k)
        self.window_s = float(window_s)
        self.slice_s = self.window_s / max(1, int(window_slices))
        self.window_slices = int(window_slices)
        self.fair_share_frac = float(fair_share_frac)
        self.min_rate_frac = float(min_rate_frac)
        self._clock = clock
        self._lock = threading.Lock()
        self._heavy = SpaceSaving(self.top_k)
        self._cm = CountMin(sketch_width, sketch_depth)
        #: exact counters for tracked tenants: tenant → {counter: value}
        self._usage: Dict[int, Dict[str, float]] = {}
        self._other = dict.fromkeys(USAGE_COUNTERS, 0.0)
        self._totals = dict.fromkeys(USAGE_COUNTERS, 0.0)
        self._window: deque = deque()
        self.collided_buckets = 0
        # pending device blocks: segment-sum blocks are additive, so the
        # egress hot path only accumulates; resolution folds lazily
        self.fold_every = max(1, int(fold_every))
        self._pend_lock = threading.Lock()
        self._pend_block = np.zeros(
            (len(TENANT_METER_COUNTERS), TENANT_METER_SLOTS))
        self._pend_ids: List[np.ndarray] = []
        self._pend_decode_s = 0.0
        self._pend_t0 = 0.0
        self._pend_plans = 0
        # metrics binding (lazy; see bind_metrics)
        self._metrics = None
        self._resolve: Optional[Callable[[int], str]] = None
        self._published: set = set()
        self._last_publish = float("-inf")

    # -- charging ------------------------------------------------------------

    def _offer_locked(self, tenant: int, weight: int) -> None:
        """Weighted heavy-hitter offer (lock held): an eviction folds
        the victim's exact ledger row into the ``other`` aggregate and
        drops its published gauges.  Rank is denominated in ROWS — only
        row-volume charges carry weight here, so a burst of time or
        byte charges can never displace a genuinely heavy tenant."""
        evicted = self._heavy.offer(int(tenant), int(weight))
        if evicted is not None:
            old = self._usage.pop(evicted, None)
            if old is not None:
                for k, v in old.items():
                    self._other[k] += v
            if self._metrics is not None:
                self._unpublish(evicted)

    def _row_locked(self, tenant: int) -> Optional[Dict[str, float]]:
        """The exact ledger row for a TRACKED tenant (minting it on
        first touch); None for the long tail — those charges aggregate
        into ``other``."""
        tenant = int(tenant)
        row = self._usage.get(tenant)
        if row is None and tenant in self._heavy:
            row = self._usage[tenant] = dict.fromkeys(USAGE_COUNTERS, 0.0)
        return row

    # Row-denominated counters that also weigh into heavy-hitter rank:
    # a tenant hammering the intake hard enough to be shed wholesale is
    # exactly the tenant the top-K must surface.
    _RANK_COUNTERS = frozenset(("shed_rows", "dead_letter_rows"))

    def charge(self, tenant: int, counter: str, amount: float) -> None:
        """Bill ``amount`` of ``counter`` to one tenant (host stages:
        shed, dead-letter, stage time)."""
        if amount == 0:
            return
        with self._lock:
            self._totals[counter] += amount
            if counter == "eval_s":
                sl = self._slice(self._clock())
                sl.eval_s[int(tenant)] = (
                    sl.eval_s.get(int(tenant), 0.0) + amount)
            if counter in self._RANK_COUNTERS:
                self._cm.add(tenant, int(amount))
                self._offer_locked(tenant, int(amount))
            row = self._row_locked(tenant)
            if row is not None:
                row[counter] += amount
            else:
                self._other[counter] += amount

    def charge_device_block(self, block: np.ndarray,
                            tenant_ids: np.ndarray,
                            decode_s: float = 0.0) -> None:
        """Bill one plan's device-side tenant block to the ledger.

        ``block`` is :attr:`PackedView.tenant_meter`; ``tenant_ids`` the
        plan's host tenant column.  Segment-sum blocks are ADDITIVE, so
        the always-on egress path only accumulates here — O(slots), the
        same order as a flight-recorder append.  The bucket→tenant
        resolve and sketch/window fold run once per ``fold_every`` plans
        or at any read surface (:meth:`flush_pending`), whichever comes
        first; ``decode_s`` is apportioned across tenants by
        accepted-row share at fold time.
        """
        with self._pend_lock:
            if self._pend_plans == 0:
                self._pend_t0 = self._clock()
            np.add(self._pend_block, block, out=self._pend_block)
            self._pend_ids.append(tenant_ids)
            self._pend_decode_s += decode_s
            self._pend_plans += 1
            ready = self._pend_plans >= self.fold_every
        if ready:
            self.flush_pending()

    def flush_pending(self) -> None:
        """Resolve and fold accumulated device blocks.  Read surfaces
        call this first, so a scrape, query, or checkpoint always sees
        fully-charged state; amortized cost stays on the fold cadence.
        """
        with self._pend_lock:
            if self._pend_plans == 0:
                return
            block = self._pend_block.copy()
            self._pend_block.fill(0.0)
            ids = (self._pend_ids[0] if len(self._pend_ids) == 1
                   else np.concatenate(self._pend_ids))
            self._pend_ids.clear()
            decode_s, self._pend_decode_s = self._pend_decode_s, 0.0
            now = self._pend_t0
            self._pend_plans = 0
        self._fold_block(block, ids, decode_s, now)

    def _fold_block(self, block: np.ndarray, tenant_ids: np.ndarray,
                    decode_s: float, now: float) -> None:
        """Attribute a (possibly multi-plan) block and charge it.  The
        heavy-hitter offer is weighted by accepted rows — rank follows
        actual volume."""
        attributed, collided = attribute_block(block, tenant_ids)
        if not attributed:
            return
        total_rows = sum(a["rows"] for a in attributed.values())
        with self._lock:
            self.collided_buckets += collided
            sl = self._slice(now)
            self._cm.add_many(list(attributed),
                              [int(a["rows"]) for a in attributed.values()])
            self._totals["rows"] += total_rows
            self._totals["state_writes"] += sum(
                a["state_writes"] for a in attributed.values())
            self._totals["nonfinite_rows"] += sum(
                a["rows_nonfinite"] for a in attributed.values())
            if total_rows:
                self._totals["decode_s"] += decode_s
            sl.total += total_rows
            for tenant, amounts in attributed.items():
                rows = amounts["rows"]
                self._offer_locked(tenant, int(rows))
                row = self._row_locked(tenant)
                dec = (decode_s * rows / total_rows) if total_rows else 0.0
                if row is None:
                    row = self._other
                else:
                    sl.rows[tenant] = sl.rows.get(tenant, 0.0) + rows
                row["rows"] += rows
                row["state_writes"] += amounts["state_writes"]
                row["nonfinite_rows"] += amounts["rows_nonfinite"]
                row["decode_s"] += dec

    def charge_rows_host(self, tenant_ids: np.ndarray, counter: str,
                         weights: Optional[np.ndarray] = None) -> None:
        """Bill one row-stream column host-side: ``counter`` grows by 1
        (or ``weights[i]``) per row, grouped by tenant with ONE
        unique/bincount pass (outbound fan-out, sealed bytes)."""
        if len(tenant_ids) == 0:
            return
        tenants, inverse = np.unique(tenant_ids, return_inverse=True)
        if weights is None:
            per = np.bincount(inverse, minlength=len(tenants)).astype(float)
        else:
            per = np.bincount(inverse, weights=weights,
                              minlength=len(tenants))
        with self._lock:
            sl = self._slice(self._clock()) if counter == "eval_s" else None
            for t, amount in zip(tenants.tolist(), per.tolist()):
                if amount == 0 or t < 0:
                    continue
                self._totals[counter] += amount
                if sl is not None:
                    sl.eval_s[t] = sl.eval_s.get(t, 0.0) + amount
                row = self._row_locked(t)
                if row is not None:
                    row[counter] += amount
                else:
                    self._other[counter] += amount

    # -- sliding window ------------------------------------------------------

    def _slice(self, now: float) -> _WindowSlice:
        """Current window slice (lock held), rolling expired ones off."""
        if not self._window or now - self._window[-1].start >= self.slice_s:
            self._window.append(_WindowSlice(now))
        cutoff = now - self.window_s
        while len(self._window) > 1 and self._window[0].start < cutoff:
            self._window.popleft()
        return self._window[-1]

    def shares(self, now: Optional[float] = None) -> Dict[int, float]:
        """Windowed row-share per tracked tenant (0..1)."""
        self.flush_pending()
        now = self._clock() if now is None else now
        with self._lock:
            self._slice(now)
            total = sum(sl.total for sl in self._window)
            if total <= 0:
                return {}
            agg: Dict[int, float] = {}
            for sl in self._window:
                for t, r in sl.rows.items():
                    agg[t] = agg.get(t, 0.0) + r
            return {t: r / total for t, r in agg.items()}

    def windowed_eval_s(self, tenant: int,
                        now: Optional[float] = None) -> float:
        """Metered eval seconds (rules + analytics) this tenant spent
        inside the CURRENT sliding window — the quota denominator.  Like
        :meth:`shares`, rotating a slice off the window forgets its
        charges, so quota refusals clear without any reset call."""
        self.flush_pending()
        now = self._clock() if now is None else now
        tenant = int(tenant)
        with self._lock:
            self._slice(now)
            return sum(sl.eval_s.get(tenant, 0.0) for sl in self._window)

    def rate_scale(self, tenant: int, now: Optional[float] = None) -> float:
        """DEGRADED-budget multiplier from measured share: 1.0 while a
        tenant stays at or under ``fair_share_frac`` of the windowed row
        stream, then ``fair/share`` (floored at ``min_rate_frac``) — a
        tenant at 2× its fair share gets half the uniform budget, and a
        quiet tenant is never penalized.  The overload ladder multiplies
        its per-(tenant, class) token rate by this."""
        share = self.shares(now).get(int(tenant), 0.0)
        if share <= self.fair_share_frac:
            return 1.0
        return max(self.min_rate_frac, self.fair_share_frac / share)

    # -- read surface --------------------------------------------------------

    def topk(self, k: Optional[int] = None) -> List[Tuple[int, int, int]]:
        self.flush_pending()
        with self._lock:
            return self._heavy.topk(k)

    def usage_of(self, tenant: int) -> Dict[str, object]:
        """Drill-down for ONE tenant: the exact ledger row when tracked,
        else the count-min lifetime row estimate (flagged)."""
        self.flush_pending()
        tenant = int(tenant)
        with self._lock:
            row = self._usage.get(tenant)
            if row is not None:
                entry = self._heavy._entries.get(tenant, [0, 0])
                return {"tracked": True, "estimated": False,
                        "rank_count": int(entry[0]),
                        "rank_error": int(entry[1]),
                        "usage": {k: round(v, 6) for k, v in row.items()}}
            return {"tracked": False, "estimated": True,
                    "rows_estimate": self._cm.estimate(tenant)}

    def snapshot(self, resolve: Optional[Callable[[int], str]] = None,
                 k: Optional[int] = None) -> dict:
        """The ``GET /api/tenants/usage`` body: ranked top-K with exact
        usage + error bounds, the long-tail aggregate, grand totals,
        window shares, and the sketch configuration."""
        shares = self.shares()
        with self._lock:
            ranked = self._heavy.topk(k)
            tenants = []
            for tenant, count, error in ranked:
                row = self._usage.get(tenant, {})
                tenants.append({
                    "tenant": (resolve(tenant) if resolve is not None
                               else tenant),
                    "tenant_id": tenant,
                    "rank_count": count,
                    "rank_error": error,
                    "window_share": round(shares.get(tenant, 0.0), 6),
                    "rate_scale": 1.0 if shares.get(tenant, 0.0)
                    <= self.fair_share_frac
                    else max(self.min_rate_frac,
                             self.fair_share_frac / shares[tenant]),
                    "usage": {c: round(row.get(c, 0.0), 6)
                              for c in USAGE_COUNTERS},
                })
            return {
                "tenants": tenants,
                "other": {c: round(v, 6) for c, v in self._other.items()},
                "totals": {c: round(v, 6) for c, v in self._totals.items()},
                "tracked": len(self._usage),
                "top_k": self.top_k,
                "window_s": self.window_s,
                "fair_share_frac": self.fair_share_frac,
                "collided_buckets": self.collided_buckets,
                "sketch": {"width": self._cm.width,
                           "depth": self._cm.depth,
                           "total_rows": self._cm.total},
            }

    # -- metrics binding -----------------------------------------------------

    def bind_metrics(self, metrics,
                     resolve: Optional[Callable[[int], str]] = None) -> None:
        """Attach a registry: :meth:`publish` maintains the governed
        ``tenant.*`` family there — top-K tenants get labeled gauges
        (``tenant.usage.rows.<token>`` …), everything else aggregates
        under ``tenant.usage.rows.other``, and tenants rotating out of
        the top-K have their gauges REMOVED (registry ``remove``), not
        frozen."""
        self._metrics = metrics
        self._resolve = resolve

    def _label(self, tenant: int) -> str:
        if self._resolve is not None:
            try:
                return str(self._resolve(tenant))
            except Exception:
                pass
        return f"t{tenant}"

    def _unpublish(self, tenant: int) -> None:
        if tenant not in self._published:
            return
        self._published.discard(tenant)
        remove = getattr(self._metrics, "remove", None)
        if remove is not None:
            label = self._label(tenant)
            remove(f"tenant.usage.rows.{label}",
                   f"tenant.usage.sealed_bytes.{label}",
                   f"tenant.usage.eval_s.{label}",
                   f"tenant.share.{label}")

    def publish(self, min_interval_s: float = 0.0) -> None:
        """Refresh the ``tenant.*`` gauge family (rate-limited when
        ``min_interval_s`` > 0; the metrics scrape path calls with 0 so
        a scrape always sees current values)."""
        if self._metrics is None:
            return
        now = self._clock()
        if now - self._last_publish < min_interval_s:
            return
        self._last_publish = now
        shares = self.shares(now)
        with self._lock:
            m = self._metrics
            m.gauge("tenant.meter.tracked").set(len(self._usage))
            m.gauge("tenant.meter.collided_buckets").set(
                self.collided_buckets)
            m.gauge("tenant.meter.window_rows").set(
                sum(sl.total for sl in self._window))
            m.gauge("tenant.usage.rows.other").set(self._other["rows"])
            current = set()
            for tenant, _count, _err in self._heavy.topk():
                row = self._usage.get(tenant)
                if row is None:
                    continue
                current.add(tenant)
                label = self._label(tenant)
                m.gauge(f"tenant.usage.rows.{label}").set(row["rows"])
                m.gauge(f"tenant.usage.sealed_bytes.{label}").set(
                    row["sealed_bytes"])
                # metered eval time (analytics queries + rule programs)
                m.gauge(f"tenant.usage.eval_s.{label}").set(
                    round(row.get("eval_s", 0.0), 6))
                m.gauge(f"tenant.share.{label}").set(
                    round(shares.get(tenant, 0.0), 6))
            for tenant in list(self._published - current):
                self._unpublish(tenant)
            self._published = current

    # -- checkpoint plane ----------------------------------------------------

    def snapshot_payload(self) -> Tuple[bytes, Optional[dict]]:
        """Checkpoint section body (StateProvider ``snapshot_fn``)."""
        self.flush_pending()
        with self._lock:
            doc = {
                "version": _CHECKPOINT_VERSION,
                "totals": self._totals,
                "other": self._other,
                "usage": {str(t): row for t, row in self._usage.items()},
                "heavy": self._heavy.state(),
                "collided_buckets": self.collided_buckets,
                "cm": {
                    "width": self._cm.width,
                    "depth": self._cm.depth,
                    "total": self._cm.total,
                    "table": self._cm.table.reshape(-1).tolist(),
                },
            }
        return json.dumps(doc).encode(), None

    def restore_payload(self, header: dict, payload: bytes) -> None:
        """StateProvider ``restore_fn``: lifetime counters and sketches
        come back intact; the sliding window deliberately restarts empty
        (shares describe CURRENT load — pre-crash load is not evidence
        about the post-restart stream)."""
        doc = json.loads(payload.decode())
        with self._pend_lock:  # drop pre-restore pending accumulation
            self._pend_block.fill(0.0)
            self._pend_ids.clear()
            self._pend_decode_s = 0.0
            self._pend_plans = 0
        with self._lock:
            self._totals = {c: float(doc["totals"].get(c, 0.0))
                            for c in USAGE_COUNTERS}
            self._other = {c: float(doc["other"].get(c, 0.0))
                           for c in USAGE_COUNTERS}
            self._usage = {
                int(t): {c: float(row.get(c, 0.0)) for c in USAGE_COUNTERS}
                for t, row in doc["usage"].items()}
            self._heavy.load(doc["heavy"])
            self.collided_buckets = int(doc.get("collided_buckets", 0))
            cm = doc["cm"]
            if (int(cm["width"]), int(cm["depth"])) == (self._cm.width,
                                                        self._cm.depth):
                self._cm.table = np.asarray(
                    cm["table"], np.int64).reshape(self._cm.depth,
                                                   self._cm.width)
                self._cm.total = int(cm["total"])
            # else: sketch geometry changed across versions — start the
            # estimator fresh rather than mis-hash restored cells
            self._window.clear()


class QuotaTable:
    """Per-tenant metered eval quotas over the ledger's sliding window.

    The enforcement half of the tenant quota story: the ledger
    already bills rule-program and analytics eval wall time to tenants
    (``eval_s``, windowed per slice); this table turns that denominator
    into a two-step ladder —

    - ``deprioritized`` (≥ ``soft_frac`` × quota): the tenant's rows are
      SKIPPED by the live rule/analytics eval lanes (counted under
      ``tenant.quota.eval_rows_skipped``), but operator surfaces still
      work.
    - ``refused`` (≥ quota): REST eval surfaces (rule program writes,
      retrospective analytics runs) raise :class:`QuotaExceeded` — a
      retryable 429 that clears as the usage window rotates.

    The ingest hot path NEVER consults this table: quotas bound metered
    compute, not telemetry admission (that is the overload ladder's
    job).  Quotas are configured per tenant (``tenants.<token>.quota.
    eval_s_per_window``) with an optional instance-wide default
    (``metering.quota.eval_s_per_window``); a tenant with neither is
    unlimited.
    """

    def __init__(self, ledger: UsageLedger,
                 default_eval_s: Optional[float] = None,
                 soft_frac: float = 0.8,
                 metrics=None):
        self.ledger = ledger
        self.default_eval_s = (None if default_eval_s is None
                               else float(default_eval_s))
        self.soft_frac = float(soft_frac)
        self._quotas: Dict[int, float] = {}
        self._m_refusals = None
        self._m_skipped = None
        if metrics is not None:
            self.bind_metrics(metrics)

    def bind_metrics(self, metrics) -> None:
        self._m_refusals = metrics.counter("tenant.quota.refusals")
        self._m_skipped = metrics.counter("tenant.quota.eval_rows_skipped")

    def set_quota(self, tenant: int,
                  eval_s_per_window: Optional[float]) -> None:
        """Configure one tenant's eval-seconds-per-window quota (None
        removes the override, falling back to the default)."""
        if eval_s_per_window is None:
            self._quotas.pop(int(tenant), None)
        else:
            self._quotas[int(tenant)] = float(eval_s_per_window)

    def quota_of(self, tenant: int) -> Optional[float]:
        return self._quotas.get(int(tenant), self.default_eval_s)

    def state_of(self, tenant: int, now: Optional[float] = None) -> str:
        """``ok`` | ``deprioritized`` | ``refused`` for one tenant."""
        quota = self.quota_of(tenant)
        if quota is None or quota <= 0:
            return "ok"
        used = self.ledger.windowed_eval_s(tenant, now)
        if used >= quota:
            return "refused"
        if used >= quota * self.soft_frac:
            return "deprioritized"
        return "ok"

    def consumption(self, tenant: int,
                    now: Optional[float] = None) -> Dict[str, object]:
        """The REST drill-down body: quota, windowed consumption,
        remaining headroom, and the enforcement state."""
        quota = self.quota_of(tenant)
        used = self.ledger.windowed_eval_s(tenant, now)
        body: Dict[str, object] = {
            "eval_s_used": round(used, 6),
            "eval_s_quota": quota,
            "window_s": self.ledger.window_s,
            "state": "ok",
        }
        if quota is not None and quota > 0:
            body["eval_s_remaining"] = round(max(0.0, quota - used), 6)
            body["state"] = self.state_of(tenant, now)
        return body

    def check_eval(self, tenant: int, now: Optional[float] = None) -> None:
        """Gate one REST eval operation; raises :class:`QuotaExceeded`
        (retryable 429) when the tenant's window is exhausted."""
        if self.state_of(tenant, now) != "refused":
            return
        if self._m_refusals is not None:
            self._m_refusals.inc()
        from sitewhere_tpu_torch.services.common import QuotaExceeded

        quota = self.quota_of(tenant)
        raise QuotaExceeded(
            f"tenant eval quota exhausted "
            f"({self.ledger.windowed_eval_s(tenant, now):.3f}s of "
            f"{quota:.3f}s this {self.ledger.window_s:.0f}s window); "
            f"retry after the window rotates")

    def skip_mask(self, tenant_ids,
                  now: Optional[float] = None) -> Optional[np.ndarray]:
        """Boolean mask of rows whose tenant is deprioritized-or-worse
        (the live eval lanes drop those rows, counted); None when no
        tenant in the batch is throttled — the common case costs one
        unique() and a dict probe per distinct tenant."""
        if not self._quotas and self.default_eval_s is None:
            return None
        ids = np.asarray(tenant_ids)
        if ids.size == 0:
            return None
        skip = None
        for t in np.unique(ids).tolist():
            if t < 0 or self.state_of(t, now) == "ok":
                continue
            if skip is None:
                skip = np.zeros(ids.shape, bool)
            skip |= ids == t
        if skip is not None and self._m_skipped is not None:
            self._m_skipped.inc(int(skip.sum()))
        return skip


__all__ = [
    "CountMin", "SpaceSaving", "UsageLedger", "QuotaTable",
    "attribute_block",
    "USAGE_COUNTERS", "USAGE_ROW_COUNTERS", "USAGE_TIME_COUNTERS",
]
