"""The comparison that decides ``correct``: each number beside its limit.

Numbers (the limits are in each configuration's file, under ``limits``):

- ``rows_misplaced``: the plans' stream rows do not tile the stream in
  order (a row in no plan, in two, out of order, or a plan wider than the
  batch), over every device;
- ``stored_total_gap``: stored stream rows against the rows of registered
  devices handed in, over every device;
- ``stored_wrong``: stream rows of the sampled devices stored that should
  not be, or not stored that should be (a multiset difference, so a row
  stored twice counts);
- ``enrich_wrong``: stored rows of the sampled devices whose enrichment
  columns differ from their device's registry entry;
- ``alerts_wrong``: derived alerts of the sampled devices (source row,
  code, level, event time) in one outcome and not the other, leaving out
  rows whose threshold decision lies within the ``ewma_gap`` limit of a
  WINDOW_MEAN threshold;
- ``state_changes_wrong``: quarantine STATE_CHANGE rows per sampled device;
- ``state_wrong``: sampled devices' state entries that differ, every
  field but the EWMAs, which are copies or counts and so compare exactly;
- ``ewma_gap``: the widest gap of a sampled EWMA from the reference's, in
  the value's own units (the exponential is not correctly rounded on
  either side, so this one is not exact).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from benchmark.reference.plain import ENRICHMENT, Outcome

CHECKS = ("rows_misplaced", "stored_total_gap", "stored_wrong",
          "enrich_wrong", "alerts_wrong", "state_changes_wrong",
          "state_wrong", "ewma_gap")


def multiset_gap(a: np.ndarray, b: np.ndarray) -> int:
    """Rows in one multiset and not the other, duplicates counted."""
    a, b = (np.asarray(x, np.int64) for x in (a, b))
    a, b = (x[:, None] if x.ndim == 1 else x for x in (a, b))
    both = np.concatenate([a, b])
    if both.size == 0:
        return 0
    _, inv = np.unique(both, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    n = int(inv.max()) + 1
    ca = np.bincount(inv[:len(a)], minlength=n)
    cb = np.bincount(inv[len(a):], minlength=n)
    return int(np.abs(ca - cb).sum())


def rows_misplaced(plans: np.ndarray, total_rows: int, width: int) -> int:
    """``plans`` ``[P, 4]``: first and last stream row, stream rows and all
    rows of each plan that held stream rows, in the order they were
    stepped.  Counts rows that break an in-order tiling of
    ``[0, total_rows)``."""
    bad = 0
    nxt = 0
    for lo, hi, n_stream, n_all in plans:
        bad += abs(int(n_stream) - int(hi - lo + 1))
        bad += abs(int(lo) - nxt)
        bad += max(0, int(n_all) - width)
        nxt = int(hi) + 1
    return bad + abs(total_rows - nxt)


def order_inversions(plans: np.ndarray, refs: np.ndarray,
                     dev: np.ndarray) -> int:
    """Stream rows stepped before an earlier-handed row of their device:
    ``plans`` ``[P, 2]`` first and last stream row, in step order."""
    if refs.size == 0 or plans.size == 0:
        return 0
    order = np.argsort(plans[:, 0], kind="stable")
    pos = np.searchsorted(plans[order, 0], refs, "right") - 1
    step = order[np.clip(pos, 0, None)]
    srt = np.lexsort((refs, dev))
    d, st = dev[srt], step[srt]
    bad = 0
    for u in np.unique(d):
        s = st[d == u]
        bad += int(np.count_nonzero(s < np.maximum.accumulate(s)))
    return bad


def enrich_wrong(dev: np.ndarray, enrich: Dict[str, np.ndarray],
                 registry: Dict[str, np.ndarray]) -> int:
    """Stored rows whose enrichment differs from the registry's."""
    if dev.size == 0:
        return 0
    wrong = np.zeros(dev.size, bool)
    for name in ENRICHMENT:
        wrong |= enrich[name] != registry[name][dev]
    return int(wrong.sum())


def outcome_gaps(exp: Outcome, obs: Outcome,
                 ambiguous: np.ndarray) -> Dict[str, float]:
    """The sampled-device numbers: ``stored_wrong``, ``alerts_wrong``,
    ``state_changes_wrong``, ``state_wrong`` and ``ewma_gap``."""
    keep_e = ~np.isin(exp.alerts[:, 0], ambiguous)
    keep_o = ~np.isin(obs.alerts[:, 0], ambiguous)
    state_wrong = 0
    for name, want in exp.state.items():
        if name == "ewma_values":
            continue
        got = obs.state[name]
        state_wrong += int((np.asarray(got) != np.asarray(want)).sum())
    gap = np.abs(obs.state["ewma_values"].astype(np.float64)
                 - exp.state["ewma_values"].astype(np.float64))
    ewma_gap = float(np.nanmax(gap, initial=0.0))
    if np.isnan(gap).any():
        ewma_gap = float("inf")
    return {
        "stored_wrong": multiset_gap(exp.stored_refs, obs.stored_refs),
        "alerts_wrong": multiset_gap(exp.alerts[keep_e], obs.alerts[keep_o]),
        "state_changes_wrong": int(np.abs(exp.state_changes
                                          - obs.state_changes).sum()),
        "state_wrong": state_wrong,
        "ewma_gap": ewma_gap,
    }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]], List[str]]:
    """``(correct, {name: {value, limit}}, lines)``: correct when every
    number is within its limit (a missing or NaN number fails)."""
    table, lines, ok = {}, [], True
    for name in CHECKS:
        value = numbers.get(name, float("nan"))
        limit = float(limits.get(name, 0.0))
        passed = bool(value <= limit)
        ok &= passed
        table[name] = {"value": value, "limit": limit}
        lines.append(f"check {name} {value} <= {limit} "
                     f"{'ok' if passed else 'FAIL'}")
    return ok, table, lines
