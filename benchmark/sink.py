"""The event store the dispatcher egresses into: the benchmark's sink.

It reads the five enrichment columns of every plan, as the segment
store's append does (the pattern of ``chip_smoke.py:1088``
``CountingStore``), counts what it stores, and keeps what the comparison
and the latency need: for each plan, when it arrived and which stream
rows it held; for the sampled devices, every row stored.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from benchmark.generator import ALERT, DERIVED_CODE_MIN, STATE_CHANGE
from benchmark.reference.plain import ENRICHMENT, Outcome

# per plan: arrival (perf_counter s), first and last stream row, stream
# rows, all rows, the first stream row a derived alert came from, derived
# alerts, STATE_CHANGE rows
PLAN_FIELDS = ("t", "lo", "hi", "n_stream", "n_all", "derived_lo",
               "n_derived", "n_state_changes")
KEPT = ("payload_ref", "device_id", "event_type", "alert_code",
        "alert_level", "ts_s", "ts_ns") + ENRICHMENT


class Sink:
    """``append_columns(cols, mask=)`` and ``flush()``, as the dispatcher's
    ``event_store`` takes them."""

    def __init__(self, sampled: np.ndarray, spans=None):
        # indexed by device handle; the extra last entry (False) takes the
        # null handle -1
        self.sampled = sampled
        self.spans = spans
        self.plans: List[tuple] = []
        self.kept: List[Dict[str, np.ndarray]] = []
        self.stored_stream_rows = 0

    def append_columns(self, cols, mask=None) -> None:
        t = time.perf_counter()
        for name in ENRICHMENT:
            cols[name]
        ref = cols["payload_ref"]
        et = cols["event_type"]
        derived = (cols["alert_code"] >= DERIVED_CODE_MIN) & (et == ALERT)
        changes = et == STATE_CHANGE
        stream = (ref >= 0) & ~derived & ~changes
        n_all = int(np.count_nonzero((ref >= 0) | changes))
        sref = ref[stream]
        dref = ref[derived]
        if mask is None:
            mask = np.ones(ref.shape, bool)
        self.stored_stream_rows += int(np.count_nonzero(mask & stream))
        self.plans.append((
            t,
            int(sref.min()) if sref.size else -1,
            int(sref.max()) if sref.size else -1,
            int(sref.size), n_all,
            int(dref.min()) if dref.size else -1,
            int(dref.size), int(np.count_nonzero(changes))))
        keep = self.sampled[cols["device_id"]] & mask
        if keep.any():
            self.kept.append({name: np.asarray(cols[name])[keep]
                              for name in KEPT})
        if self.spans is not None:
            self.spans.record("sink", t, time.perf_counter())

    def flush(self) -> None:
        pass

    def plan_table(self) -> np.ndarray:
        return np.asarray(self.plans, np.float64).reshape(-1, len(PLAN_FIELDS))

    def observed(self, sample: np.ndarray, state: Dict[str, np.ndarray]):
        """The program's outcome for the sampled devices, in the
        reference's form, and the stored rows' devices and enrichment."""
        kept = {name: (np.concatenate([k[name] for k in self.kept])
                       if self.kept else np.zeros(0, np.int64))
                for name in KEPT}
        ref = kept["payload_ref"].astype(np.int64)
        et, code = kept["event_type"], kept["alert_code"]
        derived = (code >= DERIVED_CODE_MIN) & (et == ALERT)
        changes = et == STATE_CHANGE
        stream = ~derived & ~changes
        alerts = np.stack([ref[derived], code[derived],
                           kept["alert_level"][derived],
                           kept["ts_s"][derived], kept["ts_ns"][derived]],
                          axis=1).astype(np.int64).reshape(-1, 5)
        c = np.searchsorted(sample, kept["device_id"][changes])
        state_changes = np.bincount(c, minlength=sample.size).astype(np.int64)
        out = Outcome(stored_refs=np.sort(ref[stream]), alerts=alerts,
                      state_changes=state_changes, state=state)
        enrich = {name: kept[name] for name in ENRICHMENT}
        return out, kept["device_id"].astype(np.int64), enrich
