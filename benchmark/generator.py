"""Traffic: one general generator, driven by a mix file of parameters.

The per-batch columns are a frozen copy of ``make_batch_cols``
(``chip_smoke.py:796``), generalized to the parameters a mix file gives:
the event-type shares, the bad-row shares, the value and coordinate
ranges, the span of event time one batch covers and the pool size.
Rows are pre-resolved columns as ``PipelineDispatcher.ingest_arrays``
takes them (dense device handles, one tenant).

Set-up draws a pool of distinct full-width batches from ``--seed``; the
stream cycles the pool and moves event time forward with every batch,
so batch ``n`` is pool batch ``n % pool`` with ``ts_s`` shifted by
``n * batch_span_s`` and ``payload_ref`` the row's position in the
stream (``n * width + i``), which the sink and the reference key on.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

MEASUREMENT, LOCATION, ALERT, STATE_CHANGE = 0, 1, 2, 5
EVENT_CODES = {"measurement": MEASUREMENT, "location": LOCATION,
               "alert": ALERT}
TS0 = 1_700_000_000
# Alert codes a device sends lie below this; the world's rule and zone
# alert codes lie at or above it, so a stored ALERT row at or above it is
# a derived alert (see ``world.py``).
DERIVED_CODE_MIN = 1000

# Columns handed to ``ingest_arrays`` besides ``ts_s`` and ``payload_ref``,
# which the stream makes per batch.
POOL_COLUMNS = ("device_id", "event_type", "ts_ns", "mtype_id", "value",
                "lat", "lon", "elevation", "alert_code", "alert_level")


def seed_rng(seed: int, salt: int) -> np.random.Generator:
    """A NumPy generator for ``seed`` (any whole number) and a salt."""
    return np.random.default_rng([int(seed) % (1 << 64), salt])


def make_batch_cols(rng, width: int, mix: Dict, n_devices: int,
                    capacity: int, mtype_slots: int) -> Dict[str, np.ndarray]:
    """One batch of pre-resolved columns.  Devices are uniform over the
    ``n_devices`` registered ones; ``unregistered_share`` of the rows name
    a slot in range that no device holds, ``invalid_share`` a handle out
    of range (the batcher nulls it), and ``nonfinite_share`` carry a NaN
    value.  Event time within the batch is an offset below
    ``batch_span_s`` (``ts_off``) and a nanosecond below ``ts_ns_max``."""
    dev = rng.integers(0, n_devices, width).astype(np.int32)
    u = rng.random(width)
    unreg_share = mix["unregistered_share"]
    unreg = u < unreg_share
    invalid = (u >= unreg_share) & (u < unreg_share + mix["invalid_share"])
    if capacity > n_devices:
        dev[unreg] = rng.integers(n_devices, capacity, int(unreg.sum()))
    dev[invalid] = np.where(rng.random(int(invalid.sum())) < 0.5, -7,
                            capacity + 11)
    kinds = list(mix["event_mix"])
    etype = np.asarray([EVENT_CODES[k] for k in kinds], np.int32)[
        rng.choice(len(kinds), width, p=[mix["event_mix"][k] for k in kinds])]
    lo, hi = mix["value_range"]
    value = rng.uniform(lo, hi, width).astype(np.float32)
    value[rng.random(width) < mix["nonfinite_share"]] = np.nan
    elo, ehi = mix["elevation_range"]
    span = int(mix["batch_span_s"])
    return dict(
        device_id=dev,
        event_type=etype,
        ts_off=(rng.integers(0, span, width).astype(np.int32) if span > 1
                else np.zeros(width, np.int32)),
        ts_ns=rng.integers(0, mix["ts_ns_max"], width).astype(np.int32),
        mtype_id=rng.integers(0, mtype_slots, width).astype(np.int32),
        value=value,
        lat=rng.uniform(*mix["lat_range"], width).astype(np.float32),
        lon=rng.uniform(*mix["lon_range"], width).astype(np.float32),
        elevation=rng.uniform(elo, ehi, width).astype(np.float32),
        alert_code=np.where(etype == ALERT,
                            rng.integers(0, mix["alert_codes"], width),
                            -1).astype(np.int32),
        alert_level=rng.integers(0, 4, width).astype(np.int32),
    )


class Stream:
    """The cell's event stream: a pool of ``mix["pool_batches"]`` batches
    drawn from the seed, cycled with event time moving forward."""

    def __init__(self, seed: int, width: int, mix: Dict, n_devices: int,
                 capacity: int, mtype_slots: int):
        self.width = width
        self.span = int(mix["batch_span_s"])
        rng = seed_rng(seed, 1)
        self.pool: List[Dict[str, np.ndarray]] = [
            make_batch_cols(rng, width, mix, n_devices, capacity,
                            mtype_slots)
            for _ in range(int(mix["pool_batches"]))]
        self._arange = np.arange(width, dtype=np.int32)

    def columns(self, n: int) -> Dict[str, np.ndarray]:
        """Stream batch ``n`` as ``ingest_arrays`` keyword columns; the pool
        columns are shared, ``ts_s`` and ``payload_ref`` are fresh."""
        p = self.pool[n % len(self.pool)]
        cols = {f: p[f] for f in POOL_COLUMNS}
        cols["ts_s"] = p["ts_off"] + np.int32(TS0 + n * self.span)
        cols["payload_ref"] = self._arange + np.int32(n * self.width)
        return cols

    def rows_of(self, n_batches: int, keep: np.ndarray) -> Dict[str, np.ndarray]:
        """The rows of batches ``[0, n_batches)`` whose device ``keep``
        marks (``keep`` is indexed by device handle, with one extra last
        entry for handles out of range), in stream order, each with its
        ``ref``: the reference's input."""
        cap = keep.shape[0] - 1
        picks = []
        for p in self.pool:
            d = p["device_id"]
            picks.append(np.nonzero(keep[np.where((d >= 0) & (d < cap), d,
                                                  cap)])[0])
        out: Dict[str, List[np.ndarray]] = {f: [] for f in POOL_COLUMNS}
        out["ts_s"], out["ref"] = [], []
        for n in range(n_batches):
            j = n % len(self.pool)
            idx = picks[j]
            p = self.pool[j]
            for f in POOL_COLUMNS:
                out[f].append(p[f][idx])
            out["ts_s"].append(p["ts_off"][idx] + np.int32(TS0 + n * self.span))
            out["ref"].append(idx.astype(np.int64) + n * self.width)
        return {f: (np.concatenate(v) if v else np.zeros(0))
                for f, v in out.items()}

    def accepted_rows(self, n_batches: int, registered: np.ndarray) -> int:
        """Rows of batches ``[0, n_batches)`` whose device is registered
        (``registered`` indexed like ``keep`` above): the rows the sink
        must receive, over every device."""
        cap = registered.shape[0] - 1
        per = []
        for p in self.pool:
            d = p["device_id"]
            per.append(int(registered[np.where((d >= 0) & (d < cap), d,
                                               cap)].sum()))
        full, rest = divmod(n_batches, len(per))
        return full * sum(per) + sum(per[:rest])
