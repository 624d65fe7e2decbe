"""Chart series over stored measurements, the admin chart feed.

Counterpart of ``sitewhere_tpu/analytics/charts.py``: per-measurement
series sorted by time, grouped with one mask per filter and one argsort
per series.  Bucketed series (``bucket_s``) go through the same window
kernel as the queries (:func:`.windows.aggregate_windows` over a
[series, bucket] grid), on ``device`` (the card unless named), so a chart
bucket and a window query over the same data agree.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from sitewhere_tpu_torch.analytics.windows import aggregate_windows
from sitewhere_tpu_torch.device import DeviceLike, resolve_device
from sitewhere_tpu_torch.schema import EventType, pow2_at_least
from sitewhere_tpu_torch.services.common import ValidationError


def build_chart_series(
    store,
    *,
    device_id: Optional[int] = None,
    assignment_id: Optional[int] = None,
    mtype_ids: Optional[List[int]] = None,
    start_s: Optional[int] = None,
    end_s: Optional[int] = None,
    mtype_name_of=None,
    max_points_per_series: int = 10_000,
    bucket_s: Optional[int] = None,
    agg: str = "mean",
    device: DeviceLike = None,
) -> List[Dict[str, object]]:
    """Per-measurement-type chart series, entries sorted by time.

    ``mtype_ids`` restricts to the requested measurement ids;
    ``mtype_name_of`` maps handles back to names.  Series longer than
    ``max_points_per_series`` keep the NEWEST points.  With ``bucket_s``
    each series is downsampled to one entry per epoch-aligned bucket
    (``agg`` picks count/sum/mean/min/max/std/rate) and entries carry
    ``count`` too."""
    dev = resolve_device(device)
    ts: List[np.ndarray] = []
    vals: List[np.ndarray] = []
    mts: List[np.ndarray] = []
    for cols in store.iter_chunks():
        mask = cols["event_type"] == int(EventType.MEASUREMENT)
        if device_id is not None:
            mask &= cols["device_id"] == device_id
        if assignment_id is not None:
            mask &= cols["assignment_id"] == assignment_id
        if start_s is not None:
            mask &= cols["ts_s"] >= start_s
        if end_s is not None:
            mask &= cols["ts_s"] <= end_s
        if mtype_ids:
            mask &= np.isin(cols["mtype_id"], mtype_ids)
        ts.append(cols["ts_s"][mask])
        vals.append(cols["value"][mask])
        mts.append(cols["mtype_id"][mask])
    if not ts:
        return []
    ts_all = np.concatenate(ts)
    vals_all = np.concatenate(vals)
    mts_all = np.concatenate(mts)
    if bucket_s is not None:
        return _bucketed_series(ts_all, vals_all, mts_all, int(bucket_s),
                                agg, mtype_name_of, max_points_per_series,
                                dev)

    series: List[Dict[str, object]] = []
    for mtype in np.unique(mts_all):
        sel = mts_all == mtype
        order = np.argsort(ts_all[sel], kind="stable")
        t = ts_all[sel][order][-max_points_per_series:]
        v = vals_all[sel][order][-max_points_per_series:]
        name = (mtype_name_of(int(mtype)) if mtype_name_of is not None
                else None)
        series.append({
            "measurement_id": int(mtype),
            "measurement_name": name,
            "entries": [{"ts_s": int(a), "value": float(b)}
                        for a, b in zip(t, v)],
        })
    return series


def _bucketed_series(ts_all, vals_all, mts_all, bucket_s: int, agg: str,
                     mtype_name_of, max_points: int, dev: torch.device):
    """Downsample through the window kernel: the series axis plays the
    grid's device axis, buckets are epoch-aligned windows."""
    if bucket_s <= 0:
        raise ValidationError("bucketS must be > 0")
    if len(ts_all) == 0:
        return []
    uniq = np.unique(mts_all)
    sidx = np.searchsorted(uniq, mts_all).astype(np.int32)
    w0 = int(ts_all.min()) // bucket_s
    win = (ts_all.astype(np.int64) // bucket_s - w0).astype(np.int32)
    # the grid is dense over the bucketed span: bound it per request
    if int(win.max()) >= (1 << 16):
        raise ValidationError(
            f"bucketS={bucket_s} over this time span needs "
            f"{int(win.max()) + 1} buckets (max {1 << 16}); use a "
            "coarser bucket or a startDate/endDate range")
    n_series = pow2_at_least(len(uniq), floor=1)
    n_windows = pow2_at_least(int(win.max()) + 1, floor=64)
    grid = aggregate_windows(
        torch.from_numpy(sidx).to(dev), torch.from_numpy(win).to(dev),
        torch.from_numpy(vals_all.astype(np.float32)).to(dev),
        torch.ones(len(ts_all), dtype=torch.bool, device=dev),
        n_devices=n_series, n_windows=n_windows)
    values = grid.aggregate(agg, window_s=bucket_s).cpu().numpy()
    counts = grid.counts.cpu().numpy()
    series: List[Dict[str, object]] = []
    for i, mtype in enumerate(uniq):
        occupied = np.nonzero(counts[i] > 0)[0][-max_points:]
        name = (mtype_name_of(int(mtype)) if mtype_name_of is not None
                else None)
        series.append({
            "measurement_id": int(mtype),
            "measurement_name": name,
            "bucket_s": bucket_s,
            "agg": agg,
            "entries": [{"ts_s": int((w0 + w) * bucket_s),
                         "value": float(values[i, w]),
                         "count": int(counts[i, w])}
                        for w in occupied],
        })
    return series


__all__ = ["build_chart_series"]
