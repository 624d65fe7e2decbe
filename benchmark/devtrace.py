"""The device trace of a ``--trace 1`` run.

``torch.profiler`` records the card's kernels and copies (CUDA activity
only, so the host pays nothing per operation) over a steady sub-window of
the measured window.  Busy time is the union of their intervals; a
marker kernel on a side stream at each end ties the trace's clock to the
host's, so each idle gap is named by the harness's spans the host was in
(``HostSpans``): handing a batch over, or the sink taking a plan.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

MARKER = "spin_kernel"          # torch.cuda._sleep's kernel
PIP_KERNEL = "pip_parity_kernel"
NAME_CHARS = 160
GAP_MIN_S = 20e-6


class HostSpans:
    """Host spans recorded while ``on``, by the harness's own code: the
    feeder around each ``ingest_arrays`` call (``intake``) and the sink
    around each append (``sink``).  Nothing of the program is wrapped."""

    def __init__(self):
        self.on = False
        self.spans: List[Tuple[int, str, float, float]] = []

    def record(self, name: str, t0: float, t1: float) -> None:
        if self.on:
            self.spans.append((threading.get_ident(), name, t0, t1))

    def at(self, t: float) -> str:
        """The spans open at host time ``t``, innermost per thread."""
        if not hasattr(self, "_starts"):
            self.spans.sort(key=lambda s: s[2])
            self._starts = [s[2] for s in self.spans]
            self._longest = max((s[3] - s[2] for s in self.spans),
                                default=0.0)
        open_by_thread: Dict[int, Tuple[float, str]] = {}
        j = bisect.bisect_right(self._starts, t) - 1
        while j >= 0 and self._starts[j] >= t - self._longest:
            tid, name, a, b = self.spans[j]
            if b >= t and tid not in open_by_thread:
                open_by_thread[tid] = (a, name)
            j -= 1
        names = sorted({name for _, name in open_by_thread.values()})
        return "+".join(names) if names else "host_outside_spans"


def warm_profiler(torch) -> None:
    """First profiler use initialises CUPTI: pay it in set-up."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def capture(torch, seconds: float, step_count, spans: Optional[HostSpans]):
    """Profile the card for ``seconds`` from this thread, between two
    markers.  The profiler stops, and its trace is read, in
    :func:`read_capture` once the window has closed: both hold the
    interpreter lock for seconds."""
    from torch.profiler import ProfilerActivity, profile

    side = torch.cuda.Stream()
    marks = []

    def mark():
        with torch.cuda.stream(side):
            marks.append(time.perf_counter())
            torch.cuda._sleep(100)

    prof = profile(activities=[ProfilerActivity.CUDA])
    t_start = time.perf_counter()
    prof.start()
    if spans is not None:
        spans.on = True
    # the trace can miss a kernel launched as it starts: a first marker
    # only opens it, the last two tie the clocks
    mark()
    time.sleep(0.01)
    steps0 = step_count()
    t0 = time.perf_counter()
    mark()
    time.sleep(seconds)
    mark()
    t1 = time.perf_counter()
    steps1 = step_count()
    if spans is not None:
        spans.on = False
    return {"prof": prof, "t0": t0, "t1": t1, "marks": marks,
            "steps": steps1 - steps0, "t_start": t_start}


def read_capture(cap, spans: Optional[HostSpans]):
    """The summary of a :func:`capture`, or None without device events."""
    t = time.perf_counter()
    cap["prof"].stop()
    stop_s = time.perf_counter() - t
    events = []
    for e in cap["prof"].events():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        tr = e.time_range
        events.append((e.name, tr.start * 1e-6, tr.end * 1e-6))
    out = summarize(events, cap["t0"], cap["t1"], cap["marks"], cap["steps"],
                    spans, cap["t_start"])
    if out is not None:
        out["stop_s"] = stop_s
    return out


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def summarize(events, t0: float, t1: float, marks: List[float], steps: int,
              spans: Optional[HostSpans], t_start: float):
    """Device events ``(name, start_s, end_s)`` (trace clock: seconds from
    the profiler's start) into busy time, kernel and copy time, the
    geofence kernel's launches and the breakdown, over ``[t0, t1]`` (host
    clock)."""
    markers = sorted(a for name, a, _ in events if MARKER in name)
    work = [(n, a, b) for n, a, b in events if MARKER not in n]
    aligned = len(markers) >= 2 and len(marks) >= 2
    if aligned:
        # device start of each of the last two markers ~ its host launch
        offset = ((marks[-2] - markers[-2]) + (marks[-1] - markers[-1])) / 2
    else:
        # the trace clock starts about when the profiler did
        offset = t_start
    lo, hi = t0 - offset, t1 - offset
    work = [(n, max(a, lo), min(b, hi)) for n, a, b in work
            if b > lo and a < hi]
    if not work:
        return None
    window = t1 - t0
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    copy_s = kernel_s = 0.0
    for n, a, b in work:
        d = b - a
        rec = by_name[n[:NAME_CHARS]]
        rec[0] += d
        rec[1] += 1
        if n.startswith(("Memcpy", "Memset")):
            copy_s += d
        else:
            kernel_s += d
    busy = _union((a, b) for _, a, b in work)
    pip = [(rec[0], rec[1]) for n, rec in by_name.items() if PIP_KERNEL in n]
    device_ops = sorted(([n, rec[0]] for n, rec in by_name.items()),
                        key=lambda r: -r[1])[:10]
    idle = []
    if aligned and spans is not None:
        gaps: Dict[str, float] = defaultdict(float)
        end = lo
        for _, a, b in sorted(work, key=lambda w: w[1]) + [("", hi, hi)]:
            if a - end >= GAP_MIN_S:
                gaps[spans.at((a + end) / 2 + offset)] += a - end
            end = max(end, b)
        idle = sorted(([n, s] for n, s in gaps.items()),
                      key=lambda r: -r[1])[:10]
    return {
        "window_s": window, "busy_s": busy, "kernel_s": kernel_s,
        "copy_s": copy_s, "steps": steps,
        "pip_s": sum(p[0] for p in pip), "pip_launches": sum(p[1] for p in pip),
        "device_ops": device_ops, "idle_gaps": idle,
        "aligned": aligned, "markers": len(markers),
    }
