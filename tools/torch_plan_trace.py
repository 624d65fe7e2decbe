#!/usr/bin/env python3
"""Per-plan spans and the served step's device stages in one benchmark cell.

Runs ``benchmark/run.py``'s ``main`` in this process, once per run, with
the dispatcher handed a ``Tracer`` (the harness builds it with the
default, which samples nothing), and prints one JSON line per run, also
appended to ``--out``:

- ``--mode trace``: a ``--trace 1`` run with every plan sampled: the
  result line (``correct``, the per-layer metrics, the device trace's
  busy time and idle gaps), each idle gap named ``<harness span>/<the
  innermost program span open on that thread>``, the tracer's
  ``spans_evicted``, and :func:`plan_readings` of the plans that finished
  egress in the window.
- ``--mode cost``: ``--trace 0`` runs, each seed once with the tracer at
  ``sample_rate`` 1.0 and once at 0.0, in turns: ``events_per_s`` of
  each, the cost of tracing when it is on.

    python3 tools/torch_plan_trace.py --workload geo-10k-sync.tracking \\
        --mode trace --seconds 36 --seeds 3100000401 3100000402 \\
        [--out chiprun_out/plan_trace.jsonl]

The harness exits 2 without the CUDA cards its cell asks for.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import io
import json
import os
import sys
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# program spans that are waits, not work on their thread, and the root
WAITS = frozenset(("pipeline.plan", "batch.wait", "window.wait",
                   "ring.slot"))
SPAN_CAPACITY = 1 << 18


def _active(span) -> bool:
    return (span.end_s is not None and span.name not in WAITS
            and not span.name.startswith("device."))


class ProgramSpans:
    """The innermost active program span open at an instant, by thread."""

    def __init__(self, spans):
        by = defaultdict(list)
        for s in spans:
            if _active(s):
                by[s.thread].append((s.start_s, s.end_s, s.name))
        self._by = {}
        for tid, rows in by.items():
            rows.sort()
            self._by[tid] = ([r[0] for r in rows], rows,
                             max(b - a for a, b, _ in rows))

    def at(self, thread: int, t: float) -> Optional[str]:
        entry = self._by.get(thread)
        if entry is None:
            return None
        starts, rows, longest = entry
        j = bisect.bisect_right(starts, t) - 1
        while j >= 0 and starts[j] >= t - longest:
            _, end, name = rows[j]
            if end >= t:
                return name     # the latest start covering t: innermost
            j -= 1
        return None


def naming_spans(devtrace, tracer):
    """A ``devtrace.HostSpans`` whose ``at`` names what the host was doing
    by the harness's span and the program's innermost span under it."""

    class Named(devtrace.HostSpans):
        def at(self, t: float) -> str:
            if not hasattr(self, "_index"):
                self.spans.sort(key=lambda s: s[2])
                self._index = ([s[2] for s in self.spans],
                               max((s[3] - s[2] for s in self.spans),
                                   default=0.0),
                               ProgramSpans(tracer.finished()))
            starts, longest, program = self._index
            open_by_thread: Dict[int, str] = {}
            j = bisect.bisect_right(starts, t) - 1
            while j >= 0 and starts[j] >= t - longest:
                tid, name, _, end = self.spans[j]
                if end >= t and tid not in open_by_thread:
                    open_by_thread[tid] = name
                j -= 1
            names = set()
            for tid, name in open_by_thread.items():
                inner = program.at(tid, t)
                names.add(f"{name}/{inner}" if inner else name)
            return "+".join(sorted(names)) if names else "host_outside_spans"

    return Named


def _union_within(intervals, lo: float, hi: float) -> float:
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def _stats_ms(values) -> Dict[str, float]:
    v = np.asarray(values, np.float64) * 1e3
    if not v.size:
        return {}
    return {"mean": float(v.mean()), "p50": float(np.percentile(v, 50)),
            "p99": float(np.percentile(v, 99))}


def plan_readings(spans, t0: float, t1: float) -> Dict[str, object]:
    """The plans whose trace root closed in ``[t0, t1]`` (span clock):

    - ``batcher_wait_ms``: mean ``batch.wait``; ``card_wait_ms``: mean
      ``egress.fetch-outputs`` (the host blocked on the card);
      ``zones_device_ms`` and ``state_device_ms``: mean ``device_ms`` of
      ``device.zones`` and ``device.state``; ``device_stage_ms`` each
      device stage's mean and ``device_step_ms`` their sum;
    - ``latency_ms``: the roots (oldest row's receipt to egress end);
      ``stages_ms``: each host stage's and egress leg's mean;
      ``unaccounted_ms``: the mean part of a root no active host span
      covers (the batcher's wait and the window count as covered);
    - ``by_origin``: per origin of the oldest row, plans, latency and
      batcher wait; ``chained_ms``: for a plan whose oldest row was
      re-injected by a plan in the set, from that plan's root start to
      this plan's root end.
    """
    by = defaultdict(list)
    for s in spans:
        by[s.trace_id].append(s)
    plans = []
    for group in by.values():
        roots = [s for s in group if s.name == "pipeline.plan"]
        if len(roots) == 1 and roots[0].end_s is not None \
                and t0 <= roots[0].end_s <= t1:
            plans.append((roots[0], group))
    out: Dict[str, object] = {"plans": len(plans)}
    if not plans:
        return out
    host = defaultdict(list)
    device = defaultdict(list)
    lat, unaccounted = [], []
    origin = defaultdict(lambda: {"lat": [], "wait": []})
    start_of = {}
    source_of = {}
    for root, group in plans:
        seq = root.tags.get("seq")
        start_of[seq] = root.start_s
        dur = root.end_s - root.start_s
        lat.append(dur)
        per = defaultdict(float)
        covered = []
        for s in group:
            if s is root or s.end_s is None:
                continue
            if s.name.startswith("device."):
                device[s.name[7:]].append(s.tags.get("device_ms", 0.0))
                continue
            per[s.name] += s.end_s - s.start_s
            covered.append((s.start_s, s.end_s))
            if s.name == "batch.wait":
                key = s.tags.get("origin", "stream")
                origin[key]["lat"].append(dur)
                origin[key]["wait"].append(s.end_s - s.start_s)
                if s.tags.get("source_seq", -1) >= 0:
                    source_of[seq] = (s.tags["source_seq"], root.end_s)
        for name, d in per.items():
            host[name].append(d)
        unaccounted.append(dur - _union_within(covered, root.start_s,
                                               root.end_s))

    def mean_ms(values):
        return float(np.mean(values)) * 1e3 if values else None

    out["batcher_wait_ms"] = mean_ms(host["batch.wait"])
    out["card_wait_ms"] = mean_ms(host["egress.fetch-outputs"])
    stage_ms = {k: float(np.mean(v)) for k, v in device.items()}
    out["zones_device_ms"] = stage_ms.get("zones")
    out["state_device_ms"] = stage_ms.get("state")
    out["device_stage_ms"] = stage_ms
    out["device_step_ms"] = sum(stage_ms.values()) if stage_ms else None
    out["device_marked_plans"] = len(device.get("zones", ()))
    out["latency_ms"] = _stats_ms(lat)
    out["stages_ms"] = {k: float(np.sum(v)) / len(plans) * 1e3
                        for k, v in sorted(host.items())}
    out["unaccounted_ms"] = mean_ms(unaccounted)
    out["by_origin"] = {k: {"plans": len(v["lat"]),
                            "latency_ms": mean_ms(v["lat"]),
                            "batcher_wait_ms": mean_ms(v["wait"])}
                        for k, v in sorted(origin.items())}
    chained = [end - start_of[src] for src, end in source_of.values()
               if src in start_of]
    out["chained_ms"] = _stats_ms(chained)
    return out


def run_once(workload: str, seed: int, seconds: float, trace: int,
             sample_rate: float, root: Optional[str] = None
             ) -> Dict[str, object]:
    """One ``run.main`` (over the benchmark under ``root``, by default
    this checkout's) with the dispatcher traced at ``sample_rate``."""
    from benchmark import devtrace, driver, run
    from sitewhere_tpu_torch.runtime.tracing import Tracer, span_clock

    tracer = Tracer(sample_rate=sample_rate, capacity=SPAN_CAPACITY)
    seen: Dict[str, object] = {"window": []}
    build, snapshot, host_spans = (driver.build_dispatcher, driver.snapshot,
                                   devtrace.HostSpans)

    def traced_build(*args, **kw):
        disp = build(*args, **kw)
        disp.tracer = tracer
        seen["disp"] = disp
        return disp

    def marked_snapshot(disp):
        # the window's ends: the harness snapshots at its start and end
        seen["window"].append((span_clock(), len(disp.latencies_s)))
        return snapshot(disp)

    driver.build_dispatcher = traced_build
    driver.snapshot = marked_snapshot
    devtrace.HostSpans = naming_spans(devtrace, tracer)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = run.main(["--workload", workload, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace",
                           str(trace)], root=root or run.ROOT)
    finally:
        driver.build_dispatcher = build
        driver.snapshot = snapshot
        devtrace.HostSpans = host_spans
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    record = {"workload": workload, "seed": seed, "trace": trace,
              "sample_rate": sample_rate, "rc": rc, "result": result,
              "spans_evicted": tracer.spans_evicted}
    disp = seen.pop("disp")
    if trace and len(seen["window"]) == 2:
        (t0, n0), (t1, n1) = seen["window"]
        readings = plan_readings(tracer.finished(), t0, t1)
        program = list(disp.latencies_s)[n0:n1]
        readings["program_latency_ms"] = _stats_ms(program)
        readings["window_s"] = t1 - t0
        record["readings"] = readings
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=("trace", "cost"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=36.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    runs = []
    for i, seed in enumerate(args.seeds):
        if args.mode == "trace":
            runs.append((seed, 1, 1.0))
        else:
            rates = (1.0, 0.0) if i % 2 == 0 else (0.0, 1.0)
            runs.extend((seed, 0, rate) for rate in rates)
    for seed, trace, rate in runs:
        record = run_once(args.workload, seed, args.seconds, trace, rate)
        line = json.dumps(record)
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
