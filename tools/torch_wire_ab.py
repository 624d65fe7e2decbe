#!/usr/bin/env python3
"""Two trees' wire throughput on one card, for a parent/change comparison.

Imports ``chip_smoke.py`` from the tree it is given (the tree's own
``sitewhere_tpu_torch`` with it), builds ``dispatcher_wire``'s world and
payloads, and runs two of that phase's timed runs ``--reps`` times each:
``throughput_ring8`` (the 24 mixed 60/30/10 payloads at ring depth 8, 5 ms
deadline) and ``measurements_ring0`` (the 24 measurement-only payloads,
ring off).  One JSON line per run, tagged with ``label``; the last line
sums the runs by name.

``--guards-off`` (a tree with the device guards only) runs every
repetition twice, once as the tree stands and once with the dispatcher's
per-dispatch guard work stubbed: the watchdog's begin/end/check, the
breaker's chain gate and success record, and the host-copy wrapper.  The
two then differ by that work alone, inside one process.

Run parent and change alternately, each in its own process, on one card:

    python3 tools/torch_wire_ab.py scratch/parent parent --reps 3
    python3 tools/torch_wire_ab.py . change --reps 3 --guards-off
    python3 tools/torch_wire_ab.py . change --reps 3 --guards-off
    python3 tools/torch_wire_ab.py scratch/parent parent --reps 3

where ``scratch/parent`` is the parent commit unpacked with
``git archive`` into a git-ignored directory.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import json
import logging
import os
import shutil
import statistics
import sys
import tempfile
import time


class _NoWatchdog:
    soft_s = hard_s = float("inf")
    unhealthy = False

    def begin(self, payload, parts=1):
        return None

    def end(self, token):
        pass

    def check(self):
        pass

    def snapshot(self):
        return {}


class _NoBreaker:
    level = 0
    threshold = 1 << 30

    def allow_chain(self):
        return True

    def record_success(self, chained=False):
        pass

    def record_fault(self, seq):
        return False

    def snapshot(self):
        return {}


def _strip_guards(disp):
    """The dispatcher with its per-dispatch guard work stubbed."""
    disp.watchdog = _NoWatchdog()
    disp.breaker = _NoBreaker()
    syncs = disp._m_host_syncs.inc
    disp._host_copy = lambda make, oi, metrics: make(oi, metrics,
                                                     on_fetch=syncs)
    return disp


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", help="root of the tree to import")
    ap.add_argument("label", help="tag of every printed line")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--guards-off", action="store_true",
                    help="also run each repetition with the guards stubbed")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    # the runs' per-line registration refusals would flood the output
    logging.disable(logging.WARNING)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from sitewhere_tpu_torch import native
    from sitewhere_tpu_torch.device import resolve_device
    from sitewhere_tpu_torch.ops import geo_cuda

    label = args.label
    runs = []

    def tagged(obj):
        if "events_per_s" in obj:
            runs.append(obj)
        print(json.dumps(dict(obj, ab=label)), flush=True)

    cs.emit = tagged
    t0 = time.perf_counter()
    device = resolve_device()
    print(cs.nvidia_smi_line(), flush=True)
    geo_cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for b in [pool.submit(geo_cuda.library),
                  pool.submit(native.load_swwire)]:
            b.result()
    world = cs.make_wire_world(device)
    rng = np.random.default_rng(cs.SEED + 6)
    payloads = cs.wire_payloads(rng, cs.WIRE_PAYLOADS, cs.FULL_B,
                                cs.WIRE_TS0_MS)
    cs.wire_payloads(rng, cs.PACED_PAYLOADS + cs.PACED_BURST,
                     cs.PACED_LINES, cs.WIRE_TS0_MS + 10_000_000)
    meas = cs.measurement_payloads(rng, cs.WIRE_PAYLOADS, cs.FULL_B,
                                   cs.WIRE_TS0_MS + 20_000_000)
    import sitewhere_tpu_torch

    tagged({"phase": "ab", "run": "setup",
            "package": os.path.dirname(sitewhere_tpu_torch.__file__),
            "seconds": time.perf_counter() - t0})
    make = cs.make_wire_dispatcher
    root = tempfile.mkdtemp(prefix="ab-", dir=geo_cuda.BUILD_DIR)
    try:
        for rep in range(args.reps):
            modes = [False]
            if args.guards_off:
                # alternate which mode goes first
                modes = [False, True] if rep % 2 == 0 else [True, False]
            for off in modes:
                cs.make_wire_dispatcher = (
                    (lambda *a, **k: _strip_guards(make(*a, **k)))
                    if off else make)
                suffix = ".guards_off" if off else ""
                run = f"throughput_ring{cs.RING_K}"
                cs.wire_throughput(device, geo_cuda, world, payloads,
                                   cs.RING_K, cs.WIRE_DEADLINE_MS,
                                   os.path.join(root, f"{run}{rep}{off}"),
                                   run + suffix)
                run = "measurements_ring0"
                cs.wire_throughput(device, geo_cuda, world, meas, 0,
                                   cs.WIRE_DEADLINE_MS,
                                   os.path.join(root, f"{run}{rep}{off}"),
                                   run + suffix, meas=True)
                torch.cuda.synchronize()
    finally:
        cs.make_wire_dispatcher = make
        shutil.rmtree(root, ignore_errors=True)
    by_run = collections.defaultdict(list)
    for r in runs:
        by_run[r["run"]].append(r["events_per_s"])
    tagged({"phase": "ab", "run": "summary",
            "runs_events_per_s": dict(by_run),
            "mean_events_per_s": {k: statistics.fmean(v)
                                  for k, v in by_run.items()},
            "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
