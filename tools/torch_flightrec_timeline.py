#!/usr/bin/env python
"""Render a flight-recorder snapshot of the PyTorch port as a per-batch
stage timeline.

Counterpart of ``tools/flightrec_timeline.py``; it reads the snapshot
format of ``sitewhere_tpu_torch.runtime.flightrec`` (the reference's).

A snapshot (``<data_dir>/flightrec/NNNNNN-<reason>.jsonl``, or the
``/api/instance/flightrecorder/snapshots/{name}`` download) holds the
last N per-batch records the dispatcher appended before an anomaly
fired.  This renders them as one line per batch — sequence, commit
outcome, overload state — plus a proportional ASCII bar splitting the
end-to-end latency into wait / dispatch / egress, so "what was the
pipeline doing when it broke" reads at a glance instead of as raw JSON.

Usage::

    python tools/torch_flightrec_timeline.py path/to/000003-egress-crash.jsonl
    python tools/torch_flightrec_timeline.py snap.jsonl --limit 40
    python tools/torch_flightrec_timeline.py --url \\
        http://127.0.0.1:8080/api/instance/flightrecorder/snapshots/000003-egress-crash.jsonl

Failed commits render with a ``!!`` marker and their error; the bar
legend is ``w`` batcher wait, ``d`` step dispatch, ``e`` egress, ``·``
unattributed (device dwell + queueing between stages).

Besides per-batch rows the ring also holds EVENT records carrying a
``kind`` field — the device-fault containment plane appends them on its
cold paths (``hung-step`` plans caught in flight by the watchdog,
``quarantine`` strikes from the nonfinite scan).  These render as
``**``-marked event lines in sequence with the batches instead of being
dropped as unknown records, so a ``device-hung-step`` /
``device-quarantine`` / ``device-fault`` snapshot shows WHAT tripped
amid the batches around it.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BAR_WIDTH = 40


def _bar(rec: dict) -> str:
    """Proportional stage bar over the record's e2e latency."""
    e2e = max(float(rec.get("e2e_ms", 0.0)), 1e-9)
    cells = []
    for key, ch in (("wait_ms", "w"), ("dispatch_ms", "d"),
                    ("egress_ms", "e")):
        n = int(round(min(1.0, float(rec.get(key, 0.0)) / e2e) * BAR_WIDTH))
        cells.append(ch * n)
    bar = "".join(cells)[:BAR_WIDTH]
    return bar + "·" * (BAR_WIDTH - len(bar))


def _event_line(rec: dict) -> str:
    """One ``**`` event line for a kind-style ring record (hung-step,
    quarantine, …): seq/slot/rows columns stay aligned with the batch
    rows; everything else folds into a key=value tail so unknown kinds
    still render complete instead of being dropped."""
    kind = rec["kind"]
    slot = rec.get("slot")
    extras = {k: v for k, v in rec.items()
              if k not in ("kind", "seq", "slot", "rows", "ts")}
    tail = " ".join(f"{k}={v}" for k, v in sorted(extras.items()))
    return (f"{rec.get('seq', -1):>6} "
            f"{'-' if slot is None else slot:>4} "
            f"{rec.get('rows', 0):>6} "
            f"{'':>9} {'':>9}  ** {kind}"
            + (f": {tail}" if tail else ""))


def render(snapshot: dict, limit: int = 100, out=sys.stdout) -> None:
    header = snapshot["header"]
    records = snapshot["records"][-limit:]
    print(f"flight-recorder snapshot: reason={header.get('reason')} "
          f"records={header.get('records')} "
          f"{('detail=' + str(header.get('detail'))) if header.get('detail') else ''}",
          file=out)
    print(f"{'seq':>6} {'slot':>4} {'rows':>6} {'ovl':<9} "
          f"{'e2e_ms':>9}  {'timeline (w=wait d=dispatch e=egress)':<{BAR_WIDTH}}"
          f"  commit", file=out)
    events = 0
    for rec in records:
        if rec.get("kind"):
            events += 1
            print(_event_line(rec), file=out)
            continue
        slot = rec.get("slot")
        mark = "!!" if rec.get("commit") != "ok" else "  "
        line = (f"{rec.get('seq', -1):>6} "
                f"{'-' if slot is None else slot:>4} "
                f"{rec.get('rows', 0):>6} "
                f"{str(rec.get('overload', '?')):<9} "
                f"{float(rec.get('e2e_ms', 0.0)):>9.3f}  "
                f"{_bar(rec)}  {mark}{rec.get('commit', '?')}")
        if rec.get("error"):
            line += f"  [{rec['error']}]"
        print(line, file=out)
    batches = len(records) - events
    failed = sum(1 for r in records
                 if not r.get("kind") and r.get("commit") != "ok")
    tail = f", {events} events" if events else ""
    print(f"{batches} batches shown, {failed} failed commits{tail}",
          file=out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="render a flight-recorder JSONL snapshot as a timeline")
    parser.add_argument("path", nargs="?",
                        help="snapshot .jsonl file")
    parser.add_argument("--url",
                        help="fetch the snapshot over HTTP instead "
                             "(the REST download endpoint)")
    parser.add_argument("--limit", type=int, default=100,
                        help="newest N records to render")
    args = parser.parse_args(argv)

    from sitewhere_tpu_torch.runtime.flightrec import parse_snapshot

    if args.url:
        import urllib.request

        with urllib.request.urlopen(args.url, timeout=10) as resp:
            data = resp.read()
    elif args.path:
        with open(args.path, "rb") as f:
            data = f.read()
    else:
        parser.error("pass a snapshot path or --url")
        return 2
    try:
        snapshot = parse_snapshot(data)
    except ValueError as e:
        print(f"not a valid flight-recorder snapshot: {e}",
              file=sys.stderr)
        return 1
    render(snapshot, limit=args.limit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
