#!/usr/bin/env python
"""swlint CLI for the PyTorch port: run the project-invariant
static-analysis suite (``sitewhere_tpu_torch.analysis``).

    python tools/torch_swlint.py sitewhere_tpu_torch/         # lint + baseline
    python tools/torch_swlint.py sitewhere_tpu_torch/ --json  # machine output
    python tools/torch_swlint.py sitewhere_tpu_torch/ --update-baseline
    python tools/torch_swlint.py path/to/file.py --no-baseline
    python tools/torch_swlint.py --list-passes

Exit codes: 0 = clean (every finding suppressed by the baseline),
1 = unsuppressed findings, 2 = usage/config error.  Stale baseline
entries (suppressions that no longer fire) are reported as notes and
never fail the run — delete them when convenient, the worklist is
supposed to shrink.

``--update-baseline`` rewrites the baseline from the CURRENT findings,
preserving existing justifications by fingerprint; new entries get a
``TODO: justify`` note that a reviewer must replace — a baseline entry
without a reason is a bug report, not a suppression.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

from sitewhere_tpu_torch.analysis import (  # noqa: E402
    Baseline,
    PASS_FACTORIES,
    Project,
    default_baseline_path,
    run_suite,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="swlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("paths", nargs="*", help="package dirs / files to lint")
    ap.add_argument("--baseline", default=None,
                    help="suppression file (default: "
                         "tools/torch_swlint_baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, suppress nothing")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings "
                         "(keeps existing justifications)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="JSON output (findings + suppressed + stale)")
    ap.add_argument("--passes", default=None,
                    help="comma-separated pass ids to run (default: all)")
    ap.add_argument("--list-passes", action="store_true")
    args = ap.parse_args(argv)

    if args.list_passes:
        for pass_id in PASS_FACTORIES:
            print(pass_id)
        return 0
    if not args.paths:
        ap.error("no paths given (try: python tools/torch_swlint.py "
                 "sitewhere_tpu_torch/)")
    for p in args.paths:
        if not os.path.exists(p):
            print(f"swlint: no such path: {p}", file=sys.stderr)
            return 2

    if args.no_baseline and args.update_baseline:
        print("swlint: --no-baseline with --update-baseline would reset "
              "every justification; refusing", file=sys.stderr)
        return 2

    passes = None
    if args.passes:
        wanted = [s.strip() for s in args.passes.split(",") if s.strip()]
        unknown = [w for w in wanted if w not in PASS_FACTORIES]
        if unknown:
            print(f"swlint: unknown passes {unknown}; known: "
                  f"{list(PASS_FACTORIES)}", file=sys.stderr)
            return 2
        passes = [PASS_FACTORIES[w]() for w in wanted]

    # Anchor the project root at the REPO whenever every path is inside
    # it: finding fingerprints embed project-relative paths, so a
    # subset run (`torch_swlint.py sitewhere_tpu_torch/runtime`) must
    # produce the SAME fingerprints as the full run or the checked-in
    # baseline stops matching (and --update-baseline would shred it).
    paths_abs = [os.path.abspath(p) for p in args.paths]
    root = _REPO if all(p == _REPO or p.startswith(_REPO + os.sep)
                        for p in paths_abs) else None
    project = Project.from_paths(paths_abs, root=root)
    findings = run_suite(paths_abs, passes=passes, project=project)

    baseline_path = args.baseline or default_baseline_path()
    if args.no_baseline:
        baseline = Baseline()
    else:
        try:
            baseline = Baseline.load(baseline_path)
        except (ValueError, OSError) as e:
            print(f"swlint: bad baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2

    if args.update_baseline:
        updated = Baseline.from_findings(findings, old=baseline)
        # A NARROWED run (subset of passes, or a path subset) must not
        # delete baseline entries it never re-checked: keep every old
        # entry whose pass did not run or whose file was not scanned.
        run_pass_ids = {p.pass_id for p in
                        (passes if passes is not None
                         else [f() for f in PASS_FACTORIES.values()])}
        scanned = {m.rel for m in project.modules.values()}
        have = updated.fingerprints
        for e in baseline.entries:
            # an unscanned path only protects the entry while the file
            # still EXISTS — entries for deleted/renamed modules must
            # drop here, or update-baseline could never shrink the file
            path_out = (e.get("path") not in scanned
                        and os.path.exists(
                            os.path.join(project.root, str(e.get("path")))))
            out_of_scope = e.get("pass") not in run_pass_ids or path_out
            if out_of_scope and str(e["fp"]) not in have:
                updated.entries.append(e)
        updated.save(baseline_path)
        print(f"swlint: baseline updated: {len(updated.entries)} entries "
              f"-> {baseline_path}")
        todo = sum(1 for e in updated.entries
                   if str(e.get("note", "")).startswith("TODO"))
        if todo:
            print(f"swlint: {todo} entries need a justification "
                  "(note starts with TODO)")
        return 0

    unsuppressed, suppressed, stale = baseline.apply(findings)

    if args.as_json:
        print(json.dumps({
            "findings": [f.to_dict() for f in unsuppressed],
            "suppressed": [f.to_dict() for f in suppressed],
            "stale_baseline_entries": stale,
            "counts": {
                "unsuppressed": len(unsuppressed),
                "suppressed": len(suppressed),
                "stale": len(stale),
            },
        }, indent=1))
    else:
        for f in unsuppressed:
            print(f.format())
        if stale:
            print(f"\nswlint: {len(stale)} stale baseline entr"
                  f"{'y' if len(stale) == 1 else 'ies'} (no longer "
                  "firing — prune when convenient):")
            for e in stale:
                print(f"  - [{e['pass']}/{e['rule']}] {e['qualname']}: "
                      f"{e.get('note', '')}")
        print(f"\nswlint: {len(unsuppressed)} finding"
              f"{'' if len(unsuppressed) == 1 else 's'}, "
              f"{len(suppressed)} suppressed by baseline")
    return 1 if unsuppressed else 0


if __name__ == "__main__":
    sys.exit(main())
