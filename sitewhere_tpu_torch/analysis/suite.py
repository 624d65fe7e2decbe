"""swlint suite: run every pass over a tree, apply the baseline.

This is what both the ``tools/torch_swlint.py`` CLI and the
``tests/test_torch_swlint.py`` gate call — one code path, so "the repo is
clean in CI" and "the repo is clean at the command line" can never
disagree.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

from sitewhere_tpu_torch.analysis.core import Baseline, Finding, Project
from sitewhere_tpu_torch.analysis.donation import DonationPass
from sitewhere_tpu_torch.analysis.hotpath import HotPathAllocationPass
from sitewhere_tpu_torch.analysis.locks import LockDisciplinePass
from sitewhere_tpu_torch.analysis.metric_names import MetricNamePass
from sitewhere_tpu_torch.analysis.trace_purity import TracePurityPass

#: pass id -> factory, in documentation order
PASS_FACTORIES = {
    TracePurityPass.pass_id: TracePurityPass,
    LockDisciplinePass.pass_id: LockDisciplinePass,
    DonationPass.pass_id: DonationPass,
    HotPathAllocationPass.pass_id: HotPathAllocationPass,
    MetricNamePass.pass_id: MetricNamePass,
}


def default_passes() -> List[object]:
    return [factory() for factory in PASS_FACTORIES.values()]


def run_suite(paths: Sequence[str],
              passes: Optional[Sequence[object]] = None,
              root: Optional[str] = None,
              project: Optional[Project] = None) -> List[Finding]:
    """Parse ``paths`` once and run every pass; findings sorted by
    file/line for stable output."""
    if project is None:
        project = Project.from_paths(list(paths), root=root)
    findings: List[Finding] = []
    for p in (passes if passes is not None else default_passes()):
        findings.extend(p.run(project))
    findings.sort(key=lambda f: (f.path, f.line, f.pass_id, f.rule))
    return findings


def default_baseline_path() -> str:
    """The checked-in suppression file, resolved relative to the repo
    (tools/torch_swlint_baseline.json next to the CLI)."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), "tools",
                        "torch_swlint_baseline.json")


def check_clean(paths: Sequence[str],
                baseline_path: Optional[str] = None
                ) -> Tuple[List[Finding], List[Finding], List[Dict]]:
    """(unsuppressed, suppressed, stale) — the tier-1 gate asserts the
    first is empty."""
    baseline = Baseline.load(baseline_path or default_baseline_path())
    findings = run_suite(paths)
    return baseline.apply(findings)


__all__ = ["run_suite", "check_clean", "default_passes", "PASS_FACTORIES",
           "default_baseline_path"]
