"""Metric-name pass (MN): the registry-driven metric naming contract.

Counterpart of ``sitewhere_tpu/analysis/metric_names.py``, with the same
family registry: the port emits the reference's metric names.

The observability story depends on every instrument following the
lowercase dotted ``subsystem.noun_verb`` convention (``METRIC_NAME_RE``
in ``runtime/metrics.py``) and on the curated families — the ones
dashboards and the SLO engine address BY NAME — containing exactly
their documented members.  The old dynamic name-lint test only checked
names an instance happened to register at runtime; this pass reads the
SOURCE, so an instrument behind a rarely-taken branch is linted too.

Rules:

- ``MN001 malformed-name``: a literal name passed to
  ``.counter/.gauge/.histogram/.timer`` fails the naming regex; for
  f-strings every LITERAL fragment must use the legal character set.
- ``MN002 unknown-family-member``: a literal name inside a CLOSED
  family (``device.occupancy.*``, ``device.cost.*``,
  ``pipeline.bytes_copied.*``, ``flightrec.*``, ``native.*``) that is
  not a registered member — the typo'd ``flightrec.snapshot`` that
  silently splits a time series.
- ``MN003 unregistered-family``: a name under a governed prefix
  (``device.*``, ``slo.*``) whose sub-family is not declared in the
  registry below — new families are added HERE, deliberately, not
  minted by a stray call site.

``lint_names`` is the runtime half of the same contract: the dynamic
tier-1 tests feed it the names a live instance actually registered, so
the static and dynamic lints can never disagree on the rules.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Set

from sitewhere_tpu_torch.analysis.core import Finding, FuncInfo, Project, iter_scope

PASS_ID = "metric-names"

# kept in sync with runtime/metrics.py METRIC_NAME_RE (imported lazily at
# runtime by lint_names; duplicated here so parsing fixtures never drags
# numpy in)
METRIC_NAME_PATTERN = r"^[a-z0-9][a-z0-9_-]*(\.[a-z0-9][a-z0-9_-]*)+$"
_NAME_RE = re.compile(METRIC_NAME_PATTERN)
_FRAGMENT_RE = re.compile(r"^[a-z0-9_.-]*$")

_INSTRUMENT_METHODS = {"counter", "gauge", "histogram", "timer"}

# The curated family registry.  A value of None = OPEN family (dynamic
# suffixes allowed, charset still enforced); a set = CLOSED (exact
# members only).
FAMILIES: Dict[str, Optional[Set[str]]] = {
    "device.occupancy": {"rows_admitted", "rows_invalid", "rules_fired",
                         "state_writes", "presence_merges"},
    "device.stage_ms": None,            # per-stage histograms, probe-named
    "device.cost": {"flops", "bytes_accessed"},
    # device-tier fault containment (runtime/dispatcher.py +
    # runtime/devguard.py): chain/step faults, the bisect → poison-row
    # path, re-leases, breaker ladder state, watchdog budget trips
    "device.fault": {"chain_faults", "step_faults", "bisect_rounds",
                     "poison_rows", "releases", "breaker_state",
                     "breaker_trips", "watchdog_soft_trips",
                     "watchdog_hard_trips", "host_copy_faults",
                     "cpu_fallback_steps"},
    # numeric-integrity quarantine (dispatcher _scan_quarantine): NaN/Inf
    # rows masked on device, attributed + quarantined host-side
    "pipeline.quarantine": {"devices", "rows_nonfinite", "state_changes"},
    "slo.burn_rate": None,              # slo.burn_rate.<objective>.<win>
    "slo.alert": None,                  # slo.alert.<objective>
    "flightrec": {"records", "anomalies", "snapshots", "suppressed_dumps"},
    "pipeline.bytes_copied": {"decode", "batch", "h2d"},
    "native": {"build_fallbacks"},
    # crash-recovery surface (runtime/checkpoint.py + Instance.start):
    # restore wall time, replayed-event count, replay wall time — the
    # measured-RTO gauges the kill-point harness asserts on
    "recovery": {"restore_s", "replay_events", "replay_s"},
    # segment-store surface (sitewhere_tpu_torch/store): seal queue depth +
    # background seal/compaction timings, segment/tier counts, bytes
    # written, scan-lane accounting, checkpoint-manifest drift — the
    # family tools/store_bench.py and the store dashboards address
    "store": {
        # counters
        "rows_sealed", "bytes_written", "seal_failures",
        "rows_compacted", "segments_compacted",
        "scan_rows", "scan_hot_hits", "scan_pruned",
        "tier_promotions", "tier_demotions",
        # histograms (background stage timers)
        "seal_s", "compact_s",
        # gauges
        "segments", "segments_hot", "hot_bytes",
        "seal_queue_depth", "buffered_rows", "catalog_drift",
    },
    # cross-host forwarding + fleet health plane (rpc/forward.py,
    # rpc/health.py) — the family the fleet chaos bench and the
    # topology dashboards address; replaces the old dict-only
    # HostForwarder.metrics() surface
    "forward": {
        # counters
        "local_rows", "forwarded_rows", "dead_lettered",
        "send_attempts", "probe_sends", "shed_retained",
        "edge_refusals", "heartbeats_sent", "heartbeats_failed",
        "deadline_expired",
        # gauges
        "pending_rows",
    },
    # per-peer health gauges: dynamic <process-id> suffixes
    "forward.peer_state": None,      # 0 ALIVE / 1 SUSPECT / 2 DOWN
    "forward.peer_overload": None,   # the peer's advertised OverloadState
    # tenant metering plane (runtime/metering.py): the CLOSED core is
    # the ledger's own health gauges; the per-tenant surfaces are OPEN
    # (top-K tenant tokens label the suffix, the long tail aggregates
    # under ``...other``, and tenants rotating out of the top-K have
    # their gauges removed — the governed-cardinality contract)
    "tenant.meter": {"tracked", "collided_buckets", "window_rows"},
    "tenant.usage.rows": None,        # tenant.usage.rows.<token> | .other
    "tenant.usage.sealed_bytes": None,
    "tenant.usage.eval_s": None,      # metered rule/analytics eval time
    "tenant.share": None,             # window row share ∈ [0, 1]
    "tenant.shed": None,              # admission sheds (overload ladder)
    # multitenant isolation (runtime/overload.py TenantBudgets,
    # runtime/metering.py QuotaTable, state/manager.py TenantPartitions):
    # CLOSED — these are instance-wide counters/gauges, never per-token
    "tenant.budget": {"clipped_rows"},
    "tenant.quota": {"refusals", "eval_rows_skipped"},
    "tenant.partition": {"tracked", "compiles", "resizes"},
    # bring-your-own-rules compiler/engine (sitewhere_tpu_torch/rules): the
    # bucketing guarantee made observable — compiled_shapes is the gauge
    # tools/rulebench.py asserts stays ≤ MAX_STRUCTURE_KEYS at 100k
    # programs, swaps counts zero-stall operand republishes
    "rules": {
        # gauges
        "programs", "groups", "compiled_shapes",
        # counters
        "swaps", "compiles", "live_batches", "live_dropped",
        "live_shed", "alerts",
        # timers
        "eval_s",
    },
}
# prefixes where EVERY name must resolve to a declared family (MN003).
# "tenants." (plural) is reserved alongside "tenant." so a typo'd
# namespace cannot silently mint ungoverned per-tenant series.
GOVERNED_PREFIXES = ("device.", "slo.", "store.", "forward.", "tenant.",
                     "tenants.", "rules.")


def family_of(name: str) -> Optional[str]:
    """Longest declared family prefix of ``name`` (None if none)."""
    best = None
    for fam in FAMILIES:
        if name == fam or name.startswith(fam + "."):
            if best is None or len(fam) > len(best):
                best = fam
    return best


def lint_names(names: Sequence[str]) -> List[str]:
    """Runtime-side lint: violations (as messages) for a list of
    registered metric names — the shared helper the dynamic tier-1
    name-lint tests call, so static and runtime checks enforce ONE
    contract."""
    try:
        from sitewhere_tpu_torch.runtime.metrics import METRIC_NAME_RE as rx
    except Exception:  # pragma: no cover — fixtures without numpy
        rx = _NAME_RE
    problems: List[str] = []
    for name in names:
        if not rx.match(name):
            problems.append(f"{name}: violates the dotted name convention")
            continue
        fam = family_of(name)
        if fam is not None:
            members = FAMILIES[fam]
            rest = name[len(fam) + 1:]
            if members is not None and rest and rest not in members:
                problems.append(
                    f"{name}: not a registered member of the closed "
                    f"family {fam}.* ({sorted(members)})")
        elif name.startswith(GOVERNED_PREFIXES):
            problems.append(
                f"{name}: governed prefix with no declared family — "
                "register it in sitewhere_tpu_torch/analysis/metric_names.py")
    return problems


class MetricNamePass:
    pass_id = PASS_ID

    def run(self, project: Project) -> List[Finding]:
        findings: List[Finding] = []
        for qn, fi in sorted(project.functions.items()):
            for node in iter_scope(fi.node):
                if not isinstance(node, ast.Call):
                    continue
                if not (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _INSTRUMENT_METHODS):
                    continue
                if not node.args:
                    continue
                findings.extend(self._check_name(project, fi, node,
                                                 node.args[0]))
        return findings

    def _check_name(self, project: Project, fi: FuncInfo, call: ast.Call,
                    arg: ast.AST) -> List[Finding]:
        out: List[Finding] = []
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            name = arg.value
            if not _NAME_RE.match(name):
                out.append(project.finding(
                    self.pass_id, "MN001", fi, call,
                    f"metric name {name!r} violates the lowercase dotted "
                    "subsystem.noun_verb convention"))
                return out
            fam = family_of(name)
            if fam is not None:
                members = FAMILIES[fam]
                rest = name[len(fam) + 1:]
                if members is not None and rest and rest not in members:
                    out.append(project.finding(
                        self.pass_id, "MN002", fi, call,
                        f"{name!r} is not a registered member of the "
                        f"closed family {fam}.* "
                        f"(members: {sorted(members)})"))
            elif name.startswith(GOVERNED_PREFIXES):
                out.append(project.finding(
                    self.pass_id, "MN003", fi, call,
                    f"{name!r} is under a governed prefix but its family "
                    "is not declared in the swlint registry"))
        elif isinstance(arg, ast.JoinedStr):
            literal = "".join(
                v.value for v in arg.values
                if isinstance(v, ast.Constant) and isinstance(v.value, str))
            if not _FRAGMENT_RE.match(literal):
                out.append(project.finding(
                    self.pass_id, "MN001", fi, call,
                    f"f-string metric name literal fragments {literal!r} "
                    "use characters outside [a-z0-9_.-]"))
        return out


__all__ = ["MetricNamePass", "PASS_ID", "FAMILIES", "GOVERNED_PREFIXES",
           "family_of", "lint_names"]
