"""swlint on the PyTorch port: its own static-analysis suite.

- The reference's framework-neutral fixtures (``tests/fixtures/swlint/``:
  ``hotpath/``, ``metric_names/``, ``locks/`` but its one JAX fixture,
  ``donation/``'s lease and reservation cases) through the port's passes,
  and a torch corpus (``tests/fixtures/torch_swlint/``) with a true
  positive and a true negative of each of ``TP001``-``TP003``, ``LK004``
  and ``DN001``.
- The repo gate: ``sitewhere_tpu_torch/`` is clean under
  ``tools/torch_swlint_baseline.json``, every entry justified, none
  stale; the step set reaches the counterparts of the reference's
  flagship roots; the port finds the counterpart of each non-``HP``
  entry of the reference's baseline, or names why the construct is gone.
- The CLI (``tools/torch_swlint.py``): exit codes, ``--json``,
  ``--baseline``, ``--update-baseline`` round trips.
"""

import json
import os
import subprocess
import sys

import pytest

from sitewhere_tpu_torch.analysis import (
    Baseline,
    default_baseline_path,
    hot_path,
    is_hot_path,
    run_suite,
)
from sitewhere_tpu_torch.analysis.core import Finding, Project
from sitewhere_tpu_torch.analysis.donation import DonationPass
from sitewhere_tpu_torch.analysis.hotpath import HotPathAllocationPass
from sitewhere_tpu_torch.analysis.locks import LockDisciplinePass
from sitewhere_tpu_torch.analysis.metric_names import (
    MetricNamePass,
    lint_names,
)
from sitewhere_tpu_torch.analysis.trace_purity import (
    DEFAULT_STEP_ROOTS,
    REFERENCE_FOLDED,
    TracePurityPass,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "sitewhere_tpu_torch")
REF_FIXTURES = os.path.join(REPO, "tests", "fixtures", "swlint")
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_swlint")
CLI = os.path.join(REPO, "tools", "torch_swlint.py")


def _fixture_pass(passdir):
    """Pass instance tuned for the fixture corpora (fixture modules have
    their own class/lock/function names, so the repo-default config is
    widened where it is name-anchored)."""
    if passdir == "trace_purity":
        return TracePurityPass(
            dispatch_modules={"tp_dispatch_path", "tn_counted_dispatch_path"},
            step_roots={"pipeline_step": "pipeline.step.pipeline_step"})
    if passdir == "locks":
        return LockDisciplinePass(
            hot_locks=["Hot._lock", "Mgr._lock", "Pair._a", "Pair._b"],
            contracts={"Contracted.run_under_intake":
                       "fixture intake lock"},
            device_state_classes=["Mgr"])
    if passdir == "donation":
        return DonationPass(carry_roots={"packed_pipeline_step": "ps"})
    if passdir == "hotpath":
        return HotPathAllocationPass()
    return MetricNamePass()


# rule each true-positive fixture must fire (at least once)
REF_EXPECTED = {
    ("locks", "tp_inversion.py"): "LK001",
    ("locks", "tp_self_deadlock.py"): "LK002",
    ("locks", "tp_blocking_hot.py"): "LK003",
    ("locks", "tp_contract.py"): "LK003",
    ("locks", "tp_checkpoint_hot.py"): "LK005",
    ("donation", "tp_use_after_lease.py"): "DN002",
    ("donation", "tp_use_after_commit.py"): "DN003",
    ("donation", "tp_use_after_abort.py"): "DN003",
    ("hotpath", "tp_list_in_hot.py"): "HP001",
    ("hotpath", "tp_ndarray_in_hot.py"): "HP002",
    ("hotpath", "tp_fstring_in_hot.py"): "HP003",
    ("hotpath", "tp_closure_in_hot.py"): "HP004",
    ("hotpath", "tp_propagated_callee.py"): "HP001",
    ("metric_names", "tp_malformed.py"): "MN001",
    ("metric_names", "tp_unknown_member.py"): "MN002",
    ("metric_names", "tp_typo_flightrec.py"): "MN002",
    ("metric_names", "tp_unregistered_family.py"): "MN003",
}
# the reference's fixtures that are about JAX (jit donation, a jnp
# transfer): the torch corpus holds their counterparts
REF_JAX_FIXTURES = {
    ("locks", "tp_d2h_hot.py"), ("donation", "tp_use_after_jit_donate.py"),
    ("donation", "tp_use_after_chain.py"),
    ("donation", "tp_retry_with_donated.py"),
    ("donation", "tn_no_use_after.py"), ("donation", "tn_rebind_clears.py"),
}
TORCH_EXPECTED = {
    ("trace_purity", "tp_item_in_step.py"): "TP001",
    ("trace_purity", "tp_nonzero_in_shard_map.py"): "TP001",
    ("trace_purity", "tp_sync_in_callee.py"): "TP001",
    ("trace_purity", "tp_coerce_tensor.py"): "TP002",
    ("trace_purity", "tp_dispatch_path.py"): "TP003",
    ("locks", "tp_d2h_hot.py"): "LK004",
    ("locks", "tp_h2d_hot.py"): "LK004",
    ("locks", "tp_to_cpu_hot.py"): "LK004",
    ("donation", "tp_write_into_carry.py"): "DN001",
    ("donation", "tp_inplace_view_of_carry.py"): "DN001",
    ("donation", "tp_carry_write_in_callee.py"): "DN001",
}
CORPORA = {"reference": (REF_FIXTURES, REF_EXPECTED),
           "torch": (FIXTURES, TORCH_EXPECTED)}


def _run_fixture(root, passdir, filename):
    path = os.path.join(root, passdir, filename)
    project = Project.from_paths([path], root=os.path.dirname(path))
    return _fixture_pass(passdir).run(project)


def _fixture_files(root, passdir, prefix):
    d = os.path.join(root, passdir)
    return sorted(f for f in os.listdir(d)
                  if f.startswith(prefix) and f.endswith(".py")
                  and (passdir, f) not in (REF_JAX_FIXTURES
                                           if root == REF_FIXTURES else ()))


TP_CASES = [(c, d, f) for c, (_, exp) in CORPORA.items() for d, f in exp]
TN_CASES = [(c, d, f) for c, (root, exp) in CORPORA.items()
            for d in sorted({d for d, _ in exp})
            for f in _fixture_files(root, d, "tn_")]


# ---------------------------------------------------------------------------
# fixture corpora
# ---------------------------------------------------------------------------


class TestFixtureCorpus:
    def test_reference_corpus_is_covered(self):
        """Every framework-neutral reference fixture of the four passes
        runs here; the JAX ones are named."""
        for d in ("hotpath", "metric_names", "locks"):
            tps = _fixture_files(REF_FIXTURES, d, "tp_")
            assert {(d, f) for f in tps} <= set(REF_EXPECTED), d
        donation_tps = _fixture_files(REF_FIXTURES, "donation", "tp_")
        assert {("donation", f) for f in donation_tps} <= set(REF_EXPECTED)

    @pytest.mark.parametrize("passdir", ["trace_purity", "locks",
                                         "donation"])
    def test_torch_corpus_has_both_kinds(self, passdir):
        assert len(_fixture_files(FIXTURES, passdir, "tp_")) >= 3, passdir
        assert len(_fixture_files(FIXTURES, passdir, "tn_")) >= 3, passdir

    def test_every_torch_rule_has_a_positive_and_a_negative(self):
        fired = {TORCH_EXPECTED[k] for k in TORCH_EXPECTED}
        assert fired == {"TP001", "TP002", "TP003", "LK004", "DN001"}

    @pytest.mark.parametrize("corpus,passdir,filename", TP_CASES,
                             ids=[f"{c}-{d}-{f}" for c, d, f in TP_CASES])
    def test_true_positive_fires(self, corpus, passdir, filename):
        root, expected = CORPORA[corpus]
        findings = _run_fixture(root, passdir, filename)
        rules = {f.rule for f in findings}
        assert expected[(passdir, filename)] in rules, (
            f"{passdir}/{filename} produced {rules or 'no findings'}")

    @pytest.mark.parametrize("corpus,passdir,filename", TN_CASES,
                             ids=[f"{c}-{d}-{f}" for c, d, f in TN_CASES])
    def test_true_negative_is_silent(self, corpus, passdir, filename):
        root, _ = CORPORA[corpus]
        findings = _run_fixture(root, passdir, filename)
        assert findings == [], (
            f"{passdir}/{filename} false-positives:\n"
            + "\n".join(f.format() for f in findings))

    def test_torch_positives_find_every_site(self):
        """The recognizers see each form of the fixture, not just one."""
        lk = _run_fixture(FIXTURES, "locks", "tp_d2h_hot.py")
        assert {f.snippet.strip() for f in lk} == {
            "return self._state.sum().item()",
            "return self._state.cpu().numpy()",
            "done.synchronize()", "torch.cuda.synchronize()"}
        h2d = _run_fixture(FIXTURES, "locks", "tp_h2d_hot.py")
        assert len({f.line for f in h2d}) == 3
        dn = _run_fixture(FIXTURES, "donation", "tp_inplace_view_of_carry.py")
        assert len(dn) == 2
        tp = _run_fixture(FIXTURES, "trace_purity",
                          "tp_nonzero_in_shard_map.py")
        assert len(tp) == 2
        callee = _run_fixture(FIXTURES, "trace_purity",
                              "tp_sync_in_callee.py")
        assert {f.rule for f in callee} == {"TP001", "TP002"}

    def test_findings_carry_evidence_chains(self):
        findings = _run_fixture(FIXTURES, "trace_purity",
                                "tp_sync_in_callee.py")
        deep = [f for f in findings if f.qualname.endswith("._count")]
        assert deep and any("called from" in e for e in deep[0].evidence)
        dn = _run_fixture(FIXTURES, "donation", "tp_carry_write_in_callee.py")
        assert dn and any("carry passed by" in e for e in dn[0].evidence)


# ---------------------------------------------------------------------------
# the repo gate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_project():
    return Project.from_paths([PKG], root=REPO)


@pytest.fixture(scope="module")
def port_findings(port_project):
    return run_suite([PKG], project=port_project)


class TestRepoGate:
    def test_package_is_clean_under_baseline(self, port_findings):
        unsuppressed, suppressed, stale = Baseline.load(
            default_baseline_path()).apply(port_findings)
        assert unsuppressed == [], (
            "unsuppressed swlint findings — fix them or triage into "
            "tools/torch_swlint_baseline.json with a justification:\n"
            + "\n".join(f.format() for f in unsuppressed))
        assert suppressed, "baseline suppressed nothing — wiring broken?"
        assert stale == [], stale

    def test_every_baseline_entry_is_justified(self):
        baseline = Baseline.load(default_baseline_path())
        assert default_baseline_path().endswith(
            os.path.join("tools", "torch_swlint_baseline.json"))
        assert baseline.entries
        bad = [e for e in baseline.entries
               if not str(e.get("note", "")).strip()
               or str(e["note"]).startswith("TODO")]
        assert not bad, ", ".join(str(e["fp"]) for e in bad)

    def test_module_names_are_rooted_at_the_port(self, port_project):
        project = port_project
        assert project.modules and all(
            m == "sitewhere_tpu_torch" or m.startswith("sitewhere_tpu_torch.")
            for m in project.modules)

    def test_step_set_covers_the_flagship_entrypoints(self, port_project):
        """The call graph reaches the counterparts of the reference's
        flagship roots: an empty step set would make TP vacuously clean."""
        traced = TracePurityPass()._step_set(port_project)
        need = ["pipeline.packed.build_packed_chain.chain",
                "pipeline.packed.packed_pipeline_step",
                "pipeline.step.pipeline_step",
                "pipeline.sharded.build_sharded_packed_step.local_step",
                "analytics.windows.aggregate_windows",
                "analytics.query.window_eval",
                "rules.compile.rules_group_eval",
                "rules.compile.rules_prepare_batch"]
        for suffix in need:
            assert f"sitewhere_tpu_torch.{suffix}" in traced, suffix
        # reached through the chain driver, not only the declared table
        assert "sitewhere_tpu_torch.pipeline.packed.build_packed_chain.step" \
            in traced
        assert "sitewhere_tpu_torch.ops.geo_cuda.launch_pip" in traced

    def test_declared_roots_and_folds_exist(self, port_project):
        project = port_project
        for port in DEFAULT_STEP_ROOTS:
            assert f"sitewhere_tpu_torch.{port}" in project.functions, port
        for ref, (port, why) in REFERENCE_FOLDED.items():
            assert f"sitewhere_tpu_torch.{port}" in project.functions, ref
            assert f"sitewhere_tpu_torch.{ref}" not in project.functions
            assert why

    def test_step_set_covers_the_reference_traced_set(self, port_project):
        """Each of the reference's 68 traced functions is in the port's
        step set, or folded into one that is, or is named here."""
        ref = Project.from_paths([os.path.join(REPO, "sitewhere_tpu")])
        from sitewhere_tpu.analysis.trace_purity import (
            TracePurityPass as RefPass,
        )

        ref_set = RefPass()._traced_set(ref)
        assert len(ref_set) == 68
        port = TracePurityPass()._step_set(port_project)
        renamed = {ref: port for port, ref in DEFAULT_STEP_ROOTS.items()}
        missing = []
        for qn in ref_set:
            rel = qn[len("sitewhere_tpu."):]
            counterpart = REFERENCE_FOLDED.get(
                rel, (renamed.get(rel, rel), ""))[0]
            if f"sitewhere_tpu_torch.{counterpart}" not in port:
                missing.append(rel)
        assert missing == [], missing
        # the Pallas kernel's counterparts are the CUDA kernel's wrappers
        assert renamed["ops.geo_pallas.points_in_polygons_pallas"] \
            == "ops.geo_cuda.points_in_polygons_cuda"

    def test_carry_set_reaches_the_step(self, port_project):
        carry = DonationPass()._carry_set(port_project)
        assert "ps" in carry[
            "sitewhere_tpu_torch.pipeline.packed.build_packed_chain.step"][0]
        assert "state" in carry[
            "sitewhere_tpu_torch.pipeline.step.update_device_state"][0]

    def test_hot_path_markers_applied_to_the_per_batch_path(self):
        from sitewhere_tpu_torch.ingest.batcher import Batcher
        from sitewhere_tpu_torch.runtime.dispatcher import PipelineDispatcher
        from sitewhere_tpu_torch.runtime.flightrec import FlightRecorder
        from sitewhere_tpu_torch.store.segmented import SegmentStore

        for fn in (PipelineDispatcher._run_ring,
                   PipelineDispatcher._dispatch_plan,
                   PipelineDispatcher._window_step,
                   PipelineDispatcher._egress,
                   PipelineDispatcher._flight_record,
                   FlightRecorder.record,
                   Batcher._emit, Batcher._emit_adopted,
                   SegmentStore.append_columns):
            assert is_hot_path(fn), fn.__qualname__

    def test_hot_path_marker_is_inert(self):
        @hot_path
        def f(x):
            return x + 1

        assert f(1) == 2 and is_hot_path(f)


# Each non-HP entry of the reference's baseline -> the port's finding that
# stands for it ((rule, qualname) in the port), or why the port has no
# such construct.
PARITY = {
    ("LK004", "pipeline.packed.stage_packed_batch"):
        ("LK004", "pipeline.packed.stage_packed_batch"),
    ("LK004", "pipeline.sharded.place_packed_batch"):
        ("LK004", "pipeline.sharded._stage"),
    ("LK004", "pipeline.sharded.place_packed_state"):
        "the port places the epoch through Placement.place, a method of a "
        "Placement object the call graph cannot resolve (no type "
        "inference); the copy itself is .to(dev) there",
    ("LK004", "runtime.dispatcher.PipelineDispatcher._dispatch_chain"):
        ("LK004", "runtime.dispatcher.PipelineDispatcher._block"),
    ("TP003", "runtime.dispatcher.PipelineDispatcher._dispatch_chain"):
        ("TP003", "runtime.dispatcher.PipelineDispatcher._block"),
    ("LK003", "runtime.dispatcher.PipelineDispatcher._stall_for_egress_room"):
        ("LK003", "runtime.dispatcher.PipelineDispatcher."
                  "_stall_for_egress_room"),
    ("LK004", "runtime.dispatcher.PipelineDispatcher._try_subset"):
        ("LK004", "runtime.dispatcher.PipelineDispatcher._try_subset"),
    ("LK003", "runtime.faults.device_fire"):
        ("LK003", "runtime.faults.device_fire"),
    ("LK004", "state.manager.DeviceStateManager.import_row"):
        ("LK004", "state.manager.DeviceStateManager.import_row"),
    ("LK004", "state.presence.state_changes_for"):
        ("LK004", "state.presence.state_changes_for"),
}
# the reference's import_row read is the port's _row_column (same lock)
PARITY_ALSO = {("LK004", "state.manager.DeviceStateManager._row_column")}


class TestReferenceParity:
    def test_every_reference_entry_has_a_counterpart(self, port_findings):
        ref = json.load(open(os.path.join(REPO, "tools",
                                          "swlint_baseline.json")))
        entries = [e for e in ref["entries"]
                   if not e["rule"].startswith("HP")]
        assert len(entries) == 13
        found = {(f.rule, f.qualname[len("sitewhere_tpu_torch."):])
                 for f in port_findings}
        for e in entries:
            key = (e["rule"], e["qualname"][len("sitewhere_tpu."):])
            want = PARITY[key]
            if isinstance(want, str):
                assert len(want) > 40, key   # a reason, not a placeholder
            else:
                assert want in found, (key, want)
        assert PARITY_ALSO <= found

    def test_port_finds_more_than_the_reference_tool(self, port_findings):
        """The reference's recognizers find only the two LK003 in the
        port; the port's find the card transfers too."""
        rules = {f.rule for f in port_findings}
        assert {"LK003", "LK004", "TP003"} <= rules
        assert not {"TP001", "TP002", "DN001", "MN001", "MN002",
                    "MN003"} & rules


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _cli(*args, **kw):
    return subprocess.run([sys.executable, CLI, *args],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO, **kw)


class TestCli:
    def test_clean_repo_exits_zero(self):
        proc = _cli("sitewhere_tpu_torch")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "0 findings" in proc.stdout

    def test_findings_exit_one_and_json_shape(self):
        tp = os.path.join(REF_FIXTURES, "metric_names", "tp_malformed.py")
        proc = _cli(tp, "--no-baseline", "--json",
                    "--passes", "metric-names")
        assert proc.returncode == 1, proc.stdout + proc.stderr
        doc = json.loads(proc.stdout)
        assert doc["counts"]["unsuppressed"] == 1
        f = doc["findings"][0]
        for key in ("pass", "rule", "path", "line", "qualname",
                    "message", "fingerprint", "evidence"):
            assert key in f, key
        assert f["rule"] == "MN001"

    def test_torch_fixture_through_the_cli(self):
        tp = os.path.join(FIXTURES, "donation", "tp_write_into_carry.py")
        proc = _cli(tp, "--no-baseline", "--json", "--passes", "donation")
        assert proc.returncode == 1
        assert {f["rule"] for f in json.loads(proc.stdout)["findings"]} \
            == {"DN001"}

    def test_update_baseline_roundtrip(self, tmp_path):
        tp = os.path.join(REF_FIXTURES, "hotpath", "tp_list_in_hot.py")
        bl = str(tmp_path / "baseline.json")
        assert _cli(tp, "--baseline", bl, "--passes",
                    "hot-path-alloc").returncode == 1
        up = _cli(tp, "--baseline", bl, "--passes", "hot-path-alloc",
                  "--update-baseline")
        assert up.returncode == 0 and "baseline updated" in up.stdout
        proc = _cli(tp, "--baseline", bl, "--passes", "hot-path-alloc")
        assert proc.returncode == 0, proc.stdout
        assert "suppressed by baseline" in proc.stdout

    def test_narrowed_update_preserves_out_of_scope_entries(self, tmp_path):
        hot = os.path.join(REF_FIXTURES, "hotpath", "tp_list_in_hot.py")
        mn = os.path.join(REF_FIXTURES, "metric_names", "tp_malformed.py")
        bl = str(tmp_path / "baseline.json")
        assert _cli(hot, mn, "--baseline", bl,
                    "--update-baseline").returncode == 0
        seeded = json.loads(open(bl).read())["entries"]
        assert {e["pass"] for e in seeded} == {"hot-path-alloc",
                                              "metric-names"}
        assert _cli(hot, "--baseline", bl, "--passes", "hot-path-alloc",
                    "--update-baseline").returncode == 0
        after = json.loads(open(bl).read())["entries"]
        assert {e["pass"] for e in after} == {"hot-path-alloc",
                                             "metric-names"}
        assert _cli(hot, mn, "--baseline", bl).returncode == 0

    def test_update_drops_entries_for_deleted_files(self, tmp_path):
        hot = os.path.join(REF_FIXTURES, "hotpath", "tp_list_in_hot.py")
        bl = str(tmp_path / "baseline.json")
        assert _cli(hot, "--baseline", bl,
                    "--update-baseline").returncode == 0
        doc = json.loads(open(bl).read())
        doc["entries"].append({
            "fp": "feedfacefeedface", "pass": "hot-path-alloc",
            "rule": "HP001", "path": "deleted/gone.py",
            "qualname": "gone.f", "snippet": "", "note": "zombie"})
        open(bl, "w").write(json.dumps(doc))
        assert _cli(hot, "--baseline", bl,
                    "--update-baseline").returncode == 0
        after = json.loads(open(bl).read())["entries"]
        assert all(e["path"] != "deleted/gone.py" for e in after), after

    def test_no_baseline_update_refused(self):
        proc = _cli("sitewhere_tpu_torch", "--no-baseline",
                    "--update-baseline")
        assert proc.returncode == 2
        assert "refusing" in proc.stderr

    def test_marker_import_does_not_load_the_suite(self):
        code = ("import sys; import sitewhere_tpu_torch.analysis.markers; "
                "bad = [m for m in sys.modules if "
                "m.startswith('sitewhere_tpu_torch.analysis.') and "
                "not m.endswith('.markers')]; "
                "assert not bad, bad")
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, timeout=120,
                              cwd=REPO)
        assert proc.returncode == 0, proc.stderr

    def test_unknown_pass_and_missing_path(self):
        assert _cli("sitewhere_tpu_torch", "--passes", "nope").returncode == 2
        assert _cli("definitely/missing.py").returncode == 2

    def test_list_passes(self):
        proc = _cli("--list-passes")
        assert proc.returncode == 0
        for pass_id in ("trace-purity", "lock-discipline", "donation",
                        "hot-path-alloc", "metric-names"):
            assert pass_id in proc.stdout


# ---------------------------------------------------------------------------
# baseline mechanics and the shared metric-name contract
# ---------------------------------------------------------------------------


class TestBaseline:
    def _finding(self, line, snippet="ps.si[0] = bi[0]"):
        return Finding(pass_id="donation", rule="DN001", path="mod.py",
                       line=line, qualname="mod.f", message="m",
                       snippet=snippet)

    def test_fingerprint_survives_line_shifts(self):
        assert self._finding(10).fingerprint == self._finding(99).fingerprint

    def test_fingerprint_tracks_the_expression(self):
        assert self._finding(10).fingerprint != self._finding(
            10, "ps.sf[0] = bf[0]").fingerprint

    def test_apply_splits_and_reports_stale(self, tmp_path):
        f1, f2 = self._finding(1), self._finding(2, "ps.sf.add_(x)")
        bl = Baseline.from_findings([f1], note="known worklist entry")
        bl.entries.append({"fp": "deadbeefdeadbeef", "pass": "donation",
                           "rule": "DN001", "path": "gone.py",
                           "qualname": "gone.f", "snippet": "",
                           "note": "obsolete"})
        unsup, sup, stale = bl.apply([f1, f2])
        assert [f.fingerprint for f in sup] == [f1.fingerprint]
        assert [f.fingerprint for f in unsup] == [f2.fingerprint]
        assert len(stale) == 1 and stale[0]["fp"] == "deadbeefdeadbeef"
        path = str(tmp_path / "b.json")
        bl.save(path)
        assert Baseline.load(path).fingerprints == bl.fingerprints


class TestLintNamesHelper:
    def test_clean_names(self):
        assert lint_names(["pipeline.steps", "ingest.batch_wait_s",
                           "device.occupancy.rows_admitted",
                           "device.stage_ms.full",
                           "slo.burn_rate.p99_ms.fast",
                           "flightrec.records",
                           "pipeline.bytes_copied.h2d",
                           "native.build_fallbacks"]) == []

    def test_violations(self):
        bad = lint_names(["Bad Name", "flightrec.snapshot",
                          "pipeline.bytes_copied.total",
                          "device.thermals.max_c"])
        assert len(bad) == 4
        assert any("convention" in m for m in bad)
        assert any("closed" in m and "flightrec" in m for m in bad)
        assert any("no declared family" in m for m in bad)

    def test_registry_is_the_references(self):
        from sitewhere_tpu.analysis import metric_names as ref
        from sitewhere_tpu_torch.analysis import metric_names as port

        assert port.FAMILIES == ref.FAMILIES
        assert port.GOVERNED_PREFIXES == ref.GOVERNED_PREFIXES
        assert port.METRIC_NAME_PATTERN == ref.METRIC_NAME_PATTERN
