"""The port's twins of the reference's last nine tools, and ``scan_packed``.

- ``sitewhere_tpu_torch/store/scan.py scan_packed``: the same rows and
  filters through both packages' segment stores give the same packed
  blocks, byte for byte, for hot, cold and filtered segments; a hot
  segment no filter touches yields its resident block itself.
- The reference's own tool cases (``TestRulebenchSmoke`` of
  ``tests/test_rules.py``, ``TestAnalyticsBenchSmoke`` of
  ``tests/test_streaming_analytics.py``) run on the port's tools with a
  source edit; the host-path, overload and tenant-fairness cases run in
  ``tests/test_torch_sources.py``, ``tests/test_torch_overload.py`` and
  ``tests/test_torch_chaos.py``.
- Each port tool's structural output against the reference tool's on the
  same seed (counts, structure keys, shapes, matches, invariants, never
  times): run side by side where the reference tool is a function of its
  seed (rulebench, analytics, host path, tenant fairness, and the chaos
  smoke's armed points and ingested rows, its reference in a child
  process), against the keys the reference tool's source prints where it
  is a wall-clock script (width sweep, overload and observability
  smokes), and against the reference telemetry's stages (step profile).
- Every port tool raises when asked for the card and none is present.
"""

from __future__ import annotations

import ast
import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from torch_parity import port_cases, port_test_module, run_port_case

torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
TOOLS = os.path.join(REPO, "tools")

NEW_TOOLS = ("profile_step", "width_sweep", "hostpath_bench", "rulebench",
             "analytics_bench", "overload_bench", "tenant_fairness_bench",
             "chaos_smoke", "obs_smoke")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _source(name):
    with open(os.path.join(TOOLS, f"{name}.py")) as f:
        return f.read()


def _dict_keys(src, must_have):
    """Keys of the first dict literal in ``src`` holding ``must_have``."""
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys
                    if isinstance(k, ast.Constant)]
            if must_have in keys:
                return set(keys)
    raise AssertionError(f"no dict with {must_have!r}")


# ---------------------------------------------------------------------------
# scan_packed across packages
# ---------------------------------------------------------------------------

T0 = 1_753_900_000


class _FrozenTime:
    """The ``time`` module with a fixed wall clock: both stores stamp
    ``received_s`` from it, so their blocks can match byte for byte."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def time():
        return float(T0 + 500)


def _batches():
    from sitewhere_tpu_torch.ids import NULL_ID
    from sitewhere_tpu_torch.store.segment import COLUMNS

    rng = np.random.default_rng(16)
    out, ts = [], T0
    for n in (70, 45, 90):
        cols = {name: np.full(n, NULL_ID if dt is np.int32 else 0.0, dt)
                for name, dt in COLUMNS if name != "received_s"}
        cols["device_id"] = rng.integers(0, 8, n).astype(np.int32)
        cols["tenant_id"] = (cols["device_id"] % 3).astype(np.int32)
        cols["event_type"] = rng.choice([0, 0, 1, 2], n).astype(np.int32)
        cols["ts_s"] = (ts + np.arange(n)).astype(np.int32)
        cols["value"] = rng.uniform(0, 100, n).astype(np.float32)
        cols["lat"] = rng.uniform(-5, 5, n).astype(np.float32)
        out.append(cols)
        ts += n
    return out


def _store(mod, root, hot_bytes):
    return mod.SegmentStore(
        str(root), flush_rows=32, flush_interval_s=10.0, n_shards=2,
        seal_workers=2, hot_bytes=hot_bytes, compact_interval_s=0.0)


@pytest.fixture()
def both_stores(tmp_path, monkeypatch):
    """``{tier: {"jax": store, "torch": store}}``, the same rows in each."""
    from sitewhere_tpu.store import segmented as ref_mod
    from sitewhere_tpu_torch.store import segmented as port_mod

    for mod in (ref_mod, port_mod):
        monkeypatch.setattr(mod, "time", _FrozenTime())
    out = {}
    for tier, hot_bytes in (("hot", 64 << 20), ("cold", 0)):
        out[tier] = {}
        for pkg, mod in (("jax", ref_mod), ("torch", port_mod)):
            store = _store(mod, tmp_path / tier / pkg, hot_bytes)
            for cols in _batches():
                store.append_columns(dict(cols))
            store.flush(sync=True)
            out[tier][pkg] = store
    return out


SCANS = {
    "all": {},
    "measurements": {"event_type": 0},
    "device": {"device_id": 3},
    "tenant_window": {"tenant_id": 1, "start_s": T0 + 40,
                      "end_s": T0 + 160},
}


@pytest.mark.parametrize("tier", ["hot", "cold"])
@pytest.mark.parametrize("scan", sorted(SCANS))
def test_scan_packed_blocks_equal_across_packages(both_stores, tier, scan):
    from sitewhere_tpu.store.scan import scan_packed as ref_scan
    from sitewhere_tpu_torch.store.scan import scan_packed as port_scan
    from sitewhere_tpu_torch.store.segment import unpack_cols

    filters = SCANS[scan]
    stores = both_stores[tier]

    def blocks(scan_fn, store):
        return [(ints.dtype, ints.shape, ints.tobytes(), flts.dtype,
                 flts.shape, flts.tobytes(), seg.seq, seg.n)
                for ints, flts, seg in scan_fn(store, **filters)]

    ref = blocks(ref_scan, stores["jax"])
    got = blocks(port_scan, stores["torch"])
    assert got == ref
    assert got, "the scan found no block"
    # the blocks hold exactly the rows that pass the filters
    rows = 0
    for ints, flts, _ in port_scan(stores["torch"], **filters):
        cols = unpack_cols(ints, flts)
        for name in ("event_type", "device_id", "tenant_id"):
            if name in filters:
                assert (cols[name] == filters[name]).all()
        if "start_s" in filters:
            assert (cols["ts_s"] >= filters["start_s"]).all()
            assert (cols["ts_s"] <= filters["end_s"]).all()
        rows += ints.shape[1]
    want = sum(
        int(((c["event_type"] == filters.get("event_type", c["event_type"]))
             & (c["device_id"] == filters.get("device_id", c["device_id"]))
             & (c["tenant_id"] == filters.get("tenant_id", c["tenant_id"]))
             & (c["ts_s"] >= filters.get("start_s", 0))
             & (c["ts_s"] <= filters.get("end_s", 1 << 31))).sum())
        for c in _batches())
    assert rows == want


def test_scan_packed_hot_segment_yields_its_resident_block(both_stores):
    from sitewhere_tpu_torch.store.scan import scan_packed

    hot, cold = both_stores["hot"]["torch"], both_stores["cold"]["torch"]
    n = 0
    for ints, flts, seg in scan_packed(hot):
        resident = hot.hot.get(seg.seq)
        assert resident is not None
        assert ints is resident[0] and flts is resident[1]
        n += 1
    assert n > 1
    for ints, flts, seg in scan_packed(cold):
        assert cold.hot.get(seg.seq) is None
    # a filter packs a fresh block of the surviving rows
    for ints, _, seg in scan_packed(hot, event_type=0):
        assert not np.shares_memory(ints, hot.hot.get(seg.seq)[0])


# ---------------------------------------------------------------------------
# the reference's tool cases on the port's tools
# ---------------------------------------------------------------------------

# module -> (the tool case, source edits pointing it at the port's tool on
# the CPU)
TOOL_CASES = {
    "test_rules.py": ("TestRulebenchSmoke", (
        ('"tools", "rulebench.py")', '"tools", "torch_rulebench.py")'),
        ("result = mod.run(n_programs=256,",
         "result = mod.run(device='cpu', n_programs=256,"))),
    "test_streaming_analytics.py": ("TestAnalyticsBenchSmoke", (
        ('"tools", "analytics_bench.py")',
         '"tools", "torch_analytics_bench.py")'),
        ("result = mod.run(n_devices=64, n_events=4096, batch=1024)",
         "result = mod.run(n_devices=64, n_events=4096, batch=1024, "
         "device='cpu')"))),
}
_NS = {}


def _ns(module):
    if module not in _NS:
        _NS[module] = port_test_module(os.path.join(TESTS, module),
                                       replace=TOOL_CASES[module][1])
    return _NS[module]


CASES = [(module, c) for module, (cls, _) in TOOL_CASES.items()
         for c in port_cases(_ns(module)) if c.startswith(f"{cls}.")]


def test_the_tool_cases_were_found():
    assert [c for _, c in CASES] == [
        "TestRulebenchSmoke.test_tool_reports_bucketing_and_swap_stability",
        "TestAnalyticsBenchSmoke.test_tool_reports_throughput_and_latency"]


@pytest.mark.parametrize("module,case", CASES,
                         ids=[f"{m[5:-3]}::{c}" for m, c in CASES])
def test_reference_tool_case_on_the_port(module, case, tmp_path):
    run_port_case(_ns(module), case, tmp_path)


# ---------------------------------------------------------------------------
# structure against the reference tools, same seed
# ---------------------------------------------------------------------------


def test_rulebench_structure_equals_the_reference():
    kw = dict(n_programs=128, n_tenants=16, n_devices=128, n_events=2048,
              batch=1024, swap_every=1)
    ref = _load("rulebench").run(**kw)
    got = _load("torch_rulebench").run(device="cpu", **kw)
    assert set(got) == set(ref) | {"device"}
    for key in ("programs_loaded", "programs_rejected", "structure_keys",
                "compiled_shapes", "max_structure_keys",
                "shapes_within_bound", "alerts_fired", "swaps_applied",
                "recompiles_during_swaps"):
        assert got[key] == ref[key], key
    assert got["recompiles_during_swaps"] == 0 and got["swaps_applied"] >= 1


def test_analytics_bench_counts_equal_the_reference():
    kw = dict(n_devices=64, n_events=4096, batch=1024)
    ref = _load("analytics_bench").run(**kw)
    got = _load("torch_analytics_bench").run(device="cpu", **kw)
    assert set(got) == set(ref) | {"device"}
    for key in ("grid_occupancy", "window_query_matches", "cep_matches"):
        assert got[key] == ref[key], key
    assert got["cep_matches"] == 5


def test_hostpath_bench_structure_equals_the_reference(tmp_path):
    kw = dict(width=128, iters=2, capacity=1024, ring_k=2)
    ref = _load("hostpath_bench").run(data_dir=str(tmp_path / "ref"), **kw)
    got = _load("torch_hostpath_bench").run(
        data_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert set(got) == set(ref) | {"device"}
    for key in ("width", "iters", "payload_bytes", "fill_direct",
                "bytes_copied_per_event_native",
                "bytes_copied_per_event_fill",
                "bytes_copied_per_event_fill_ingest",
                "bytes_copied_per_event_batch",
                "bytes_copied_per_event_native_total",
                "bytes_copied_per_event_fill_total",
                "bytes_copied_reduction", "bytes_copied_3x", "ring_chain_k",
                "host_syncs_per_batch_single", "host_syncs_per_batch_ring",
                "seal_background_segments"):
        assert got[key] == ref[key], key


def test_tenant_fairness_bench_equals_the_reference(tmp_path):
    kw = dict(total_devices=2_000, n_quiet=4, duration_s=2.0, churn_waves=4,
              tier="smoke")
    ref = _load("tenant_fairness_bench").run(
        data_dir=str(tmp_path / "ref"), **kw)
    got = _load("torch_tenant_fairness_bench").run(
        data_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert set(got) == set(ref) | {"device"}
    for key in ("tier", "devices", "registry_capacity", "tenants", "config",
                "phases", "checks", "ok"):
        assert got[key] == ref[key], key
    assert got["ok"]


def _fstring_keys(src, must_have):
    """``key`` of every ``key={...}`` in the first f-string of ``src``
    holding ``must_have``."""
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.JoinedStr):
            text = "".join(v.value if isinstance(v, ast.Constant) else "{}"
                           for v in node.values)
            if must_have in text:
                return re.findall(r"(\w+)=\{\}", text)
    raise AssertionError(f"no f-string with {must_have!r}")


def test_width_sweep_prints_the_references_keys(capsys):
    ref_keys = _fstring_keys(_source("width_sweep"), "host_syncs_per_batch=")
    assert ref_keys[:2] == ["width", "step_ms"]
    tool = _load("torch_width_sweep")
    assert tool.main(["--device", "cpu", "--capacity", "256", "--active",
                      "200", "--chain-k", "2", "--batches", "2", "64"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("width=")]
    assert len(lines) == 1
    got_keys = re.findall(r"(\w+)=", lines[0])
    assert got_keys == ref_keys
    # the JSON record: the same keys, one host sync per chain
    out = tool.run((64,), capacity=256, active=200, chain_k=2, n_batches=2,
                   device="cpu")
    rec = out["widths"][0]
    assert set(ref_keys) <= set(rec)
    assert rec["host_syncs_per_batch"] == 0.5 and rec["step_ms"] > 0


def test_profile_step_reports_the_reference_stages():
    from sitewhere_tpu.pipeline.telemetry import DEVICE_STAGES as REF_STAGES
    from sitewhere_tpu_torch.pipeline.telemetry import DEVICE_STAGES

    tool = _load("torch_profile_step")
    assert tuple(s for s, _ in tool.STAGE_LABELS) == REF_STAGES \
        == DEVICE_STAGES
    assert tool.STAGE_LABELS == _load_labels()
    got = tool.run(width=64, capacity=128, active=100, iters=1, repeats=1,
                   device="cpu")
    assert {f"{s}_ms" for s in REF_STAGES} | {
        "host_rtt_ms", "width", "iters", "repeats",
        "device_events_per_s"} <= set(got)
    assert all(got[f"{s}_ms"] > 0 for s in REF_STAGES)


def _load_labels():
    for node in ast.walk(ast.parse(_source("profile_step"))):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "STAGE_LABELS"):
            return ast.literal_eval(node.value)
    raise AssertionError("no STAGE_LABELS in the reference tool")


def test_overload_bench_keys_equal_the_reference():
    src = _source("overload_bench")
    got = _load("torch_overload_bench").run(
        width=64, duration_s=0.2, multipliers=(1.0, 4.0), alert_every=2,
        device="cpu")
    assert set(got) == {"capacity_rows_per_s", "width", "rows", "device"}
    assert {"capacity_rows_per_s", "width", "rows"} <= set(
        _dict_keys(src, "capacity_rows_per_s"))
    row_keys = _dict_keys(src, "backpressure_signals")
    for row in got["rows"]:
        assert row_keys <= set(row) <= row_keys | {"p99_ms"}
        assert row["alert_sheds"] == 0 and row["alerts_offered"] > 0


#: every overload watermark out of reach: a loaded host's seal lag or
#: fsync latency cannot move the ladder, whose forced states the chaos
#: smokes check (the obs smoke sets the same in its own config)
CALM_WATERMARKS = {name: [1e9, 2e9, 3e9] for name in (
    "seal_lag_s", "decode_backlog", "egress_inflight", "batcher_backlog",
    "fsync_latency_s")}
#: the reference tool run unchanged, in a child whose reference config
#: defaults hold CALM_WATERMARKS
_CALM_REFERENCE = """
import json, runpy, sys
from sitewhere_tpu.runtime import config
config.DEFAULTS["overload"]["watermarks"] = json.loads(sys.argv[1])
sys.argv = sys.argv[2:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


@pytest.mark.parametrize("name,must_have,argv", [
    ("chaos_smoke", "fault_hits", ["7"]),
    ("obs_smoke", "histograms_populated", []),
])
def test_smoke_reports_carry_the_reference_keys(name, must_have, argv,
                                                tmp_path, monkeypatch):
    from sitewhere_tpu_torch.runtime import config

    # both chaos smokes run with their ladders pinned (the tools' forced
    # SHEDDING and NORMAL still run): under a loaded tier-1 run the
    # default watermarks could shed the unguarded device-fault phase
    monkeypatch.setitem(config.DEFAULTS["overload"], "watermarks",
                        CALM_WATERMARKS)
    out = tmp_path / "report.json"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = _load(f"torch_{name}").main(
            [*argv, "--device", "cpu", "--json", str(out)])
    doc = json.loads(out.read_text())
    assert rc == 0 and doc["ok"] and doc["failures"] == []
    assert set(doc) == _dict_keys(_source(name), must_have) | {
        "device", "failures"}
    if name == "chaos_smoke":
        # the fault schedule is a function of the seed: the reference
        # tool at the same seed arms the same points and ingests the same
        # rows (how often a probabilistic point fires races the deadline
        # loop, so only the points are compared)
        ref = subprocess.run(
            [sys.executable, "-c", _CALM_REFERENCE,
             json.dumps(CALM_WATERMARKS),
             os.path.join(TOOLS, "chaos_smoke.py"), *argv],
            capture_output=True, text=True, timeout=240, cwd=REPO,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert ref.returncode == 0, ref.stderr[-2000:]
        ref_doc = json.loads(ref.stdout[ref.stdout.index("{"):
                                         ref.stdout.rindex("}") + 1])
        assert ref.stdout.splitlines()[0] == \
            printed.getvalue().splitlines()[0]       # seed=7 armed=[...]
        assert (doc["seed"], doc["ingested"]) == (ref_doc["seed"],
                                                  ref_doc["ingested"])
        assert list(doc["fault_hits"]) == list(ref_doc["fault_hits"])
        # the at-least-once check: every ingested row stored, or shed by
        # the ladder (and dead-lettered) during the storm
        assert doc["stored"] + doc["overload"]["shed_total"] \
            >= doc["ingested"]
        assert doc["fleet"]["pending_after_recovery"] == 0
    else:
        assert doc["tenant_usage"]["acme"] == 384.0


# ---------------------------------------------------------------------------
# the card by default
# ---------------------------------------------------------------------------

CARD_ARGV = {
    "profile_step": [], "width_sweep": ["64"], "hostpath_bench": [],
    "rulebench": ["--smoke"], "analytics_bench": [],
    "overload_bench": ["--smoke"], "tenant_fairness_bench": ["--smoke"],
    "chaos_smoke": ["7"], "obs_smoke": [],
}


def test_every_reference_tool_has_a_port():
    ref = {f[:-3] for f in os.listdir(TOOLS)
           if f.endswith(".py") and not f.startswith("torch_")}
    ported = {f[6:-3] for f in os.listdir(TOOLS)
              if f.startswith("torch_") and f.endswith(".py")}
    assert ref <= ported, sorted(ref - ported)
    assert set(NEW_TOOLS) <= ref


@pytest.mark.parametrize("name", NEW_TOOLS)
def test_tool_raises_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tool = _load(f"torch_{name}")
    with pytest.raises(RuntimeError, match="no CUDA card is present"):
        with contextlib.redirect_stdout(io.StringIO()):
            tool.main(CARD_ARGV[name])
