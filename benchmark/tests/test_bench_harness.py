"""The whole harness on the CPU at a tiny size: a run proves correct, the
same run with the timed path broken underneath does not, a new cell, mix
and metric work as files alone, and nothing of JAX is loaded."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.tests.tiny import REPO, make_root, run_cpu


@pytest.fixture
def root(tmp_path):
    """The cell's configuration and mix at a tiny size: rules and zones
    fire, derived alerts and quarantine rows are re-injected."""
    return make_root(tmp_path, base_config="geo-10k-sync",
                     base_traffic="tracking",
                     traffic_changes={"nonfinite_share": 0.01},
                     config_changes={"zone_box": [-60.0, 60.0],
                                     "zone_radius": [8.0, 20.0]})


@pytest.mark.parametrize("seed", [11, 3_000_000_007, 2_147_483_659])
def test_a_tiny_run_proves_correct(root, monkeypatch, capsys, seed):
    res, err = run_cpu(monkeypatch, capsys, root, seed=seed)
    assert res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"events_per_s", "setup_s"}
    assert int(re.search(r"derived alerts (\d+)", err).group(1)) > 0
    # the numbers compared come last, in the result and on stderr
    assert list(res)[-1] == "checks"
    last = err.strip().splitlines()[-len(res["checks"]):]
    assert [line.split()[1] for line in last] == list(res["checks"])


def _wrap_dispatcher(monkeypatch, fault):
    """Break the timed path under the harness: the dispatcher's packed step
    and K-step chains, its staging of a batch, or the geofence the step
    calls (every point outside every zone)."""
    from benchmark import driver

    if fault == "geofence_zeros":
        from sitewhere_tpu_torch.ops import geo_cuda

        def outside(points, verts):
            return torch.zeros(points.shape[0], verts.shape[0], dtype=torch.bool,
                               device=points.device)

        monkeypatch.setattr(geo_cuda, "points_in_polygons", outside)
        monkeypatch.setattr(geo_cuda, "points_in_polygons_cuda", outside)
        return

    build = driver.build_dispatcher

    def broken(*a, **kw):
        disp = build(*a, **kw)
        step = disp._packed_step

        if fault == "state_unchanged":
            def bad_step(tables, ps, bi, bf):
                _, oi, m, present = step(tables, ps, bi, bf)
                return ps, oi, m, present

            def bad_chain(chain):
                def run(tables, ps, *slots):
                    out = chain(tables, ps, *slots)
                    return (ps,) + tuple(out[1:])
                return run
        elif fault == "answer_altered":
            def bad_step(tables, ps, bi, bf):
                new_ps, oi, m, present = step(tables, ps, bi, bf)
                oi = oi.clone()
                oi[3] += 1          # the enrichment's area_id
                return new_ps, oi, m, present

            def bad_chain(chain):
                def run(tables, ps, *slots):
                    new_ps, ois, m, present = chain(tables, ps, *slots)
                    ois = ois.clone()
                    ois[:, 3] += 1
                    return new_ps, ois, m, present
                return run
        else:
            bad_step, bad_chain = step, (lambda chain: chain)
            stage = disp._stage_packed

            def half(bi, bf):
                bi = bi.copy()
                bi[0, bi.shape[1] // 2:] = 0      # the valid row
                return stage(bi, bf)

            disp._stage_packed = half
        disp._packed_step = bad_step
        for k, chain in list(disp._ring_chains.items()):
            disp._ring_chains[k] = bad_chain(chain)
        make_chain = disp._ring_chain
        disp._ring_chain = lambda k: bad_chain(make_chain(k))
        return disp

    monkeypatch.setattr(driver, "build_dispatcher", broken)


@pytest.mark.parametrize("fault, fails", [
    ("state_unchanged", "state_wrong"),
    ("half_batch_left_out", "stored_total_gap"),
    ("answer_altered", "enrich_wrong"),
    ("geofence_zeros", "alerts_wrong"),
])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, capsys,
                                            fault, fails):
    _wrap_dispatcher(monkeypatch, fault)
    res, _ = run_cpu(monkeypatch, capsys, root)
    assert res["correct"] is False
    assert res["checks"][fails]["value"] > res["checks"][fails]["limit"]


def test_a_new_cell_mix_and_metric_run_as_files_alone(tmp_path, monkeypatch,
                                                      capsys):
    root = make_root(tmp_path, base_config="geo-10k",
                     base_traffic="tracking-quiet")
    home = root / "benchmark"
    (home / "metrics" / "rows_per_batch.py").write_text(
        '"""Rows handed in per batch of the window."""\n\n\n'
        "def read(ctx):\n"
        "    return ctx['rows'] / ctx['batches']\n")
    doc = json.loads((root / "BENCHMARK.json").read_text())
    doc["per_layer"].append({
        "name": "rows_per_batch", "unit": "rows", "better": "higher",
        "source": "program_counter", "layer": "batcher",
        "moves": "events_per_s", "workloads": ["tiny.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    res, _ = run_cpu(monkeypatch, capsys, root, trace=1)
    assert res["correct"] is True
    assert res["metrics"]["rows_per_batch"]["value"] == 512
    # the device-trace readers find nothing to read on the CPU
    assert "pip_roofline" not in res["metrics"]
    assert {"batch_ms", "steps_per_fill_plan",
            "latency_p99_ms"} <= set(res["metrics"])


DRIVE = """
import json, sys, torch
sys.path.insert(0, {repo!r})
from pathlib import Path
from benchmark import run
run.require_cards = lambda n: torch.device("cpu")
rc = run.main(["--workload", "tiny.cell", "--seed", "5", "--seconds", "0.5",
               "--trace", "0"], root=Path({root!r}))
print(json.dumps({{"rc": rc, "tops": sorted({{m.split(".")[0]
                                              for m in sys.modules}})}}))
"""


def test_no_module_of_jax_or_the_jax_package_is_loaded(root):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", DRIVE.format(repo=str(REPO), root=str(root))],
        capture_output=True, text=True, timeout=600, env=env, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["rc"] == 0
    tops = set(last["tops"])
    assert "sitewhere_tpu_torch" in tops
    for name in ("jax", "jaxlib", "flax", "sitewhere_tpu"):
        assert name not in tops   # whole top-level names, not prefixes


def test_without_a_card_the_run_exits_nonzero_and_prints_nothing(root,
                                                                 capsys):
    from benchmark import run

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit) as exc:
        run.main(["--workload", "tiny.cell", "--seed", "1", "--seconds", "1",
                  "--trace", "0"], root=root)
    assert exc.value.code != 0
    assert capsys.readouterr().out == ""


def test_the_control_fails_the_comparison(root):
    from benchmark import control

    cfg = json.loads((root / "benchmark/configs/tiny.json").read_text())
    mix = json.loads((root / "benchmark/traffic/tinymix.json").read_text())
    from benchmark.reference import compare

    numbers = control.control_numbers(cfg, mix, 3_000_000_041, 24, "cpu")
    correct, checks, _ = compare.verdict(numbers, cfg["limits"])
    assert correct is False
    assert checks["state_wrong"]["value"] > checks["state_wrong"]["limit"]


def test_latencies_take_the_oldest_row_of_each_plan():
    from benchmark.run import latencies

    handover = np.array([0.0, 1.0, 2.0, 3.0])
    # t, lo, hi, n_stream, n_all, derived_lo, n_derived, n_state_changes
    plans = np.array([[1.5, 0, 9, 10, 10, -1, 0, 0],       # warm-up batch 0
                      [2.5, 10, 19, 10, 10, -1, 0, 0],     # batch 1
                      [3.5, 20, 25, 6, 9, 12, 3, 0],       # alerts of batch 1
                      [4.0, -1, -1, 0, 2, -1, 0, 2]])      # state changes only
    lat = latencies(plans, handover, n0=1, width=10)
    assert lat.tolist() == [1.5, 2.5]
