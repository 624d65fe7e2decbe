"""A tiny copy of the benchmark for CPU tests: the repository's
``BENCHMARK.json`` and ``benchmark/`` in a temporary root, plus a cell
small enough for the CPU (width 512, 4096 registry slots, 16 zones)."""

import json
import shutil
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent.parent
TINY = dict(name="tiny", width=512, registry_capacity=4096, devices=3000,
            zones=16, zone_verts=8, zone_radius=[0.3, 2.0],
            warmup_batches=8, sample_devices=64, sample_unregistered=8)


def make_root(tmp: Path, base_config: str, base_traffic: str,
              traffic_changes=None, config_changes=None) -> Path:
    """A root holding the benchmark and a cell ``tiny.cell``: the base
    configuration and mix at the tiny size, with the changes given."""
    root = Path(tmp)
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((REPO / "BENCHMARK.json").read_text())
    home = root / "benchmark"
    cfg = json.loads((home / "configs" / f"{base_config}.json").read_text())
    cfg.update(TINY, **(config_changes or {}))
    (home / "configs" / "tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((home / "traffic" / f"{base_traffic}.json").read_text())
    mix.update(pool_batches=4, **(traffic_changes or {}))
    (home / "traffic" / "tinymix.json").write_text(json.dumps(mix))
    doc["configs"].append({"name": "tiny", "source": "test",
                           "file": "benchmark/configs/tiny.json",
                           "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "tiny.cell", "config": "tiny",
                             "traffic": "tinymix", "chips": 1,
                             "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root


def run_cpu(monkeypatch, capsys, root: Path, seed=11, seconds=1.0, trace=0,
            workload="tiny.cell"):
    """One run of the cell on the CPU (the harness's look for a card
    skipped); returns the result line as a dict and the standard error."""
    from benchmark import run

    monkeypatch.setattr(run, "require_cards", lambda n: torch.device("cpu"))
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(trace)],
                  root=root)
    assert rc == 0
    got = capsys.readouterr()
    return json.loads(got.out.strip().splitlines()[-1]), got.err
