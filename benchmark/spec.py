"""``BENCHMARK.json`` and the files it names: one configuration file per
configuration (``file``), one traffic mix per name
(``<paths[0]>/traffic/<name>.json``) and one reader per per-layer metric
(``<paths[0]>/metrics/<name>.py``).  Adding a cell, a mix or a metric
adds files and entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, Optional

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(s: str) -> str:
    if not NAME.match(s):
        raise ValueError(f"not a benchmark name: {s!r}")
    return s


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.home = self.root / self.doc["paths"][0]

    def cell(self, workload: str) -> Dict:
        for w in self.doc["workloads"]:
            if w["name"] == workload:
                return w
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> Dict:
        return json.loads(
            (self.home / "traffic" / f"{_name(name)}.json").read_text())

    def per_layer(self, workload: str):
        """The per-layer metrics this cell reports: entries of
        ``per_layer`` without ``workloads`` or listing the cell."""
        return [m for m in self.doc["per_layer"]
                if workload in m.get("workloads", [workload])]

    def end_to_end(self, workload: str):
        return [m for m in self.doc["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> Callable[[Dict], Optional[float]]:
        path = self.home / "metrics" / f"{_name(metric)}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench_metric_{metric.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
