"""Finds everything a run needs by the names in ``BENCHMARK.json``.

A configuration is the file its entry names; a cell's engine and load
settings are ``workloads/<cell>.json``; a traffic mix is
``traffic/<traffic>.json``; a per-layer metric is ``metrics/<metric>.py``
with a ``read(run)`` function. Adding any of them is adding a file.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List


class Registry:
    def __init__(self, root: Path, bench_dir: Path):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir)
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def _json(self, path: Path) -> dict:
        with open(path) as f:
            return json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return self._json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def cell(self, name: str) -> dict:
        return self._json(self.bench_dir / "workloads" / f"{name}.json")

    def traffic(self, name: str) -> dict:
        return self._json(self.bench_dir / "traffic" / f"{name}.json")

    def metric(self, name: str) -> ModuleType:
        path = self.bench_dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"serve_bench_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metrics_of(self, kind: str, cell: str) -> List[Dict]:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]
