"""Where the harness finds what a cell is made of, by the names in
``BENCHMARK.json``: a configuration's file as the manifest gives it, a
traffic mix in ``perfbench/traffic/<traffic>.json``, a per-layer metric
in ``perfbench/metrics/<metric>.py``.  A cell, a mix or a metric is added
by adding files and entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

TRAFFIC_DIR = Path("perfbench") / "traffic"
METRICS_DIR = Path("perfbench") / "metrics"


def load(root: Path) -> Dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(root: Path, bench: Dict, name: str) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(Path(root) / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(root: Path, name: str) -> Dict:
    with open(Path(root) / TRAFFIC_DIR / f"{name}.json") as f:
        return json.load(f)


def end_to_end(bench: Dict, cell_name: str) -> List[Dict]:
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer(bench: Dict, cell_name: str) -> List[Dict]:
    """The per-layer metrics that list this cell."""
    return [m for m in bench["per_layer"] if cell_name in m["workloads"]]


def metric_module(root: Path, name: str):
    path = Path(root) / METRICS_DIR / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
