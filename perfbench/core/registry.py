"""Finding the benchmark's parts by name: the cell in ``BENCHMARK.json``,
its configuration and traffic files, the configuration's driver
(``perfbench/drivers/<driver>.py``) and the per-layer metrics
(``perfbench/metrics/<metric>.py``).  A later change adds a part as a new
file and an entry in ``BENCHMARK.json``; nothing here names one."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = Path(__file__).resolve().parents[1]


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: Dict[str, Any], workload: str) -> Dict[str, Any]:
    """The workload entry with its configuration entry under "config"."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    w = dict(cells[workload])
    configs = {c["name"]: c for c in bench["configs"]}
    w["config_entry"] = configs[w["config"]]
    return w


def config(entry: Dict[str, Any], root: Path = ROOT) -> Dict[str, Any]:
    with open(root / entry["file"]) as f:
        return json.load(f)


def traffic(name: str) -> Dict[str, Any]:
    with open(PACKAGE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def driver(name: str) -> ModuleType:
    return importlib.import_module(f"perfbench.drivers.{name}")


def metric(name: str) -> ModuleType:
    """``perfbench/metrics/<name>.py`` (a metric's name may hold dots)."""
    path = PACKAGE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics._{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def end_to_end(bench: Dict[str, Any], workload: str) -> List[Dict[str, Any]]:
    """The end-to-end metrics this cell reports."""
    return [m for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer(bench: Dict[str, Any], workload: str) -> List[Dict[str, Any]]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(bench, workload)}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
