"""Where a cell's pieces are: everything is found by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
configuration's file lies where its entry says, the mix is
``bench/traffic/<traffic>.json``, the cell's serving sizes and the limits
of its comparison are ``bench/workloads/<cell>.json`` and a metric's
reader is ``bench/metrics/<metric>.py``.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration's file
    traffic: dict           # the mix's parameters
    workload: dict          # serving sizes and comparison limits
    end_to_end: list        # BENCHMARK.json entries this cell reports
    per_layer: list


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_load(root / configs[w["config"]]["file"]),
        traffic=_load(root / "bench" / "traffic" / f"{w['traffic']}.json"),
        workload=_load(root / "bench" / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str, root: Path = ROOT):
    """The module ``bench/metrics/<metric>.py`` (its ``read(run)`` gives
    the value, or None where the run holds nothing to read)."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
