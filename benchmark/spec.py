"""What a cell is made of, found by name.

``BENCHMARK.json`` at the checkout's root names each workload's
configuration and traffic mix; each is a JSON file of its own here, and
each cell's correctness limits are ``limits/<workload>.json``.  Adding a
cell, a configuration or a traffic mix is adding files and entries: no code
here names one.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload: its entry, configuration, traffic mix and limits, and
    the BENCHMARK.json metrics it reports."""
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def name(self) -> str:
        return self.workload["name"]


def _reports(metric: Dict[str, Any], workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_benchmark(root: str = ROOT) -> Dict[str, Any]:
    return _load(os.path.join(root, "BENCHMARK.json"))


def load_cell(name: str, root: str = ROOT, bench: Dict[str, Any] = None,
              here: str = HERE) -> Cell:
    """The cell ``name`` of BENCHMARK.json (or of ``bench``), with the files
    its entries name under ``here``."""
    bench = bench if bench is not None else load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(by_name)}")
    w = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(_load(os.path.join(root, configs[w["config"]]["file"])))
    traffic = _load(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    limits = _load(os.path.join(here, "limits", f"{name}.json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    layer = [m for m in bench["per_layer"]
             if _reports(m, name)
             and any(e["name"] == m["moves"] for e in e2e)]
    return Cell(w, config, traffic, limits, e2e, layer)
