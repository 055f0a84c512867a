"""A cell, a configuration, a traffic mix, a per-layer metric and an op's
work formula are found by name: adding files and entries is enough."""

from __future__ import annotations

import json
import os

from benchmark import run, spec
from benchmark.run import load_file


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def test_the_committed_cells_load():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert hasattr(load_file("metrics", m["name"]), "read")


def test_added_cell_config_and_metric_are_found(tmp_path):
    here = os.path.join(tmp_path, "benchmark")
    bench = spec.load_benchmark()
    bench["configs"].append({"name": "new_cfg", "source": "x",
                             "file": "benchmark/configs/new_cfg.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "new_cell", "config": "new_cfg",
                               "traffic": "new_mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new_metric.eval", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "entry", "moves": "samples_per_s",
                               "workloads": ["new_cell"]})
    bench["end_to_end"][0]["workloads"].append("new_cell")
    _write(os.path.join(tmp_path, "BENCHMARK.json"), json.dumps(bench))
    _write(os.path.join(here, "configs", "new_cfg.json"),
           json.dumps({"name": "new_cfg", "config_file": "c.py",
                       "expect": {}}))
    _write(os.path.join(here, "traffic", "new_mix.json"),
           json.dumps({"kind": "predict", "batch": 3}))
    _write(os.path.join(here, "limits", "new_cell.json"),
           json.dumps({"cls": 0.5}))
    _write(os.path.join(here, "metrics", "new_metric.eval.py"),
           "def read(ctx):\n    return 7.0\n")
    _write(os.path.join(here, "work", "new_op.py"),
           "def work(call):\n    return 2.0, 4.0, 2\n")
    cell = spec.load_cell("new_cell", root=str(tmp_path), here=here)
    assert cell.config["name"] == "new_cfg"
    assert cell.traffic["batch"] == 3 and cell.limits == {"cls": 0.5}
    assert [m["name"] for m in cell.per_layer] == ["new_metric.eval"]
    assert [m["name"] for m in cell.end_to_end] == ["samples_per_s",
                                                    "peak_mem_gib", "setup_s"]
    assert load_file("metrics", "new_metric.eval", here).read(None) == 7.0
    assert load_file("work", "new_op", here).work({}) == (2.0, 4.0, 2)


def test_no_file_of_the_harness_names_a_cell():
    """Cells, configurations and mixes live in data files only."""
    bench = spec.load_benchmark()
    names = ([w["name"] for w in bench["workloads"]]
             + [c["name"] for c in bench["configs"]]
             + [w["traffic"] for w in bench["workloads"]])
    for f in ("run.py", "spec.py", "check.py", "trace.py", "spans.py",
              "traffic.py", "readers.py", "weights.py", "shapes.py"):
        text = open(os.path.join(run.HERE, f)).read()
        for n in names:
            assert f'"{n}"' not in text, (f, n)
