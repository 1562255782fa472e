"""Everything the harness finds by name, under the repository root that
holds ``BENCHMARK.json``:

* a configuration: the ``file`` its entry in ``BENCHMARK.json`` names;
* a traffic mix: ``portbench/traffic/<traffic>.json`` (read by
  ``portbench/traffic.py``);
* a cell's limits of ``correct``: ``portbench/workloads/<cell>.json``;
* a metric: ``portbench/metrics/<name>.py``, whose ``read(readings)``
  returns the value, or None where it finds nothing to read;
* a deploy recipe: ``portbench/recipes/<recipe>.py``, named by the
  configuration's ``quant.recipe``.

A cell, a configuration, a mix or a metric is added by adding its files
and its entry; no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(os.path.join(root, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, root: str = ROOT) -> dict:
    return _json(os.path.join(root, "portbench", "traffic", name + ".json"))


def limits(cell_name: str, root: str = ROOT) -> dict:
    return _json(os.path.join(root, "portbench", "workloads",
                              cell_name + ".json"))


def metrics(bench: dict, trace: bool) -> List[dict]:
    """The metrics of one run: ``end_to_end`` without the trace,
    ``per_layer`` with it. A reader that finds nothing to read in a cell
    leaves its metric out of that cell's line."""
    return bench["per_layer" if trace else "end_to_end"]


def _module(kind: str, name: str, root: str):
    path = os.path.join(root, "portbench", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: str = ROOT):
    return _module("metrics", name, root).read


def recipe(name: str, root: str = ROOT):
    return _module("recipes", name, root).deploy


def read_all(entries: List[dict], readings, root: str = ROOT
             ) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of every metric whose reader finds
    something to read."""
    out = {}
    for m in entries:
        v = reader(m["name"], root)(readings)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
