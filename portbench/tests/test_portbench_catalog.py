"""``BENCHMARK.json`` against the contract's shape, and discovery by
file name: every cell, configuration, mix, limit and metric of the
benchmark is found by its name, and a new metric and a new cell added as
files in a copy are found with no file of the harness edited."""

from __future__ import annotations

import json
import os
import re
import time

import pytest
import torch

from portbench import catalog, harness
from portbench.harness import Readings

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    return catalog.benchmark(catalog.ROOT)


def test_benchmark_file_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and c["reduced"] == []
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert e2e == {"images_per_s", "latency_p95_ms", "peak_mem_mb",
                   "setup_s"}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for item in b["configs"] + b["workloads"] + b["end_to_end"] + \
            b["per_layer"]:
        assert NAME.match(item["name"]) and item["name"] not in names
        names.add(item["name"])
    shares = [m for m in b["per_layer"] if m["name"].endswith("_roofline")
              or "mfu" in m["name"]]
    assert shares and all(m["unit"] == "%" for m in shares)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_cell_found_by_name(cell):
    b = _bench()
    w = catalog.cell(b, cell)
    cfg = catalog.config(b, w["config"])
    assert cfg["quant"]["recipe"] and catalog.recipe(cfg["quant"]["recipe"])
    mix = catalog.traffic(w["traffic"])
    assert mix["loop"] == "closed" and mix["batch"] >= 1
    lim = catalog.limits(cell)["checks"]
    assert 0 < lim["image_err"] < 1
    for trace in (False, True):
        for m in catalog.metrics(b, trace):
            assert callable(catalog.reader(m["name"]))


def _readings(**kw):
    r = dict(setup_s=1.0, window_s=2.0, latencies_s=[0.1] * 20, images=80,
             requests=20, peak_bytes=10 ** 9, batch=4,
             counts={"generation_least_compute_s": 0.001,
                     "unet_least_roofline_s": 0.0005},
             launches={"qmatmul": 8})
    r.update(kw)
    return Readings(**r)


def test_metric_and_cell_added_as_files(checkout, tmp_path):
    """A metric (reader file + entry) and a cell (entry + limits file) in
    a copy: found with no harness file edited."""
    import shutil

    root = str(tmp_path / "c")
    shutil.copytree(checkout, root)
    with open(os.path.join(root, "portbench", "metrics",
                           "dummy_requests.py"), "w") as f:
        f.write("def read(r):\n    return r.requests\n")
    path = os.path.join(root, "BENCHMARK.json")
    b = json.load(open(path))
    b["per_layer"].append({"name": "dummy_requests", "unit": "requests",
                           "better": "higher", "source": "host_clock",
                           "layer": "serving engine",
                           "moves": "images_per_s"})
    b["workloads"].append({"name": "small_sdxl.b3", "config": "small_sdxl",
                           "traffic": "test_b3", "chips": 1, "why": "t"})
    json.dump(b, open(path, "w"))
    mix = json.load(open(os.path.join(root, "portbench", "traffic",
                                      "test_b2.json")))
    mix["batch"] = 3
    json.dump(mix, open(os.path.join(root, "portbench", "traffic",
                                     "test_b3.json"), "w"))
    shutil.copy(os.path.join(root, "portbench", "workloads",
                             "small_sdxl.b2.json"),
                os.path.join(root, "portbench", "workloads",
                             "small_sdxl.b3.json"))
    b = catalog.benchmark(root)
    assert "dummy_requests" in [m["name"]
                                for m in catalog.metrics(b, True)]
    assert "dummy_requests" not in [m["name"]
                                    for m in catalog.metrics(b, False)]
    out = catalog.read_all(catalog.metrics(b, True), _readings(), root)
    assert out["dummy_requests"] == {"value": 20.0, "unit": "requests"}
    assert catalog.traffic("test_b3", root)["batch"] == 3
    run = harness.run_cell("small_sdxl.b3", 99, 0.3, True,
                           torch.device("cpu"), time.time(), root)
    assert run["correct"] is True
    assert run["metrics"]["dummy_requests"]["value"] >= 1


def test_reader_without_data_is_left_out():
    b = _bench()
    out = catalog.read_all(b["per_layer"], _readings(launches=None))
    assert out == {"mfu": {"value": 100.0 * 0.001 * 80 / 2.0, "unit": "%"}}
