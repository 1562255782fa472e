"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout with two small cells (``small_sdxl.b2`` on the
program's ``small-sdxl`` family, ``tiny_sd15.b2`` on ``tiny-sd15``),
added as files only. Run from the repository root:

    python -m pytest portbench/tests -q

(the card-only case runs there with ``-m gpu``)."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

#: limits of the small cells (the full cells' own, from their files)
SMALL_LIMITS = {"small_sdxl.b2": 0.2, "tiny_sd15.b2": 0.35}


def make_checkout(dst: str) -> str:
    """A checkout at ``dst``: the benchmark's folder and a
    ``BENCHMARK.json`` that names the small cells, their mix
    (``portbench/traffic/test_b2.json``) and limits added as files."""
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    data = os.path.join(HERE, "data")
    shutil.copy(os.path.join(data, "bench.json"),
                os.path.join(dst, "BENCHMARK.json"))
    shutil.copy(os.path.join(data, "test_b2.json"),
                os.path.join(dst, "portbench", "traffic", "test_b2.json"))
    for cell, lim in SMALL_LIMITS.items():
        with open(os.path.join(dst, "portbench", "workloads",
                               cell + ".json"), "w") as f:
            json.dump({"checks": {"image_err": lim}}, f)
    return dst


@pytest.fixture(scope="session")
def checkout(tmp_path_factory):
    return make_checkout(str(tmp_path_factory.mktemp("checkout")))


@pytest.fixture(autouse=True)
def _threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
