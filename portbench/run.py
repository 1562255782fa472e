"""The benchmark of ``mixdq_tpu_torch`` on one NVIDIA GPU:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; then ``checks``, each number of the
correctness check beside its limit, also the last lines on standard
error. It exits non-zero and prints no result without enough CUDA
devices, or when a JAX module is loaded once the window has closed.

The interpreter is started again with ``PYTHONHASHSEED=0`` so that the
program's hash tokenizer gives the same ids for the same seed in every
run. Build and kernel caches stay inside the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T0 = float(os.environ.get("PORTBENCH_T0", time.time()))
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    sys.path.insert(0, ROOT)
    from portbench import catalog, harness

    harness.log(f"set-up: interpreter and imports {time.time() - T0:.2f} s")
    chips = catalog.cell(catalog.benchmark(ROOT), a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA device(s); this machine has "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = harness.run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                           torch.device("cuda"), T0, ROOT)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"forbidden modules loaded: {bad}")
        return 3
    for name, c in out["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.environ["PYTHONHASHSEED"] = "0"
        os.environ["PORTBENCH_T0"] = repr(T0)
        os.execv(sys.executable, [sys.executable] + sys.argv)
    os.environ.pop("PORTBENCH_T0", None)
    sys.exit(main())
