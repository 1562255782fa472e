"""Readings that set a cell's limits of ``correct``, in one process:

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds 4 [--out FILE]

For each seed: the cell's set-up, a short window at its load, the check
of the sampled requests against the reference (the lower reading: the
program's ``image_err``) and, for the control seeds, the controls, i.e.
the reference one precision below the configuration's in the UNet
(``unet_w4a4``) and in the towers and VAE (``towers_vae_fp8``), each
judged in the program's place on the same requests by the same verdict
(its ``correct`` has to read false; the smallest ``image_err`` of the
controls is the upper reading). One JSON line per seed on standard
output (and appended to ``--out``). Benchmark runs never run the
controls.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)

    import torch

    sys.path.insert(0, ROOT)
    from portbench import harness

    if not torch.cuda.is_available():
        harness.log("needs a CUDA device")
        return 2
    ctl = {int(s) for s in a.control_seeds.split(",") if s}
    for s in (int(x) for x in a.seeds.split(",")):
        out = harness.run_cell(a.workload, s, a.seconds, False,
                               torch.device("cuda"), time.time(), ROOT,
                               control=s in ctl)
        line = json.dumps({"workload": a.workload, "seed": s,
                           "correct": out["correct"],
                           "checks": out["checks"],
                           "control": out.get("control"),
                           "metrics": out["metrics"]})
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.environ["PYTHONHASHSEED"] = "0"
        os.execv(sys.executable, [sys.executable] + sys.argv)
    sys.exit(main())
