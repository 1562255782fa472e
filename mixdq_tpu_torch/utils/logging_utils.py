"""Experiment logging (port of ``mixdq_tpu/utils/logging_utils.py``):
file and stream handlers, a copy of the config as ``config.yaml`` and the
git revision in each experiment directory. ``quant_txt2img`` reads its
configuration back from that copy."""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
import sys
from typing import Optional


def setup_experiment(outdir: str, config_path: Optional[str] = None) -> None:
    os.makedirs(outdir, exist_ok=True)
    handlers = [
        logging.FileHandler(os.path.join(outdir, "run.log")),
        logging.StreamHandler(sys.stdout),
    ]
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        handlers=handlers, force=True)
    if config_path and os.path.exists(config_path):
        dst = os.path.join(outdir, "config.yaml")
        # re-running against an experiment dir passes the copy itself
        if os.path.abspath(config_path) != os.path.abspath(dst):
            shutil.copy(config_path, dst)
    try:
        rev = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                             text=True, timeout=5).stdout.strip()
        with open(os.path.join(outdir, "GIT_REVISION"), "w") as f:
            f.write(rev + "\n")
    except (OSError, subprocess.SubprocessError):
        pass
