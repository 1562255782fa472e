"""The one traffic generator: what each request of a mix sends, from the
run's seed alone.

A mix file (``portbench/traffic/<name>.json``) gives ``batch`` (prompts
a request), ``loop`` (``"closed"``: one client sends its next request
when the last one's images are on the host), ``clients``, ``prompts``
(a prompt list under ``portbench/``), ``calibration_prompts`` (the last
that many prompts of the list calibrate and are never sent),
``warm_seconds`` (the set-up runs the loop that long on requests of
their own, so the window starts in the loop's steady state),
``check_requests`` (finished requests the check compares) and
``trace_seconds`` (the profiled stretch of the loop in a traced run).

Request ``i`` draws its ``batch`` prompts from the rest of the list and
its noise seed with ``numpy.random.default_rng([seed, i])``: every seed
gives requests of the same sizes, in another order.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from .catalog import HERE

CALIBRATION = 1 << 40  # the calibration draw's stream index
WARM = 1 << 42  # the set-up's warm request


class Traffic:
    def __init__(self, mix: dict, seed: int, root_dir: str = HERE):
        if mix["loop"] != "closed" or mix["clients"] != 1:
            raise ValueError("this generator drives one client in a closed "
                             "loop")
        self.mix, self.seed = mix, int(seed) % (1 << 64)
        with open(os.path.join(root_dir, mix["prompts"])) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        n = mix["calibration_prompts"]
        self.timed, self.calib = lines[:-n], lines[-n:]
        self.batch = mix["batch"]

    def request(self, i: int) -> Tuple[List[str], int]:
        """(prompts, noise seed) of request ``i``."""
        rng = np.random.default_rng([self.seed, i])
        idx = rng.integers(0, len(self.timed), self.batch)
        return [self.timed[j] for j in idx], int(rng.integers(0, 1 << 62))

    def calibration(self) -> Tuple[List[str], int]:
        """(prompts, noise seed) of the calibration trajectory."""
        rng = np.random.default_rng([self.seed, CALIBRATION])
        return list(self.calib), int(rng.integers(0, 1 << 62))
