"""Integer-programming bit-width allocation, metric-decoupled (port of
``mixdq_tpu/mixed_precision/ilp.py``, the same MILP, variable layout,
layer order, tolerances and k grid, so the same maps).

Reference: mixed_precision_scripts/optimize/integer_programming.py —
boolean one-hot variables c[(layer, bit)], a weighted-average-bit budget
constraint within +-0.02 of the target (:81-82,163-164), objective =
maximize summed sensitivity (:87-92), solved separately for the SSIM
('content': ff/attn2, bits {2,4,8}) and SQNR ('quality', bits {4,8})
groups (:49-52,146), with ``get_mean_bit`` splitting the global budget
between groups by a ratio k scanned over a grid (:25-32, 262-285).

The reference uses OR-Tools SCIP, which is not a dependency, so the same MILP is
solved with scipy.optimize.milp (HiGHS backend).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import Bounds, LinearConstraint, milp

logger = logging.getLogger(__name__)


def tensor_size_fractions(sizes: Dict[str, int]) -> Dict[str, float]:
    """Per-layer parameter-count fractions (the reference's precomputed
    weight/act tensor-ratio configs, optimize/tensor_ratio/)."""
    total = float(sum(sizes.values()))
    return {k: v / total for k, v in sizes.items()}


def allocate_bits(
    sensitivity: Dict[str, Sequence[float]],
    size_frac: Dict[str, float],
    target_avg_bits: float,
    bits: Sequence[int] = (2, 4, 8),
    tolerance: float = 0.02,
) -> Optional[Dict[str, int]]:
    """Solve one group's MILP. ``sensitivity[layer][i]`` corresponds to
    ``bits[i]`` (higher = better at that bit). Budget is the weighted
    average bit-width over ``size_frac`` (re-normalized within the group).

    Returns {layer: bits} or None if infeasible."""
    layers = sorted(sensitivity.keys())
    B = len(bits)
    n = len(layers) * B
    frac = np.array([size_frac[l] for l in layers], dtype=np.float64)
    frac = frac / frac.sum()

    obj = np.zeros(n)
    for i, l in enumerate(layers):
        for j in range(B):
            obj[i * B + j] = -float(sensitivity[l][j])  # maximize

    # one-hot per layer
    A_onehot = np.zeros((len(layers), n))
    for i in range(len(layers)):
        A_onehot[i, i * B : (i + 1) * B] = 1.0
    # weighted average bits within tolerance
    A_budget = np.zeros((1, n))
    for i in range(len(layers)):
        for j, b in enumerate(bits):
            A_budget[0, i * B + j] = frac[i] * b

    # the reference's +-0.02 band assumes ~700 fine-grained layers; for
    # small groups escalate the tolerance until feasible
    res = None
    for tol in (tolerance, 0.05, 0.1, 0.25, 0.5, 1.0):
        if tol < tolerance:
            continue
        res = milp(
            c=obj,
            constraints=[
                LinearConstraint(A_onehot, 1.0, 1.0),
                LinearConstraint(A_budget, target_avg_bits - tol,
                                 target_avg_bits + tol),
            ],
            integrality=np.ones(n),
            bounds=Bounds(0.0, 1.0),
        )
        if res.success:
            if tol != tolerance:
                logger.info("MILP feasible at widened tolerance %.2f", tol)
            break
    if res is None or not res.success:
        logger.warning("MILP infeasible for target %.3f", target_avg_bits)
        return None
    x = np.round(res.x).astype(int).reshape(len(layers), B)
    return {l: bits[int(np.argmax(x[i]))] for i, l in enumerate(layers)}


def achieved_avg_bits(alloc: Dict[str, int],
                      size_frac: Dict[str, float]) -> float:
    """Size-weighted average bit-width actually achieved by an allocation
    (renormalized over the allocated layers). Surfaced because
    ``allocate_bits`` widens the tolerance band when the +-0.02 target is
    infeasible for small groups — a 5.0-bit target can legitimately come
    back at 4.5; callers must be able to see that."""
    if not alloc:
        return 0.0
    tot = sum(size_frac[l] for l in alloc)
    return float(sum(size_frac[l] * b for l, b in alloc.items()) / tot)


def split_budget(
    global_target: float,
    frac_content: float,
    k: float,
    bits_content: Sequence[int] = (2, 4, 8),
    bits_quality: Sequence[int] = (4, 8),
) -> Tuple[float, float]:
    """Split a global average-bit budget between the content and quality
    groups by ratio k (integer_programming.py get_mean_bit :25-32):
    content gets ``k * global``, quality absorbs the remainder, both
    clipped to their feasible bit ranges."""
    fc, fq = frac_content, 1.0 - frac_content
    tc = k * global_target
    tq = (global_target - fc * tc) / fq if fq > 0 else global_target
    tc = float(np.clip(tc, min(bits_content), max(bits_content)))
    tq = float(np.clip(tq, min(bits_quality), max(bits_quality)))
    return tc, tq


def metric_decoupled_allocation(
    sens_content: Dict[str, Sequence[float]],
    sens_quality: Dict[str, Sequence[float]],
    size_frac: Dict[str, float],
    global_target: float,
    k_grid: Sequence[float] = (0.7, 0.8, 0.9, 1.0, 1.1),
    bits_content: Sequence[int] = (2, 4, 8),
    bits_quality: Sequence[int] = (4, 8),
) -> List[Dict[str, int]]:
    """Scan the k grid, producing candidate {layer: bits} configs
    (the reference's bitwidth x k candidate grid, :262-285, 343-367).
    Sensitivities for the quality group must be indexed to bits_quality."""
    frac_content = sum(size_frac[l] for l in sens_content) / max(
        sum(size_frac[l] for l in list(sens_content) + list(sens_quality)),
        1e-12)
    candidates = []
    for k in k_grid:
        tc, tq = split_budget(global_target, frac_content, k,
                              bits_content, bits_quality)
        alloc_c = allocate_bits(sens_content, size_frac, tc, bits_content) \
            if sens_content else {}
        alloc_q = allocate_bits(sens_quality, size_frac, tq, bits_quality) \
            if sens_quality else {}
        if alloc_c is None or alloc_q is None:
            continue
        candidates.append({**alloc_c, **alloc_q})
    return candidates
