"""Loaders and pure helpers for the repo's mixed-precision files (port of
``mixdq_tpu/mixed_precision/reference_data.py`` without its validation,
which reads a reference checkout outside the repository).

The files are the search's outputs and the reference's published ones
(``configs/mp/``): sensitivity logs ``{layer: [s2, s4, s8]}``, size-ratio
and bit maps, act-protect lists (YAML, or the reference's torch-saved
``.pt`` list). Each loader strips the reference's ``model.`` prefix and
reads YAML through ``utils/config.py`` (no YAML library). The group-budget
math mirrors the reference's ``get_mean_bit``
(``integer_programming.py:25-32``): ``avg_sqnr = avg * (1 + r) / (k * r
+ 1); avg_ssim = k * avg_sqnr`` with ``r = size_content /
size_quality``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..quant.bitmaps import load_layer_list
from ..utils.config import loads
from .ilp import allocate_bits


def _strip(name: str) -> str:
    return name[len("model."):] if name.startswith("model.") else name


def _load(path: str):
    with open(path) as f:
        return loads(f.read(), path)


def load_sensitivity_yaml(path: str) -> Dict[str, List[float]]:
    """{layer: [s2, s4, s8]} with the ``model.`` prefix stripped."""
    return {_strip(k): [float(x) for x in v] for k, v in _load(path).items()}


def load_ratio_config(path: str) -> Dict[str, float]:
    """Per-layer tensor-size weights (the reference's tensor_ratio
    configs)."""
    return {_strip(k): float(v) for k, v in _load(path).items()}


def load_final_config(path: str) -> Dict[str, int]:
    """A final bit config ({layer: bits})."""
    return {_strip(k): int(v) for k, v in _load(path).items()}


def load_act_protect(path: str) -> List[str]:
    """An act-protect list: the reference's ``.pt`` list of names
    (``quant.bitmaps.load_layer_list``), or a YAML list, or a map whose
    keys count."""
    if path.endswith(".pt"):
        return load_layer_list(path)
    raw = _load(path)
    if isinstance(raw, dict):
        raw = list(raw)
    return [_strip(str(n)) for n in raw]


def is_content_layer(name: str) -> bool:
    """The reference's metric split predicate, substring containment
    (``integer_programming.py:39-43``)."""
    return "ff" in name or "attn2" in name


def reference_budget_split(size_ratio: float, k: float,
                           avg_bits: float) -> Tuple[float, float]:
    """(quality_avg_bits, content_avg_bits) of ``get_mean_bit``;
    ``size_ratio`` = size_content / size_quality."""
    avg_q = avg_bits * (1.0 + size_ratio) / (k * size_ratio + 1.0)
    return avg_q, k * avg_q


def group_avg_bits(config: Dict[str, int], ratio: Dict[str, float],
                   layers: Iterable[str]) -> float:
    """Size-weighted average bits of ``config`` over ``layers``."""
    num = den = 0.0
    for n in layers:
        num += ratio[n] * config[n]
        den += ratio[n]
    return num / den if den else 0.0


def solve_reference_point(
    sens_ssim: Dict[str, List[float]],
    sens_sqnr: Dict[str, List[float]],
    ratio: Dict[str, float],
    avg_content: float,
    avg_quality: float,
    protect: Sequence[str] = (),
    bits_content: Sequence[int] = (2, 4, 8),
    bits_quality: Sequence[int] = (4, 8),
) -> Optional[Dict[str, int]]:
    """One metric-decoupled solve at explicit group budgets: the content
    group (ff/attn2 layers of the SSIM log) over ``bits_content``, the
    quality group (the rest, of the SQNR log) over ``bits_quality``, rows
    ``[s2, s4, s8]`` indexed at ``log2(b) - 1``; ``protect`` layers
    left out of both. None where either solve is infeasible."""
    protect = set(protect)
    sc = {n: [v[int(math.log2(b)) - 1] for b in bits_content]
          for n, v in sens_ssim.items()
          if is_content_layer(n) and n not in protect}
    sq = {n: [v[int(math.log2(b)) - 1] for b in bits_quality]
          for n, v in sens_sqnr.items()
          if not is_content_layer(n) and n not in protect}
    alloc_c = allocate_bits(sc, ratio, avg_content, bits_content)
    alloc_q = allocate_bits(sq, ratio, avg_quality, bits_quality)
    if alloc_c is None or alloc_q is None:
        return None
    return {**alloc_q, **alloc_c}


def compare_configs(ours: Dict[str, int], ref: Dict[str, int],
                    ratio: Dict[str, float]) -> Dict[str, float]:
    """Per-layer agreement of two bit configs over their common layers:
    exact-match fraction, size-weighted match fraction, and both sides'
    size-weighted average bits."""
    common = sorted(set(ours) & set(ref))
    if not common:
        return {"n_common": 0, "agree": 0.0, "agree_weighted": 0.0}
    match = [n for n in common if ours[n] == ref[n]]
    wtot = sum(ratio[n] for n in common)
    wmatch = sum(ratio[n] for n in match)
    return {
        "n_common": len(common),
        "n_match": len(match),
        "agree": len(match) / len(common),
        "agree_weighted": wmatch / wtot if wtot else 0.0,
        "ours_avg_bits": group_avg_bits(ours, ratio, common),
        "ref_avg_bits": group_avg_bits(ref, ratio, common),
    }
