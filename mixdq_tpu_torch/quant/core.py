"""Uniform affine quantizer fits (port of the min-max part of
``mixdq_tpu/quant/core.py``).

* symmetric: ``n_levels = 2^(b-1) - 1``, ``delta = absmax / n_levels``,
  zero point 0;
* asymmetric: ``n_levels = 2^b``, ``delta = (max - min) / (n_levels - 1)``,
  ``zp = round(-min / delta)``;
* ranges contain 0 (``min <= 0 <= max``) and ``delta`` is floored at
  ``EPS`` element-wise.

All fits return float32 tensors stacked over ``candidate_bits``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

EPS = 1e-6
DEFAULT_CANDIDATE_BITS: Tuple[int, ...] = (2, 4, 8)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of a quantizer (same fields as the JAX
    package's ``QuantSpec``; this port fits ``scale_method='min_max'``)."""

    n_bits: int = 8
    sym: bool = False
    channel_wise: bool = False
    scale_method: str = "min_max"
    round_mode: str = "nearest_ste"
    always_zero: bool = False
    running_stat: bool = False
    momentum: float = 0.95
    candidate_bits: Tuple[int, ...] = DEFAULT_CANDIDATE_BITS


def n_levels_for(n_bits: int, sym: bool) -> int:
    return 2 ** (n_bits - 1) - 1 if sym else 2 ** n_bits


def tensor_minmax(x: torch.Tensor, channel_axis: Optional[int] = None):
    """Per-tensor or per-channel (min, max) in f32, clamped to contain 0."""
    xf = x.float()
    if channel_axis is None:
        x_min, x_max = xf.min(), xf.max()
    else:
        xc = xf.movedim(channel_axis, -1).reshape(-1, x.shape[channel_axis])
        x_min, x_max = xc.min(0).values, xc.max(0).values
    return torch.clamp(x_min, max=0.0), torch.clamp(x_max, min=0.0)


def fit_qparams_minmax(x_min: torch.Tensor, x_max: torch.Tensor, n_bits: int,
                       sym: bool = False, always_zero: bool = False):
    """Min-max ``(delta, zero_point)`` for scalars or per-channel vectors."""
    n_levels = n_levels_for(n_bits, sym)
    if sym:
        delta = torch.maximum(x_min.abs(), x_max.abs()) / n_levels
    else:
        delta = (x_max - x_min) / (n_levels - 1)
    delta = torch.clamp(delta, min=EPS)
    if sym or always_zero:
        zero_point = torch.zeros_like(delta)
    else:
        zero_point = torch.round(-x_min / delta)
    return delta.float(), zero_point.float()


def fit_qparams_multibit(x_min: torch.Tensor, x_max: torch.Tensor,
                         spec: QuantSpec):
    """``(delta_list, zero_point_list)`` stacked over ``candidate_bits``:
    shape ``[n_candidate_bits, *x_min.shape]``."""
    fits = [fit_qparams_minmax(x_min, x_max, b, sym=spec.sym,
                               always_zero=spec.always_zero)
            for b in spec.candidate_bits]
    return (torch.stack([d for d, _ in fits]),
            torch.stack([z for _, z in fits]))


def fit_weight_qparams(w: torch.Tensor, spec: QuantSpec,
                       channel_axis: int = -1):
    """Multi-bit weight fit over the output-channel axis (last for HWIO
    and ``[K, N]`` layouts)."""
    if spec.scale_method != "min_max":
        raise NotImplementedError(
            f"scale_method {spec.scale_method!r}: this port fits min_max")
    x_min, x_max = tensor_minmax(
        w, channel_axis % w.ndim if spec.channel_wise else None)
    return fit_qparams_multibit(x_min, x_max, spec)
