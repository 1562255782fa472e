"""Uniform affine quantization (port of ``mixdq_tpu/quant/core.py``).

* symmetric: ``n_levels = 2^(b-1) - 1``, ``delta = absmax / n_levels``,
  zero point 0, codes clamped to ``[-2^(b-1), 2^(b-1) - 1]``;
* asymmetric: ``n_levels = 2^b``, ``delta = (max - min) / (n_levels - 1)``,
  ``zp = round(-min / delta)``, codes clamped to ``[0, 2^b - 1]``;
* ranges contain 0 (``min <= 0 <= max``) and ``delta`` is floored at
  ``EPS`` element-wise;
* ``scale_method='grid_search_lp'`` scans 100 shrink factors of the range
  and keeps the one of least L2 reconstruction loss over all channels.

Fake quantization (``fake_quant``, ``fake_quant_adaround``) divides by
``delta`` (the deploy multiplies by ``1 / delta``) and rounds half to
even, with a straight-through gradient (``round_ste``). Clamps are
``minimum(maximum(x, lo), hi)``, whose gradient at a bound is the JAX
package's ``jnp.clip``'s (half to each side).

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
    """Static description of a quantizer (the JAX package's
    ``QuantSpec``): ``scale_method`` ``'min_max'`` or
    ``'grid_search_lp'``; ``round_mode`` ``'nearest'`` or
    ``'nearest_ste'`` (fake quantization rounds the same, the latter
    with a straight-through gradient)."""

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


# ---------------------------------------------------------------------------
# Rounding and fake quantization
# ---------------------------------------------------------------------------


class _RoundSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, with a straight-through gradient."""
    return _RoundSTE.apply(x)


def stochastic_round(x: torch.Tensor,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """``floor(x) + Bernoulli(x - floor(x))``, the draws from
    ``generator`` (the JAX package draws from a ``jax.random`` key: the two
    agree in distribution, not bit for bit)."""
    x_floor = torch.floor(x)
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=x.dtype)
    return x_floor + (u < x - x_floor).to(x.dtype)


def _bound(v, x: torch.Tensor) -> torch.Tensor:
    """A clamp bound as a tensor (a fill, not a copy from the host: the
    fake step is captured in CUDA graphs)."""
    if isinstance(v, torch.Tensor):
        return v.to(x.dtype)
    return torch.full((), v, dtype=x.dtype, device=x.device)


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, _bound(lo, x)), _bound(hi, x))


def _code_range(n_bits, sym: bool):
    """(lo, hi) of the codes at ``n_bits`` (an int or a 0-d tensor)."""
    if sym:
        n_levels = 2.0 ** (n_bits - 1) - 1.0
        return -n_levels - 1.0, n_levels
    return 0.0, 2.0 ** n_bits - 1.0


def fake_quant(x: torch.Tensor, delta, zero_point, n_bits, sym: bool = False,
               ste: bool = True,
               rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """Quantize, clamp, dequantize: ``(clip(round(x / delta) + zp) - zp) *
    delta`` in f32 (f64 stays f64), cast back to ``x.dtype``. ``rng``: a
    generator for stochastic rounding. ``delta`` / ``zero_point``
    broadcast against ``x``; ``n_bits`` is an int or a 0-d tensor."""
    cdt = x.dtype if x.dtype in (torch.float32, torch.float64) \
        else torch.float32
    xf = x.to(cdt)
    delta = torch.as_tensor(delta, device=x.device).to(cdt)
    zero_point = torch.as_tensor(zero_point, device=x.device).to(cdt)
    scaled = xf / delta
    if rng is not None:
        x_int = stochastic_round(scaled, rng)
    elif ste:
        x_int = round_ste(scaled)
    else:
        x_int = torch.round(scaled)
    x_int = x_int + zero_point
    x_quant = _clip(x_int, *_code_range(n_bits, sym))
    return ((x_quant - zero_point) * delta).to(x.dtype)


ADAROUND_GAMMA, ADAROUND_ZETA = -0.1, 1.1


def adaround_h(alpha: torch.Tensor) -> torch.Tensor:
    """The rectified sigmoid ``h(alpha)`` in [0, 1]."""
    return _clip(torch.sigmoid(alpha) * (ADAROUND_ZETA - ADAROUND_GAMMA)
                 + ADAROUND_GAMMA, 0.0, 1.0)


def fake_quant_adaround(x: torch.Tensor, delta, zero_point, n_bits,
                        alpha: torch.Tensor, sym: bool = True,
                        hard: bool = False) -> torch.Tensor:
    """AdaRound fake quantization: ``code = floor(x / delta) + h(alpha)``
    (soft: the gradient flows to ``alpha``) or ``floor(x / delta) +
    (alpha >= 0)`` (hard: the deployed rounding), in f32."""
    xf = x.float()
    delta = torch.as_tensor(delta, device=x.device).float()
    zero_point = torch.as_tensor(zero_point, device=x.device).float()
    x_floor = torch.floor(xf / delta)
    r = (alpha >= 0).float() if hard else adaround_h(alpha)
    x_quant = _clip(x_floor + r + zero_point, *_code_range(n_bits, sym))
    return ((x_quant - zero_point) * delta).to(x.dtype)


# ---------------------------------------------------------------------------
# Range statistics and fits
# ---------------------------------------------------------------------------


def tensor_minmax(x: torch.Tensor, channel_axis: Optional[int] = None):
    """Per-tensor or per-channel (min, max) in f32, clamped to contain 0."""
    xf = x.float()
    if channel_axis is None:
        x_min, x_max = xf.min(), xf.max()
    else:
        xc = xf.movedim(channel_axis, -1).reshape(-1, x.shape[channel_axis])
        x_min, x_max = xc.min(0).values, xc.max(0).values
    return torch.clamp(x_min, max=0.0), torch.clamp(x_max, min=0.0)


def ema_minmax(prev_min, prev_max, cur_min, cur_max, momentum: float = 0.95):
    """Momentum running-stat update."""
    return (prev_min * momentum + cur_min * (1.0 - momentum),
            prev_max * momentum + cur_max * (1.0 - momentum))


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


def _quantize_with_range(x, x_max, x_min, n_bits: int, always_zero: bool):
    """Quantize ``x`` on an explicit range (the grid search's step);
    ranges broadcast against ``x``."""
    eps = 1e-4
    n_levels = 2 ** n_bits
    if always_zero:
        delta = x_max / (n_levels - 1)
        zero_point = torch.zeros_like(delta)
    else:
        delta = (x_max - x_min) / (n_levels - 1)
        zero_point = torch.round(-x_min / (delta + eps))
    x_int = torch.round(x / (delta + eps))
    x_quant = _clip(x_int + zero_point, 0.0, float(n_levels - 1))
    return (x_quant - zero_point) * delta


#: elements of one chunk of the grid search's ``[steps, C, elems]`` scan
GRID_CHUNK_ELEMS = 1 << 24


def fit_qparams_grid_search_lp(x: torch.Tensor, n_bits: int,
                               channel_wise: bool = False,
                               always_zero: bool = False,
                               num_steps: int = 100):
    """Grid-search-Lp fit: the shrink factor ``k / num_steps`` of the
    min/max range (``k < num_steps``) of least L2 loss (summed over each
    channel's elements, averaged over channels: one factor for all
    channels; the first of equal losses). The steps run in chunks of at
    most ``GRID_CHUNK_ELEMS`` elements, so that no ``[steps, C, elems]``
    tensor of a large weight is made whole."""
    eps = 1e-5
    xf = x.float()
    flat = xf.reshape(xf.shape[0], -1) if channel_wise else xf.reshape(1, -1)
    x_min = torch.clamp(flat.min(-1).values, max=0.0)
    x_max = torch.clamp(flat.max(-1).values, min=0.0)
    scaling = (torch.arange(num_steps, dtype=torch.float32, device=x.device)
               / num_steps)
    scaled_max = x_max[None, :] * scaling[:, None]  # [S, C]
    scaled_min = x_min[None, :] * scaling[:, None]
    chunk = max(1, GRID_CHUNK_ELEMS // flat.numel())
    losses = []
    for s0 in range(0, num_steps, chunk):
        x_q = _quantize_with_range(
            flat[None], scaled_max[s0:s0 + chunk, :, None],
            scaled_min[s0:s0 + chunk, :, None], n_bits, always_zero)
        losses.append(((flat[None] - x_q) ** 2).sum(-1).mean(-1))
    best = torch.argmin(torch.cat(losses))
    if always_zero:
        delta = scaled_max[best] / (2 ** n_bits - 1)
        zero_point = torch.zeros_like(delta)
    else:
        delta = (scaled_max[best] - scaled_min[best]) / (2 ** n_bits - 1)
        zero_point = torch.round(-scaled_min[best] / (delta + eps) + eps)
    delta = torch.clamp(delta, min=EPS)
    if not channel_wise:
        delta, zero_point = delta.reshape(()), zero_point.reshape(())
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
    and ``[K, N]`` layouts); ``grid_search_lp`` fits each bit width over
    the ``[C, elems]`` flattening with the channel axis first."""
    if spec.scale_method == "grid_search_lp":
        wc = w.movedim(channel_axis, 0) if spec.channel_wise else w
        fits = [fit_qparams_grid_search_lp(
            wc, b, channel_wise=spec.channel_wise,
            always_zero=spec.always_zero) for b in spec.candidate_bits]
        return (torch.stack([d for d, _ in fits]),
                torch.stack([z for _, z in fits]))
    if spec.scale_method != "min_max":
        raise ValueError(f"scale_method {spec.scale_method!r}")
    x_min, x_max = tensor_minmax(
        w, channel_axis % w.ndim if spec.channel_wise else None)
    return fit_qparams_multibit(x_min, x_max, spec)


# ---------------------------------------------------------------------------
# Per-channel fake quantization, integer codes, loss
# ---------------------------------------------------------------------------


def _channel_view(v: torch.Tensor, w: torch.Tensor, channel_axis: int):
    shape = [1] * w.ndim
    shape[channel_axis % w.ndim] = w.shape[channel_axis % w.ndim]
    return v.reshape(shape)


def fake_quant_channelwise(w: torch.Tensor, delta: torch.Tensor,
                           zero_point: torch.Tensor, n_bits,
                           channel_axis: int = -1, sym: bool = True,
                           ste: bool = True) -> torch.Tensor:
    """Fake-quant ``w`` with ``[C]`` ``delta`` / ``zero_point`` along
    ``channel_axis`` (or 0-d ones for the whole tensor)."""
    if delta.ndim == 0:
        return fake_quant(w, delta, zero_point, n_bits, sym=sym, ste=ste)
    return fake_quant(w, _channel_view(delta, w, channel_axis),
                      _channel_view(zero_point, w, channel_axis), n_bits,
                      sym=sym, ste=ste)


def quantize_weight_int(w: torch.Tensor, delta: torch.Tensor,
                        channel_axis: int = -1, n_bits: int = 8
                        ) -> torch.Tensor:
    """Symmetric int8 weight codes in ``[-2^(b-1), 2^(b-1) - 1]``."""
    if delta.ndim > 0:
        delta = _channel_view(delta, w, channel_axis)
    lo, hi = -(2 ** (n_bits - 1)), 2 ** (n_bits - 1) - 1
    return torch.clamp(torch.round(w.float() / delta), lo, hi).to(torch.int8)


def quantize_act_int(x: torch.Tensor, delta, zero_point) -> torch.Tensor:
    """Asymmetric per-tensor act codes shifted by -128 into int8."""
    codes = torch.round(x.float() / delta) + (zero_point - 128.0)
    return torch.clamp(codes, -128, 127).to(torch.int8)


def lp_loss(pred: torch.Tensor, tgt: torch.Tensor, p: float = 2.0,
            reduction: str = "none") -> torch.Tensor:
    """L_p reconstruction loss: ``'none'`` sums squared errors over all
    but the first axis and averages over it; ``'all'`` averages
    ``|d|^p``."""
    diff = torch.abs(pred - tgt)
    if reduction == "none":
        sq = diff ** 2
        if pred.ndim > 1:
            sq = sq.sum(tuple(range(1, pred.ndim)))
        return torch.mean(sq)
    if reduction == "all":
        return torch.mean(diff ** p)
    raise NotImplementedError(reduction)
