"""Calibration: multi-bit weight and activation qparams (port of
``mixdq_tpu/quant/calibrate.py``).

* Weights: a pure fit over each quantizable layer's weight.
* Activations: forward pre-hooks on every ``QDense``/``QConv`` record the
  per-tensor (min, max) of the layer input, clamped to contain 0 (the two
  halves of a ``split`` conv input separately, the second under
  ``name + '.split'``); an EMA with momentum 0.95 merges calibration
  batches, and a min-max fit maps the final ranges to qparams.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from .core import QuantSpec, fit_qparams_multibit, fit_weight_qparams
from .state import FP_CTX, LayerQParams, quantizable_layers

Stats = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


@torch.no_grad()
def fit_weight_qparams_tree(model: torch.nn.Module, wq: QuantSpec
                            ) -> Dict[str, LayerQParams]:
    out: Dict[str, LayerQParams] = {}
    for name, m in quantizable_layers(model).items():
        d, z = fit_weight_qparams(m.weight, wq)
        out[name] = LayerQParams(w_delta=d, w_zp=z)
    return out


def _minmax(x: torch.Tensor):
    xf = x.float()
    return torch.clamp(xf.min(), max=0.0), torch.clamp(xf.max(), min=0.0)


@torch.no_grad()
def collect_act_stats(model: torch.nn.Module, batch: Tuple) -> Stats:
    """One fp forward of ``model(*batch)`` with a pre-hook on every
    quantizable layer; returns ``{name[.split]: (min, max)}``."""
    stats: Stats = {}

    def record(key, x):
        mn, mx = _minmax(x)
        if key in stats:
            mn = torch.minimum(stats[key][0], mn)
            mx = torch.maximum(stats[key][1], mx)
        stats[key] = (mn, mx)

    def hook(mod, args, kwargs):
        x = args[0]
        split = kwargs.get("split", 0)
        if split:
            record(mod.qname, x[..., :split])
            record(mod.qname + ".split", x[..., split:])
        else:
            record(mod.qname, x)

    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in quantizable_layers(model).values()]
    try:
        model(*batch, ctx=FP_CTX)
    finally:
        for h in handles:
            h.remove()
    return stats


def ema_update_stats(running: Optional[Stats], new: Stats,
                     momentum: float = 0.95) -> Stats:
    """First batch initializes, later batches EMA-update."""
    if running is None:
        return new
    out = {}
    for k, (mn, mx) in new.items():
        if k in running:
            rmn, rmx = running[k]
            out[k] = (rmn * momentum + mn * (1 - momentum),
                      rmx * momentum + mx * (1 - momentum))
        else:
            out[k] = (mn, mx)
    return out


def fit_act_qparams_from_stats(stats: Stats, aq: QuantSpec
                               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{name: {'a_delta', 'a_zp'[, 'a0_delta', 'a0_zp']}}``."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, (mn, mx) in stats.items():
        is_split = key.endswith(".split")
        name = key[: -len(".split")] if is_split else key
        d, z = fit_qparams_multibit(mn, mx, aq)
        frag = out.setdefault(name, {})
        if is_split:
            frag["a0_delta"], frag["a0_zp"] = d, z
        else:
            frag["a_delta"], frag["a_zp"] = d, z
    return out


def merge_qparams(weight_qp: Dict[str, LayerQParams],
                  act_fragments: Dict[str, Dict[str, torch.Tensor]]
                  ) -> Dict[str, LayerQParams]:
    out = dict(weight_qp)
    for name, frag in act_fragments.items():
        out[name] = out.get(name, LayerQParams()).replace(**frag)
    return out


@torch.no_grad()
def calibrate(model: torch.nn.Module, calib_batches: Iterable[Tuple],
              wq: QuantSpec, aq: QuantSpec,
              momentum: float = 0.95) -> Dict[str, LayerQParams]:
    """Weight fit + running-stat activation fit. ``calib_batches``:
    argument tuples of ``model`` (sample, t, ehs, added)."""
    weight_qp = fit_weight_qparams_tree(model, wq)
    running = None
    for batch in calib_batches:
        running = ema_update_stats(running, collect_act_stats(model, batch),
                                   momentum)
    return merge_qparams(weight_qp,
                         fit_act_qparams_from_stats(running or {}, aq))
