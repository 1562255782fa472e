"""Calibration: multi-bit weight and activation qparams (port of
``mixdq_tpu/quant/calibrate.py``).

* Weights: a pure fit over each quantizable layer's weight; a
  channel-split conv (``splits``: the up blocks' concat-shortcut convs)
  gets twin fits over its two input-channel slices, the first in
  ``w_delta`` / ``w_zp`` and the second in ``w0_delta`` / ``w0_zp``.
* Activations: forward pre-hooks on every ``QDense``/``QConv`` record the
  per-tensor (min, max) of the layer input, clamped to contain 0 (the two
  halves of a ``split`` conv input separately, the second under
  ``name + '.split'``); an EMA with momentum 0.95 merges calibration
  batches, and a min-max fit maps the final ranges to qparams. With a
  softmax spec (``softmax_aq``) the forward runs with the attention's
  q/k/v/softmax act quantizers on (``qkv_quant``) and their hooks record
  too; names that contain ``'softmax'`` are fitted under ``softmax_aq``.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch

from .core import QuantSpec, fit_qparams_multibit, fit_weight_qparams
from .state import (FP_CTX, LayerQParams, QuantCtx, act_quantizers,
                    quantizable_layers)

Stats = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


@torch.no_grad()
def fit_weight_qparams_tree(model: torch.nn.Module, wq: QuantSpec,
                            splits: Optional[Dict[str, int]] = None
                            ) -> Dict[str, LayerQParams]:
    """Multi-bit weight qparams of every quantizable layer; a conv in
    ``splits`` ({name: split}) gets twins over HWIO input channels
    ``[:split]`` and ``[split:]``."""
    splits = splits or {}
    out: Dict[str, LayerQParams] = {}
    for name, m in quantizable_layers(model).items():
        w = m.weight
        if name in splits and w.ndim == 4:
            s = splits[name]
            d, z = fit_weight_qparams(w[:, :, :s, :], wq)
            d0, z0 = fit_weight_qparams(w[:, :, s:, :], wq)
            out[name] = LayerQParams(w_delta=d, w_zp=z, w0_delta=d0,
                                     w0_zp=z0)
        else:
            d, z = fit_weight_qparams(w, wq)
            out[name] = LayerQParams(w_delta=d, w_zp=z)
    return out


def _minmax(x: torch.Tensor):
    xf = x.float()
    return torch.clamp(xf.min(), max=0.0), torch.clamp(xf.max(), min=0.0)


@torch.no_grad()
def collect_act_stats(model: torch.nn.Module, batch: Tuple,
                      ctx: QuantCtx = FP_CTX) -> Stats:
    """One fp forward of ``model(*batch)`` under ``ctx`` (an fp context)
    with a pre-hook on every quantizable layer and act quantizer (which
    the forward calls under ``ctx.qkv_quant``); returns
    ``{name[.split]: (min, max)}``."""
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

    mods = {**quantizable_layers(model), **act_quantizers(model)}
    handles = [m.register_forward_pre_hook(hook, with_kwargs=True)
               for m in mods.values()]
    try:
        model(*batch, ctx=ctx)
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


def fit_act_qparams_from_stats(stats: Stats, aq: QuantSpec,
                               softmax_aq: Optional[QuantSpec] = None
                               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{name: {'a_delta', 'a_zp'[, 'a0_delta', 'a0_zp']}}``; names that
    contain ``'softmax'`` under ``softmax_aq`` when given."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, (mn, mx) in stats.items():
        is_split = key.endswith(".split")
        name = key[: -len(".split")] if is_split else key
        spec = (softmax_aq if softmax_aq is not None and "softmax" in name
                else aq)
        d, z = fit_qparams_multibit(mn, mx, spec)
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
              softmax_aq: Optional[QuantSpec] = None,
              splits: Optional[Dict[str, int]] = None,
              momentum: float = 0.95) -> Dict[str, LayerQParams]:
    """Weight fit + running-stat activation fit (the JAX package's
    signature). ``calib_batches``: argument tuples of ``model`` (sample,
    t, ehs, added); ``softmax_aq``: the softmax quantizer's spec, which
    also turns on the q/k/v/softmax act quantizers' stats; ``splits``: the
    channel-split convs whose weights get twin fits (their act halves are
    recorded apart whether or not they are named here, as in the JAX
    package)."""
    weight_qp = fit_weight_qparams_tree(model, wq, splits)
    ctx = QuantCtx(qkv_quant=softmax_aq is not None, softmax_aq=softmax_aq)
    running = None
    for batch in calib_batches:
        running = ema_update_stats(
            running, collect_act_stats(model, batch, ctx), momentum)
    return merge_qparams(weight_qp, fit_act_qparams_from_stats(
        running or {}, aq, softmax_aq))
