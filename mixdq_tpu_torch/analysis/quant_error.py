"""Offline quantization-error analysis (port of
``mixdq_tpu/analysis/quant_error.py``, the reference's
``analysis_tools/error_func/quant_error.py``):

* ``unet_output_error``: SQNR and MSE of the UNet's output with one
  target (a layer or a dotted block prefix) fake-quantized alone at each
  bit;
* ``weight_error``: each layer's weight fake-quantized at each bit
  against itself;
* ``act_error``: each layer's captured calibration input
  (``quant.state.capture_acts``) fake-quantized at each bit against
  itself;

plus ``tensor_stats`` (min / max / std / kurtosis) and ``weight_stats``.
Results are plain dicts of floats, as the CLI writes them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..quant.core import QuantSpec, fake_quant
from ..quant.state import (QuantCtx, capture_acts, group_ctrl,
                           quantizable_layers)
from ..utils.metrics import mse, sqnr


@torch.inference_mode()
def unet_output_error(model, qparams, targets: Sequence[str],
                      all_names: Sequence[str], calib_batch, fp_out, wq, aq,
                      which: str = "weight", bits: Sequence[int] = (2, 4, 8)
                      ) -> Dict[str, Dict[str, List[float]]]:
    """``{target: {'sqnr': [...], 'mse': [...]}}``, one value a bit."""
    res: Dict[str, Dict[str, List[float]]] = {}
    for t in targets:
        sq, ms = [], []
        for b in bits:
            ctrl = group_ctrl(all_names, [t], which, b, wq.candidate_bits)
            out = model(*calib_batch, ctx=QuantCtx(
                qparams=qparams, ctrl=ctrl, mode="fake", wq=wq, aq=aq))
            sq.append(float(sqnr(fp_out, out)))
            ms.append(float(mse(fp_out, out)))
        res[t] = {"sqnr": sq, "mse": ms}
    return res


@torch.no_grad()
def weight_error(model, qparams, names: Sequence[str], wq: QuantSpec,
                 bits: Sequence[int] = (2, 4, 8)
                 ) -> Dict[str, Dict[str, List[float]]]:
    """``{layer: {'sqnr': [...], 'mse': [...]}}`` of each named layer
    with a weight and qparams, its weight fake-quantized per output
    channel (the last axis) at each bit."""
    layers = quantizable_layers(model)
    cb = list(wq.candidate_bits)
    res = {}
    for n in names:
        if n not in layers or qparams.get(n) is None or \
                layers[n].weight is None:
            continue
        w = layers[n].weight.float()
        qp = qparams[n]
        sq, ms = [], []
        for b in bits:
            bi = cb.index(b)
            d = qp.w_delta[bi]
            shape = [1] * w.ndim
            shape[-1] = w.shape[-1] if d.ndim > 0 else 1
            wq_t = fake_quant(w, d.reshape(shape), qp.w_zp[bi].reshape(shape),
                              b, sym=wq.sym)
            sq.append(float(sqnr(w, wq_t)))
            ms.append(float(mse(w, wq_t)))
        res[n] = {"sqnr": sq, "mse": ms}
    return res


@torch.no_grad()
def act_error(model, qparams, names: Sequence[str], calib_batch,
              aq: QuantSpec, bits: Sequence[int] = (2, 4, 8)
              ) -> Dict[str, Dict[str, List[float]]]:
    """``{layer: {'sqnr': [...], 'mse': [...]}}`` of each named layer with
    act qparams, its input in one FP forward of ``calib_batch``
    fake-quantized at each bit."""
    captured = capture_acts(model, tuple(calib_batch), names=[
        n for n in names if n in quantizable_layers(model)])
    cb = list(aq.candidate_bits)
    res = {}
    for n in names:
        if n not in captured or qparams.get(n) is None:
            continue
        qp = qparams[n]
        if qp.a_delta is None:
            continue
        x = captured[n]
        sq, ms = [], []
        for b in bits:
            bi = cb.index(b)
            xq = fake_quant(x, qp.a_delta[bi], qp.a_zp[bi], b, sym=aq.sym)
            sq.append(float(sqnr(x, xq)))
            ms.append(float(mse(x, xq)))
        res[n] = {"sqnr": sq, "mse": ms}
    return res


def tensor_stats(x: torch.Tensor) -> Dict[str, float]:
    """min / max / std / kurtosis (the distribution analysis numbers)."""
    xf = x.float().reshape(-1)
    mu = xf.mean()
    var = xf.var(unbiased=False)
    kurt = ((xf - mu) ** 4).mean() / (var ** 2 + 1e-12) - 3.0
    return {"min": float(xf.min()), "max": float(xf.max()),
            "std": float(var.sqrt()), "kurtosis": float(kurt)}


def weight_stats(model, names: Sequence[str]) -> Dict[str, Dict[str, float]]:
    layers = quantizable_layers(model)
    return {n: tensor_stats(layers[n].weight) for n in names
            if n in layers and layers[n].weight is not None}
