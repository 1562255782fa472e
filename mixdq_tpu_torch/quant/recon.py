"""PTQ reconstruction: gradient-based quant-parameter optimization (port of
``mixdq_tpu/quant/recon.py``).

Every layer's quant parameters are optimized jointly with Adam in fake
mode, against FP targets from one FP forward per batch, cached on the
device in the model's dtype. The loss is

    mean((out - fp_out)^2) + sum_i mean((inter_i - fp_inter_i)^2)

over the intermediates of ``mode``: ``'layer'`` (every ``QDense`` /
``QConv`` output), ``'block'`` (every ``ResnetBlock2D`` /
``Transformer2DModel`` output) or ``'model'`` (the output alone); with
``adaround``, plus ``reg_weight * round_reg(alphas, temp_decay(step))``
(b: 10 -> 2 after a 20 % warm-up).

The intermediates are what flax's ``capture_intermediates`` records with
the JAX package's filter: the return value of every call of every method
of a module of those classes, so a ``QConv`` adds its ``_conv`` (the bare
convolution) beside its output and a ``ResnetBlock2D`` its two
``_norm_act`` results beside its output. Hooks record them here (forward
hooks on the calls, the methods wrapped on the instance), and go when
``reconstruct`` returns.

Trainables:

* per layer, ``log(max(w_delta[bit_idx], EPS))``: the weight scale at the
  active bits, learned through the round STE (a split conv's ``w0_delta``
  twin stays as it is);
* with ``adaround``, one AdaRound ``alpha`` per weight element, from
  ``init_alpha(w, delta)`` over the whole kernel, delta along the
  out-channel (last) axis. The soft rounding ``floor(w / delta) +
  h(alpha)`` runs in the loss, so the alphas take loss gradients; fake
  mode applies an alpha only where it has the weight's shape (a split
  conv's halves run without).
"""

from __future__ import annotations

import contextlib
import logging
from typing import Dict, List, Optional

import torch

from .core import ADAROUND_GAMMA as GAMMA
from .core import ADAROUND_ZETA as ZETA
from .core import EPS, QuantSpec, adaround_h
from .state import FP_CTX, LayerQParams, QuantCtx, make_ctrl, \
    quantizable_layers

logger = logging.getLogger(__name__)

#: ``h(alpha) = clip(sigmoid(alpha) (zeta - gamma) + gamma, 0, 1)``
rect_sigmoid = adaround_h


def init_alpha(w: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """The alpha whose ``rect_sigmoid`` is the fractional rest of
    ``w / delta`` (clipped to [1e-4, 1 - 1e-4])."""
    rest = w / delta - torch.floor(w / delta)
    rest = torch.clamp(rest, 1e-4, 1.0 - 1e-4)
    return -torch.log((ZETA - GAMMA) / (rest - GAMMA) - 1.0)


def round_reg(alphas: Dict[str, torch.Tensor], b) -> torch.Tensor:
    """The rounding regularizer ``sum(1 - |2h - 1|^b)`` over every alpha,
    in layer-name order (the JAX package's leaf order)."""
    total = 0.0
    for n in sorted(alphas):
        h = rect_sigmoid(alphas[n])
        total = total + torch.sum(1.0 - torch.abs(2.0 * h - 1.0) ** b)
    return total


def temp_decay(step, iters: int, b_start: float = 10.0, b_end: float = 2.0,
               warmup: float = 0.2) -> torch.Tensor:
    """Linear temperature decay: ``b_start`` through the warm-up, then
    linearly to ``b_end`` at ``iters`` (f32, on ``step``'s device)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    start = warmup * iters
    t = torch.clamp((step - start) / (iters - start), 0.0, 1.0)
    return torch.where(step < start, torch.full_like(step, b_start),
                       b_end + (b_start - b_end) * (1.0 - t))


def _capture_targets(mode: str):
    """{module class: its methods recorded beside its calls} of ``mode``
    (None: no intermediates)."""
    from ..models.attention import Transformer2DModel
    from ..models.layers import QConv, QDense
    from ..models.resnet import ResnetBlock2D

    if mode == "layer":
        return {QDense: (), QConv: ("_conv",)}
    if mode == "block":
        return {ResnetBlock2D: ("_norm_act",), Transformer2DModel: ()}
    if mode == "model":
        return None
    raise ValueError(f"mode {mode!r}: 'layer', 'block' or 'model'")


@contextlib.contextmanager
def capture_intermediates(model: torch.nn.Module, mode: str):
    """Within the block, every forward of ``model`` appends its
    intermediates of ``mode`` to the yielded list, in call order."""
    targets = _capture_targets(mode)
    store: List[torch.Tensor] = []
    handles, wrapped = [], []
    for m in model.modules() if targets else ():
        methods = targets.get(type(m))
        if methods is None:
            continue
        handles.append(m.register_forward_hook(
            lambda mod, args, out: store.append(out)))
        for meth in methods:
            fn = getattr(m, meth)

            def rec(*a, _fn=fn, **kw):
                y = _fn(*a, **kw)
                store.append(y)
                return y

            setattr(m, meth, rec)
            wrapped.append((m, meth))
    try:
        yield store
    finally:
        for h in handles:
            h.remove()
        for m, meth in wrapped:
            delattr(m, meth)


def _forward(model, ctx, batch, mode):
    with capture_intermediates(model, mode) as inter:
        out = model(*batch, ctx=ctx)
    return out, inter


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def reconstruct(model: torch.nn.Module, qparams: Dict[str, LayerQParams],
                batches, wq: QuantSpec, aq: QuantSpec, mode: str = "layer",
                iters: int = 200, lr: float = 1e-3, adaround: bool = False,
                reg_weight: float = 0.01, bit_idx: Optional[int] = None,
                outdir: Optional[str] = None, return_alphas: bool = False,
                losses: Optional[list] = None):
    """Optimize each layer's ``w_delta`` at ``bit_idx`` (default: the
    index of ``wq.n_bits``), and with ``adaround`` its AdaRound alphas,
    over ``batches`` (argument tuples of ``model``, taken in turn), and
    return the updated qparams (new ``LayerQParams``; ``qparams`` is left
    as it is). With ``return_alphas``: ``(qparams, {layer: alpha})``, the
    alphas for ``QuantCtx(alphas=...)`` (hard rounding) or
    ``build_deploy_params(alphas=...)`` (folded into the codes).
    ``losses``: a list that receives each step's loss (a detached 0-d
    tensor). ``outdir`` is accepted for the JAX signature and unused."""
    del outdir
    if bit_idx is None:
        bit_idx = list(wq.candidate_bits).index(wq.n_bits)
    names = sorted(qparams)
    layers = quantizable_layers(model)

    log_delta: Dict[str, torch.Tensor] = {}
    alphas: Dict[str, torch.Tensor] = {}
    for n in names:
        qp = qparams[n]
        if qp.w_delta is None:
            continue
        d = qp.w_delta[bit_idx].detach()
        log_delta[n] = torch.log(torch.clamp(d, min=EPS)).requires_grad_()
        if adaround and n in layers:
            w = layers[n].weight.detach()
            dshape = [1] * w.ndim
            dshape[-1] = w.shape[-1] if d.ndim > 0 else 1
            alphas[n] = init_alpha(w, d.reshape(dshape)).requires_grad_()

    ctrl = {n: make_ctrl(w_bits=wq.candidate_bits[bit_idx],
                         a_bits=aq.n_bits, candidate_bits=wq.candidate_bits)
            for n in names}

    def apply_qparams():
        qp2 = dict(qparams)
        for n, ld in log_delta.items():
            wd = qp2[n].w_delta.clone()
            wd[bit_idx] = torch.exp(ld)
            qp2[n] = qp2[n].replace(w_delta=wd)
        return qp2

    with torch.no_grad():
        fp_cache = [_forward(model, FP_CTX, b, mode) for b in batches]

    opt = torch.optim.Adam(list(log_delta.values()) + list(alphas.values()),
                           lr=lr, betas=(0.9, 0.999), eps=1e-8)
    # the model's weights take no gradient (JAX differentiates the
    # trainables alone)
    frozen = [p for p in model.parameters() if p.requires_grad]
    for p in frozen:
        p.requires_grad_(False)
    try:
        with torch.enable_grad():
            for step in range(iters):
                bi = step % len(batches)
                fp_out, fp_inter = fp_cache[bi]
                ctx = QuantCtx(qparams=apply_qparams(), ctrl=ctrl,
                               mode="fake", wq=wq, aq=aq,
                               alphas=alphas or None, soft_round=True)
                out, inter = _forward(model, ctx, batches[bi], mode)
                if len(inter) != len(fp_inter):
                    raise AssertionError(
                        f"{len(inter)} intermediates in the fake forward, "
                        f"{len(fp_inter)} in the FP one")
                loss = _mse(out, fp_out)
                for a, b in zip(inter, fp_inter):
                    loss = loss + _mse(a, b)
                if adaround:
                    temp = temp_decay(torch.tensor(float(step),
                                                   device=out.device), iters)
                    loss = loss + reg_weight * round_reg(alphas, temp)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                if losses is not None:
                    losses.append(loss.detach())
                if step % 50 == 0:
                    logger.info("recon step %d loss %.6f", step,
                                float(loss.detach()))
    finally:
        for p in frozen:
            p.requires_grad_(True)

    with torch.no_grad():
        qparams = apply_qparams()
    if return_alphas:
        return qparams, {n: a.detach() for n, a in alphas.items()}
    return qparams
