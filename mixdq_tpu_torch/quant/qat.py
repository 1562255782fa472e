"""Quantization-aware training step (port of ``mixdq_tpu/quant/qat.py``):
the model's weights and every float tensor of its qparams train together
through fake quantization's round STE, with Adam.

It is also the port's sharded training step, as the JAX package's is:
over a (dp, tp) ``mesh`` (``parallel.mesh``) each rank feeds its dp share
of the batch (``shard_batch_tree``) to a model whose parameters
(``shard_module``) and qparams (``shard_tree``) are tp-sharded and
gathered, with gradients, where they are read; the gradients and the loss
are averaged over dp, which is JAX's mean over the global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from ..parallel import mesh as pmesh
from .core import QuantSpec
from .state import LayerQParams, QuantCtx


def _qparams_tensors(qparams: Dict[str, LayerQParams]
                     ) -> List[torch.Tensor]:
    """Every float tensor of ``qparams`` (``w/a_delta``, ``w/a_zp`` and the
    ``*0`` twins), in layer-name order; of a ``ShardedTree``, this rank's
    shards."""
    qparams = getattr(qparams, "local", qparams)
    out = []
    for n in sorted(qparams):
        for f in dataclasses.fields(LayerQParams):
            t = getattr(qparams[n], f.name)
            if t is not None and t.is_floating_point():
                out.append(t)
    return out


def make_qat_train_step(model: torch.nn.Module, wq: QuantSpec,
                        aq: QuantSpec, ctrl: Dict[str, Any],
                        lr: float = 1e-4, mesh=None):
    """Returns ``(init_fn, step_fn)``:

    ``init_fn(params, qparams) -> opt_state``
    ``step_fn(params, qparams, opt_state, batch_args, target)
        -> (params, qparams, opt_state, loss)``

    ``params``: the model's parameters (``dict(model.named_parameters())``,
    the tensors the forward reads); ``qparams``: ``{layer:
    LayerQParams}``. ``init_fn`` makes the qparams' float tensors leaves
    that take gradients and returns Adam (optax's defaults: betas 0.9 /
    0.999, eps 1e-8) over both; ``step_fn`` runs the fake-quant forward
    ``model(*batch_args, ctx=...)``, the loss ``mean((out - target)^2)``
    and one Adam step, updating both in place (each tensor's ``.grad``
    holds this step's gradient until the next step), and returns them
    with the loss (a detached 0-d tensor). With a ``mesh``, ``params`` and
    ``qparams`` are the sharded model's and ``batch_args`` / ``target``
    this rank's dp share; gradients and loss are averaged over dp."""

    def init_fn(params, qparams):
        tensors = list(params.values())
        for t in _qparams_tensors(qparams):
            t.requires_grad_(True)
            tensors.append(t)
        return torch.optim.Adam(tensors, lr=lr, betas=(0.9, 0.999),
                                eps=1e-8)

    def step_fn(params, qparams, opt_state, batch, target):
        ctx = QuantCtx(qparams=qparams, ctrl=ctrl, mode="fake", wq=wq, aq=aq)
        opt_state.zero_grad(set_to_none=True)
        with torch.enable_grad():
            out = model(*batch, ctx=ctx)
            loss = torch.mean((out - target) ** 2)
            loss.backward()
        loss = loss.detach()
        if mesh is not None:
            pmesh.dp_mean_([t.grad for g in opt_state.param_groups
                            for t in g["params"] if t.grad is not None]
                           + [loss], mesh)
        opt_state.step()
        return params, qparams, opt_state, loss

    return init_fn, step_fn
