"""Convert the JAX package's params and qparams, as nested dicts of numpy
arrays, into this port's state dict and ``LayerQParams``.

Flax module paths map to the port's module names through
``canonical_name`` (``down_blocks_0/resnets_1/conv1`` ->
``down_blocks.0.resnets.1.conv1``; the VAE's ``up_blocks_0_resnets_1``
stays as it is). Leaves: ``kernel`` (HWIO or ``[K, N]``, kept as is),
norm ``scale`` and ``nn.Embed``'s ``embedding`` -> ``weight``; ``bias``
-> ``bias``; the raw params of a module (CLIP's ``position_embedding``
and the image tower's ``class_embedding``) keep their names. The same
function carries the UNet's, the CLIP towers' and the VAE's params
(``quant_conv`` / ``post_quant_conv`` included), and those of the
evaluation towers (``CLIPVisionModel``, ``InceptionV3Features``: their
flax names are HF's and torchvision's, which ``canonical_name`` leaves as
they are but for ``layers_i``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .quant.state import LayerQParams, canonical_name

_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
         "bias": "bias"}
#: params a module holds directly (``self.param``), not through a layer
_RAW = ("position_embedding", "class_embedding")


def _flatten(tree: Dict[str, Any], path: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), v


def params_to_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax params tree -> ``state_dict`` of the port. Numpy leaves are
    copied; tensor leaves (``quant.checkpoint.load_params``' views of the
    file) are passed on as they are, for ``load_state_dict`` to copy once
    into the module."""
    out = {}
    for path, v in _flatten(params):
        if path[-1] in _RAW:
            key = canonical_name(path)
        elif path[-1] in _LEAF:
            key = canonical_name(path[:-1]) + "." + _LEAF[path[-1]]
        else:
            raise KeyError(f"unknown param leaf {'/'.join(path)}")
        out[key] = (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.array(v, copy=True)))
    return out


_QP_FIELDS = ("w_delta", "w_zp", "a_delta", "a_zp", "w0_delta", "w0_zp",
              "a0_delta", "a0_zp")


def qparams_from_numpy(qparams: Dict[str, Dict[str, Any]], device=None
                       ) -> Dict[str, LayerQParams]:
    """``{layer: {field: numpy array or None}}`` -> ``LayerQParams``."""
    out = {}
    for name, fields in qparams.items():
        kw = {f: (None if fields.get(f) is None else torch.tensor(
            np.asarray(fields[f]), device=device)) for f in _QP_FIELDS}
        out[name] = LayerQParams(**kw)
    return out


def qparams_to_numpy(qparams: Dict[str, LayerQParams]
                     ) -> Dict[str, Dict[str, Any]]:
    return {name: {f: (None if getattr(qp, f) is None
                       else getattr(qp, f).detach().cpu().numpy())
                   for f in _QP_FIELDS}
            for name, qp in qparams.items()}
