"""Checkpoints in the JAX package's formats (port of
``mixdq_tpu/quant/checkpoint.py``), read and written by the port's own
msgpack codec (``utils/msgpack.py``): no flax, no ``msgpack`` package.

* qparams: ``{layer name: {field: array}}`` of every ``LayerQParams``
  field that is set, f32 ``[n_bits, C]`` / ``[n_bits]`` stacks (the ``*0``
  twins of channel-split convs included). ``save_qparams`` writes the
  bytes flax's ``msgpack_serialize`` writes for the same dict (maps in
  sorted key order), so either package reads the other's file.
* params: a whole ``Text2ImgPipeline`` as the JAX pipeline's params tree,
  ``{'unet', 'vae', 'text_encoder'[, 'text_encoder_2']}``, each a flax
  params tree (``down_blocks_0/resnets_1/conv1/kernel``, norm ``scale``,
  ``embedding``) in sorted key order, as ``serialization.to_bytes`` of
  the JAX pipeline's params writes it. Each leaf keeps its tensor's dtype
  when written; when read, each leaf keeps the file's dtype until it is
  copied into its parameter, which casts it to the module's dtype.
  ``save_params`` writes leaf by leaf and ``load_params`` reads through
  an ``mmap``, so neither makes a second host copy of the model.
* a params fragment: one module's flax params tree alone (the JAX
  package's ``save_params`` of a converted state dict, as
  ``scripts/convert_checkpoints.py`` writes it): ``save_params_tree``
  writes a tree as it is ordered, ``load_module_params`` reads one into a
  module.
"""

from __future__ import annotations

import dataclasses
import mmap
import os
from typing import Any, Dict, Tuple

import torch
from torch import nn

from .. import convert
from ..models.layers import GroupNorm, LayerNorm
from ..utils.msgpack import pack, unpack
from .state import _LIST_NAMES, LayerQParams, canonical_name

_FIELDS = tuple(f.name for f in dataclasses.fields(LayerQParams))
#: the pipeline's modules, in the JAX pipeline's params order
PARTS = ("unet", "vae", "text_encoder", "text_encoder_2")


def qparams_to_state_dict(qparams: Dict[str, LayerQParams]
                          ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{layer: {field: f32 CPU tensor}}`` of every field that is set."""
    return {name: {f: getattr(qp, f).detach().float().cpu()
                   for f in _FIELDS if getattr(qp, f) is not None}
            for name, qp in qparams.items()}


def state_dict_to_qparams(d: Dict[str, Any], device=None
                          ) -> Dict[str, LayerQParams]:
    return {name: LayerQParams(**{f: torch.as_tensor(v).to(device)
                                  for f, v in frag.items()})
            for name, frag in d.items()}


def _makedirs_for(path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)


def _sorted(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (_sorted(v) if isinstance(v, dict) else v)
            for k, v in sorted(tree.items())}


def save_qparams(qparams: Dict[str, LayerQParams], path: str) -> None:
    _makedirs_for(path)
    with open(path, "wb") as f:
        pack(_sorted(qparams_to_state_dict(qparams)), f.write)


def load_qparams(path: str, device=None) -> Dict[str, LayerQParams]:
    """The qparams of a file (the JAX package's or this port's), on
    ``device`` (default: the CPU)."""
    with open(path, "rb") as f:
        data = bytearray(f.read())
    return state_dict_to_qparams(unpack(data), device)


# ---------------------------------------------------------------------------
# Model params
# ---------------------------------------------------------------------------


def flax_path(name: str) -> Tuple[str, ...]:
    """The flax module path of a port module name, the inverse of
    ``canonical_name`` (``down_blocks.0.resnets.1`` ->
    ``('down_blocks_0', 'resnets_1')``)."""
    parts, out, i = name.split(".") if name else [], [], 0
    while i < len(parts):
        if (parts[i] in _LIST_NAMES and i + 1 < len(parts)
                and parts[i + 1].isdigit()):
            out.append(f"{parts[i]}_{parts[i + 1]}")
            i += 2
        else:
            out.append(parts[i])
            i += 1
    if canonical_name(tuple(out)) != name:
        raise KeyError(f"no flax path for module {name!r}")
    return tuple(out)


def _leaf(module: nn.Module, pname: str) -> str:
    """The flax name of parameter ``pname`` of ``module``."""
    if pname != "weight":
        return pname  # bias, and raw params (position_embedding)
    if isinstance(module, (GroupNorm, LayerNorm)):
        return "scale"
    if isinstance(module, nn.Embedding):
        return "embedding"
    return "kernel"


def module_params(module: nn.Module) -> Dict[str, Any]:
    """The flax params tree of ``module`` (its parameters, not copied),
    in sorted key order."""
    tree: Dict[str, Any] = {}
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            node = tree
            for k in flax_path(mname):
                node = node.setdefault(k, {})
            node[_leaf(m, pname)] = p.detach()
    return _sorted(tree)


def _parts(pipe):
    return [p for p in PARTS if getattr(pipe, p, None) is not None]


def save_params(pipe, path: str) -> None:
    """Write the pipeline's params (``unet``, ``vae``, the text towers) in
    the JAX pipeline's layout, streamed leaf by leaf."""
    _makedirs_for(path)
    tree = {p: module_params(getattr(pipe, p)) for p in _parts(pipe)}
    with open(path, "wb") as f:
        pack(tree, f.write)


@torch.no_grad()
def load_params(pipe, path: str) -> None:
    """Load a params file (the JAX package's ``save_params`` of its
    pipeline's params, or ``save_params`` here) into ``pipe``'s modules,
    each leaf cast to its module's dtype on its device. Every parameter
    must be in the file and every leaf of the file must be a parameter."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    tree = unpack(mm)
    parts = _parts(pipe)
    extra = sorted(set(tree) - set(parts))
    if extra:
        raise KeyError(f"{path}: params of modules the pipeline lacks: "
                       f"{extra}")
    for p in parts:
        if p not in tree:
            raise KeyError(f"{path}: no params for {p}")
        getattr(pipe, p).load_state_dict(
            convert.params_to_state_dict(tree.pop(p)), strict=True)
    del tree
    mm.close()


def save_params_tree(tree: Dict[str, Any], path: str) -> None:
    """Write a params tree (nested dicts of tensors) in its own key order,
    as flax's ``serialization.to_bytes`` writes a dict."""
    _makedirs_for(path)
    with open(path, "wb") as f:
        pack(tree, f.write)


@torch.no_grad()
def load_module_params(module: nn.Module, path: str) -> None:
    """Load a params fragment file (``save_params_tree``, or the JAX
    package's ``save_params`` of one module's tree) into ``module``, each
    leaf cast to its parameter's dtype on its device; every parameter must
    be in the file and every leaf of the file must be a parameter."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    tree = unpack(mm)
    module.load_state_dict(convert.params_to_state_dict(tree), strict=True)
    del tree
    mm.close()
