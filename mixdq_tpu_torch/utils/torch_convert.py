"""Readers of public state dicts for the evaluation towers (the part of
``mixdq_tpu/utils/torch_convert.py`` that ``scripts/evaluate.py`` needs):
each maps a state dict in its public naming onto the port's module names,
for ``load_state_dict(..., strict=True)``.

* ``load_inception_state_dict``: torchvision ``Inception3`` (or
  pytorch-fid's FID Inception) -> ``models.inception.InceptionV3Features``,
  each ``<block>.conv`` + ``<block>.bn`` pair folded into one conv with
  bias, as the JAX converter folds it.
* ``load_clip_vision_state_dict``: HF ``CLIPVisionModel(WithProjection)``
  (``vision_model.*``, ``visual_projection.weight``) ->
  ``models.clip.CLIPVisionModel``.

Torch weights are ``[out, in]`` and OIHW; the port's are ``[in, out]``
and HWIO (flax's layouts). A leaf a reader does not know raises (the JAX
converter logs a warning and drops it): a dropped leaf would leave a
random weight inside a metric.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import torch

StateDict = Dict[str, torch.Tensor]

_BN_LEAF = re.compile(
    r"^(.*)\.(conv\.weight|bn\.weight|bn\.bias|bn\.running_mean"
    r"|bn\.running_var)$")
_CLIP_LAYER = re.compile(
    r"^encoder\.layers\.(\d+)\.(self_attn\.(?:q|k|v|out)_proj|mlp\.fc1"
    r"|mlp\.fc2|layer_norm1|layer_norm2)\.(weight|bias)$")


def _tensor(v: Any) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v)


def load_inception_state_dict(sd: Mapping[str, Any], bn_eps: float = 1e-3
                              ) -> StateDict:
    """torchvision ``Inception3`` state dict -> ``InceptionV3Features``'s.
    ``w' = w * gamma / sqrt(var + eps)`` (as HWIO), ``b' = beta - mean *
    gamma / sqrt(var + eps)``, in float32 (``gamma`` 1 and ``beta`` 0 where
    the bn has none). ``fc.*``, ``AuxLogits.*`` and ``num_batches_tracked``
    are skipped (FID reads pool3)."""
    blocks: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, v in sd.items():
        if name.startswith(("fc.", "AuxLogits.")) or \
                name.endswith("num_batches_tracked"):
            continue
        m = _BN_LEAF.match(name)
        if not m:
            raise KeyError(f"unknown Inception3 leaf {name!r}")
        blocks.setdefault(m.group(1), {})[m.group(2)] = _tensor(v).float()
    out: StateDict = {}
    for block, d in blocks.items():
        w = d["conv.weight"]  # OIHW
        gamma = d.get("bn.weight", torch.ones(w.shape[0]))
        beta = d.get("bn.bias", torch.zeros(w.shape[0]))
        # the square root in f64, then rounded: numpy's correctly rounded
        # f32 sqrt (torch's vectorized f32 sqrt on the CPU is an ulp off
        # at times)
        s = gamma / torch.sqrt((d["bn.running_var"] + bn_eps).double()
                               ).float()
        out[f"{block}.conv.weight"] = (w * s[:, None, None, None]).permute(
            2, 3, 1, 0).contiguous()
        out[f"{block}.conv.bias"] = beta - d["bn.running_mean"] * s
    return out


def load_clip_vision_state_dict(sd: Mapping[str, Any]) -> StateDict:
    """HF CLIP vision state dict (``vision_model.`` prefix optional) ->
    ``CLIPVisionModel``'s. ``embeddings.position_ids`` (an index buffer,
    no weight) is skipped."""
    out: StateDict = {}
    for name, v in sd.items():
        w = _tensor(v)
        n = re.sub(r"^vision_model\.", "", name)
        if n == "embeddings.position_ids":
            continue
        if n == "embeddings.class_embedding":
            out["class_embedding"] = w
        elif n == "embeddings.patch_embedding.weight":
            out["patch_embedding.weight"] = w.permute(2, 3, 1, 0).contiguous()
        elif n == "embeddings.position_embedding.weight":
            out["position_embedding"] = w
        elif n in ("pre_layrnorm.weight", "pre_layrnorm.bias",
                   "post_layernorm.weight", "post_layernorm.bias"):
            out[n] = w
        elif n == "visual_projection.weight":
            out[n] = w.T.contiguous()
        else:
            m = _CLIP_LAYER.match(n)
            if not m:
                raise KeyError(f"unknown CLIP vision leaf {name!r}")
            i, mod, leaf = m.groups()
            key = f"layers.{i}.{mod.replace('mlp.', '')}.{leaf}"
            out[key] = w.T.contiguous() if w.ndim == 2 else w
    return out
