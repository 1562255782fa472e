"""Quantization state and context (port of the parts of
``mixdq_tpu/quant/state.py`` the W8A8 deploy path reads).

* ``canonical_name`` maps a flax module path to the diffusers dotted name
  (``resnets_0`` -> ``resnets.0``); the port's ``nn.Module`` tree already
  carries those names, and ``convert.py`` uses this to map JAX params.
* ``LayerQParams`` holds one layer's multi-bit ``delta``/``zero_point``
  stacks (``*0`` twins for channel-split convs).
* ``LayerCtrl`` holds one layer's enable flags and bit indices.
* ``QuantCtx`` is threaded through every module's ``forward``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from .core import DEFAULT_CANDIDATE_BITS

_LIST_NAMES = (
    "down_blocks", "up_blocks", "resnets", "attentions",
    "transformer_blocks", "downsamplers", "upsamplers", "net", "to_out",
    "layers", "text_projection",
)
_LIST_RE = re.compile(r"^(%s)_(\d+)$" % "|".join(_LIST_NAMES))


def canonical_name(path: Tuple[str, ...]) -> str:
    """Convert a flax module path tuple to the diffusers dotted name."""
    parts = []
    for p in path:
        m = _LIST_RE.match(p)
        parts.append(f"{m.group(1)}.{m.group(2)}" if m else p)
    return ".".join(parts)


@dataclasses.dataclass
class LayerQParams:
    """``w_delta``/``w_zp``: ``[n_bits, C]``; ``a_delta``/``a_zp``:
    ``[n_bits]``; ``*0`` twins only for channel-split layers."""

    w_delta: Optional[torch.Tensor] = None
    w_zp: Optional[torch.Tensor] = None
    a_delta: Optional[torch.Tensor] = None
    a_zp: Optional[torch.Tensor] = None
    w0_delta: Optional[torch.Tensor] = None
    w0_zp: Optional[torch.Tensor] = None
    a0_delta: Optional[torch.Tensor] = None
    a0_zp: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "LayerQParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class LayerCtrl:
    """Per-layer quant controls: enable flags and indices into
    ``candidate_bits``."""

    w_on: bool
    a_on: bool
    w_idx: int
    a_idx: int


def make_ctrl(w_on: bool = True, a_on: bool = True, w_bits: int = 8,
              a_bits: int = 8,
              candidate_bits: Sequence[int] = DEFAULT_CANDIDATE_BITS
              ) -> LayerCtrl:
    cb = list(candidate_bits)
    return LayerCtrl(w_on, a_on, cb.index(w_bits) if w_bits in cb else 0,
                     cb.index(a_bits) if a_bits in cb else 0)


def uniform_ctrl(layer_names: Sequence[str], w_bits: int = 8,
                 a_bits: int = 8, w_on: bool = True, a_on: bool = True,
                 candidate_bits: Sequence[int] = DEFAULT_CANDIDATE_BITS
                 ) -> Dict[str, LayerCtrl]:
    """The same control for every layer."""
    c = make_ctrl(w_on, a_on, w_bits, a_bits, candidate_bits)
    return {n: c for n in layer_names}


@dataclasses.dataclass(frozen=True)
class QuantCtx:
    """What the model needs to know about quantization. ``mode``: ``'fp'``
    (no quantization; calibration hooks observe this pass) or ``'int8'``
    (deploy entries in ``deploy`` replace the fp weights).

    The int8 mode is the JAX package's ``deploy_compute='int8_sec'``
    (every spatial conv on the int8 conv kernel, GN/LN producers emitting
    codes, 1x1 convs and dense layers as int8 GEMMs) with
    ``attn_impl='einsum'`` (matmul + softmax chain). ``gelu``: ``'tanh'``
    or ``'exact'``."""

    deploy: Any = None  # Dict[str, DeployEntry]
    mode: str = "fp"
    bos_aware: bool = False
    fuse_qkv: bool = False
    gelu: str = "tanh"

    def __post_init__(self):
        if self.mode not in ("fp", "int8"):
            raise ValueError(f"mode {self.mode!r}: this port runs fp/int8")
        if self.gelu not in ("tanh", "exact"):
            raise ValueError(f"gelu {self.gelu!r}")

    def entry(self, name: str):
        """The deploy entry of layer ``name`` in int8 mode, else None."""
        if self.mode != "int8" or not self.deploy:
            return None
        return self.deploy.get(name)


FP_CTX = QuantCtx()


def quantizable_layers(model: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    """``{canonical name: module}`` of every QDense/QConv in ``model``."""
    from ..models.layers import QConv, QDense

    return {n: m for n, m in model.named_modules()
            if isinstance(m, (QDense, QConv))}
