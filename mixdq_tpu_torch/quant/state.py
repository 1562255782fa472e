"""Quantization state and context (port of the parts of
``mixdq_tpu/quant/state.py`` the deploy paths read).

* ``canonical_name`` maps a flax module path to the diffusers dotted name
  (``resnets_0`` -> ``resnets.0``); the port's ``nn.Module`` tree already
  carries those names, and ``convert.py`` uses this to map JAX params.
* ``LayerQParams`` holds one layer's multi-bit ``delta``/``zero_point``
  stacks (``*0`` twins for channel-split convs).
* ``LayerCtrl`` holds one layer's enable flags and bit indices;
  ``apply_bitwidth_config`` / ``protect_layers`` set them from a per-layer
  bit map and an act-protect list.
* ``QuantCtx`` is threaded through every module's ``forward``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..models.routing import DEFAULT_OUT_FUSE
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


#: bit-widths a bit map uses for "leave this tensor FP"
FP_BITS = (0, 16, 32)


def apply_bitwidth_config(ctrl: Dict[str, LayerCtrl], bit_config: Dict[str, int],
                          which: str,
                          candidate_bits: Sequence[int] = DEFAULT_CANDIDATE_BITS
                          ) -> Dict[str, LayerCtrl]:
    """Apply a per-layer bit map ``{layer: bits}`` to the weight
    (``which='weight'``) or act (``'act'``) controls: bits 0/16/32 turn
    that tensor's quantization off, any other bits (a candidate) turn it
    on at those bits. A layer the controls do not hold raises
    ``KeyError``."""
    if which not in ("weight", "act"):
        raise ValueError(f"which {which!r}: 'weight' or 'act'")
    cb = list(candidate_bits)
    out = dict(ctrl)
    for name, bits in bit_config.items():
        if name not in out:
            raise KeyError(f"bitwidth config references unknown layer: {name}")
        c = out[name]
        on = bits not in FP_BITS
        idx = cb.index(bits) if on else None
        if which == "weight":
            out[name] = dataclasses.replace(
                c, w_on=on, w_idx=c.w_idx if idx is None else idx)
        else:
            out[name] = dataclasses.replace(
                c, a_on=on, a_idx=c.a_idx if idx is None else idx)
    return out


def protect_layers(ctrl: Dict[str, LayerCtrl], names: Sequence[str]
                   ) -> Dict[str, LayerCtrl]:
    """Turn act quantization off for the listed layers (the act-protect
    list: weight-only layers). A layer the controls do not hold raises
    ``KeyError``."""
    out = dict(ctrl)
    for n in names:
        if n not in out:
            raise KeyError(f"protect list references unknown layer: {n}")
        out[n] = dataclasses.replace(out[n], a_on=False)
    return out


#: deploy compute strategies (``mixdq_tpu/models/layers.py:51``) that the
#: port runs; the JAX package's plain ``'int8'`` (XLA convs) is not ported
DEPLOY_COMPUTE = ("int8_sec", "dequant", "pallas_dequant")
#: sites whose out-projection a whole-block kernel may take over
OUT_FUSE_SITES = frozenset({"attn1", "attn2", "ff"})
#: flash attention's int8 modes at int8 self-attention sites
INT8_FLASH = ("off", "qk", "qkv")


@dataclasses.dataclass(frozen=True)
class QuantCtx:
    """What the model needs to know about quantization. ``mode``: ``'fp'``
    (no quantization; calibration hooks observe this pass) or ``'int8'``
    (deploy entries in ``deploy`` replace the fp weights).

    The int8 mode is the JAX package's ``deploy_compute='int8_sec'``
    (every spatial conv on the int8 conv kernel, GN/LN producers emitting
    codes, 1x1 convs and dense layers on the int8 GEMM kernel).
    ``attn_impl``: ``'einsum'`` (the default, as in the JAX package:
    matmul + softmax chain) or ``'auto'`` (the ``bench.py`` headline: with
    fused QKV/KV, every self-attention runs ``sec_attention_qkv`` and
    every cross-attention ``sec_attention_q_out`` with its pre-LayerNorm
    folded in). ``gelu``: ``'tanh'`` or ``'exact'``.

    The kernel options of the ``int8_sec`` / ``'auto'`` deploy, which the
    JAX package reads from environment variables at trace time (the port
    reads none):

    * ``out_fuse``: the sites, of ``{'attn1', 'attn2', 'ff'}``, whose
      ``to_out`` / ``ff.net.2`` GEMM, bias and residual add run inside
      the whole-block kernel (``sec_attention_qkv_out``,
      ``sec_attention_q_out``, ``geglu_out_qmatmul``) where its gate
      admits the shape: ``MIXDQ_SEC_OUTFUSE``, whose default is
      ``{'attn2'}``; ``frozenset()`` is its ``"0"``, all three sites its
      ``"1"``.
    * ``ln_fold``: a deferred pre-LayerNorm and its act-quantize fold
      into the whole-block kernel (True) or run as ``ln_quantize`` at the
      block first (False): ``MIXDQ_SEC_LNFOLD`` (``"1"`` / ``"0"``).
    * ``int8_flash``: flash attention at int8-mode self-attention sites
      runs QK^T in int8 (``'qk'``: ``int8_flash_attention``), QK^T and PV
      in int8 (``'qkv'``: ``int8qkv_flash_attention``) or in bf16
      (``'off'``): ``MIXDQ_INT8_FLASH`` ``"qk"`` / ``"1"`` / ``"0"``.

    ``deploy_compute`` (int8 mode): ``'int8_sec'`` as above;
    ``'dequant'`` (weight-only: acts stay in the model dtype, packed-W4
    dense entries run ``wq4_matmul``, the others the product with the
    int8 codes and then the per-channel scale, 1x1 convs likewise) or
    ``'pallas_dequant'`` (the same, with ``wq_matmul`` for the int8 dense
    entries; convs keep their act-quantized int8 path, as the JAX package's
    ``resolve_compute`` sends them). Act-protected entries (``act_off``)
    run weight-only under every compute."""

    deploy: Any = None  # Dict[str, DeployEntry]
    mode: str = "fp"
    bos_aware: bool = False
    fuse_qkv: bool = False
    gelu: str = "tanh"
    attn_impl: str = "einsum"
    deploy_compute: str = "int8_sec"
    out_fuse: frozenset = DEFAULT_OUT_FUSE
    ln_fold: bool = True
    int8_flash: str = "off"

    def __post_init__(self):
        if self.mode not in ("fp", "int8"):
            raise ValueError(f"mode {self.mode!r}: this port runs fp/int8")
        if self.gelu not in ("tanh", "exact"):
            raise ValueError(f"gelu {self.gelu!r}")
        if self.attn_impl not in ("einsum", "auto"):
            raise ValueError(f"attn_impl {self.attn_impl!r}: this port runs "
                             "'einsum' or 'auto'")
        if self.deploy_compute not in DEPLOY_COMPUTE:
            raise ValueError(f"deploy_compute {self.deploy_compute!r}: this "
                             f"port runs {DEPLOY_COMPUTE}")
        if (not isinstance(self.out_fuse, frozenset)
                or not self.out_fuse <= OUT_FUSE_SITES):
            raise ValueError(f"out_fuse {self.out_fuse!r}: a frozenset of "
                             f"{sorted(OUT_FUSE_SITES)}")
        if not isinstance(self.ln_fold, bool):
            raise ValueError(f"ln_fold {self.ln_fold!r}: a bool")
        if self.int8_flash not in INT8_FLASH:
            raise ValueError(f"int8_flash {self.int8_flash!r}: one of "
                             f"{INT8_FLASH}")

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
