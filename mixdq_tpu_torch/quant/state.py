"""Quantization state and context (port of ``mixdq_tpu/quant/state.py``).

* ``canonical_name`` maps a flax module path to the diffusers dotted name
  (``resnets_0`` -> ``resnets.0``); the port's ``nn.Module`` tree already
  carries those names, and ``convert.py`` uses this to map JAX params.
* ``LayerQParams`` holds one layer's multi-bit ``delta``/``zero_point``
  stacks (``*0`` twins for channel-split convs).
* ``LayerCtrl`` holds one layer's enable flags and bit indices;
  ``apply_bitwidth_config`` / ``protect_layers`` set them from a per-layer
  bit map and an act-protect list; ``group_ctrl``, ``quant_till_ctrl``
  and ``solo_layer_ctrl`` quantize a group of layers, the first ``k`` or
  one alone (the sensitivity sweeps' controls).
* ``QuantCtx`` is threaded through every module's ``forward``; in
  ``'fake'`` mode its ``quant_weight`` / ``quant_act`` fake-quantize each
  layer's weight and input under the layer's control.
* ``capture_acts`` returns each layer's input in one forward.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..models.routing import DEFAULT_OUT_FUSE, EXPLICIT_ATTN
from .core import (DEFAULT_CANDIDATE_BITS, QuantSpec, fake_quant,
                   fake_quant_adaround)

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


def protect_layers(ctrl: Dict[str, LayerCtrl], names: Sequence[str],
                   which: str = "act") -> Dict[str, LayerCtrl]:
    """Turn quantization off for the listed layers: their acts
    (``which='act'``, the act-protect list: weight-only layers), their
    weights (``'weight'``) or both (any other value). A layer the
    controls do not hold raises ``KeyError``."""
    out = dict(ctrl)
    for n in names:
        if n not in out:
            raise KeyError(f"protect list references unknown layer: {n}")
        if which == "act":
            out[n] = dataclasses.replace(out[n], a_on=False)
        elif which == "weight":
            out[n] = dataclasses.replace(out[n], w_on=False)
        else:
            out[n] = dataclasses.replace(out[n], a_on=False, w_on=False)
    return out


def group_ctrl(layer_names: Sequence[str], targets: Sequence[str], which: str,
               bits: int,
               candidate_bits: Sequence[int] = DEFAULT_CANDIDATE_BITS
               ) -> Dict[str, LayerCtrl]:
    """Quantize only the layers a target names, exactly or as a dotted
    prefix: weights (``which='weight'``), acts (``'act'``) or both
    (``'both'``) at ``bits``; every other layer off."""
    ctrl = uniform_ctrl(layer_names, w_on=False, a_on=False,
                        candidate_bits=candidate_bits)
    on = make_ctrl(w_on=which in ("weight", "both"),
                   a_on=which in ("act", "both"), w_bits=bits, a_bits=bits,
                   candidate_bits=candidate_bits)
    for n in layer_names:
        if any(n == t or n.startswith(t + ".") for t in targets):
            ctrl[n] = on
    return ctrl


def quant_till_ctrl(ordered_names: Sequence[str], k: int, which: str = "both",
                    bits: int = 8,
                    candidate_bits: Sequence[int] = DEFAULT_CANDIDATE_BITS
                    ) -> Dict[str, LayerCtrl]:
    """Quantize the first ``k`` layers of ``ordered_names`` only."""
    return group_ctrl(ordered_names, list(ordered_names[:k]), which, bits,
                      candidate_bits)


def solo_layer_ctrl(layer_names: Sequence[str], target: str, which: str,
                    bits: int,
                    candidate_bits: Sequence[int] = DEFAULT_CANDIDATE_BITS
                    ) -> Dict[str, LayerCtrl]:
    """Quantize one layer's weight (``which='weight'``) or acts
    (``'act'``) alone at ``bits``: the sensitivity sweep's control."""
    ctrl = uniform_ctrl(layer_names, w_on=False, a_on=False,
                        candidate_bits=candidate_bits)
    ctrl[target] = make_ctrl(
        w_on=which == "weight", a_on=which == "act",
        w_bits=bits if which == "weight" else candidate_bits[0],
        a_bits=bits if which == "act" else candidate_bits[0],
        candidate_bits=candidate_bits)
    return ctrl


#: deploy compute strategies (``mixdq_tpu/models/layers.py:51``)
DEPLOY_COMPUTE = ("int8", "int8_sec", "dequant", "pallas_dequant")
#: context modes
MODES = ("fp", "fake", "int8")
#: ``attn_impl`` values: the einsum chain, the JAX package's routing by
#: shape, or one attention kernel at every site
ATTN_IMPLS = ("einsum", "auto") + tuple(EXPLICIT_ATTN)
#: GEGLU gates
GELUS = ("tanh", "exact", "sigmoid")
#: sites whose out-projection a whole-block kernel may take over
OUT_FUSE_SITES = frozenset({"attn1", "attn2", "ff"})
#: flash attention's int8 modes at int8 self-attention sites
INT8_FLASH = ("off", "qk", "qkv")


_WQ_DEFAULT = QuantSpec(sym=True, channel_wise=True, round_mode="nearest")
_AQ_DEFAULT = QuantSpec(sym=False, channel_wise=False,
                        round_mode="nearest_ste", running_stat=True)


@dataclasses.dataclass(frozen=True)
class QuantCtx:
    """What the model needs to know about quantization. ``mode``: ``'fp'``
    (no quantization; calibration hooks observe this pass), ``'fake'``
    (fake-quant simulation: each layer's weight and input fake-quantized
    under ``qparams`` and its control in ``ctrl``) or ``'int8'`` (deploy
    entries in ``deploy`` replace the fp weights).

    Fake mode: ``wq`` / ``aq`` are the weight and act quantizers' specs,
    ``softmax_aq`` the softmax probabilities' (always-zero); with
    ``qkv_quant`` the attention's q, k, v (and, with ``softmax_aq``, its
    probabilities) pass through their act quantizers (``QAct``, named
    ``...attn1.act_quantizer_q`` and so on), and then attention runs the
    einsum chain; ``alphas`` ({layer: alpha of the weight's shape}) give
    a layer's weight AdaRound rounding, soft (``soft_round``) or hard.

    ``attn_impl``: ``'einsum'`` (the default, as in the JAX package:
    matmul + softmax chain), ``'auto'`` (the ``bench.py`` headline: with
    fused QKV/KV, every self-attention runs ``sec_attention_qkv`` and
    every cross-attention ``sec_attention_q_out`` with its pre-LayerNorm
    folded in; flash attention at ``Tq * Tk >= 2^22``), or one kernel at
    every site in any mode: ``'flash'`` (``flash_attention``),
    ``'int8_flash'`` (``int8_flash_attention``) or ``'int8qkv_flash'``
    (``int8qkv_flash_attention``); the ``sec_attention*`` kernels run
    only under ``'auto'``. ``gelu``: ``'tanh'``, ``'exact'`` or
    ``'sigmoid'`` (``x * sigmoid(1.702 x)`` in the unfused GEGLU; the
    fused int8 GEGLU kernels take exact gelu for it).

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
    * ``linear_bank``: every act-quantized ``*.time_emb_proj`` entry, all
      reading the same ``silu(emb)``, runs at the top of the UNet forward
      as one ``qmatmul`` over a layer axis per (K, N, act bits) group
      (``deploy.precompute_linear_bank``): ``MIXDQ_LINEAR_BANK``, on by
      default as there (``"0"`` turns it off).
    * ``cross_kv``: every fused cross-attention ``*.attn2.to_kv`` entry,
      all reading the same text embedding, likewise, with its BoS row
      (``deploy.precompute_cross_kv``): ``MIXDQ_CROSS_KV``, off by
      default as there (``"1"`` turns it on).
    * ``dequant_small_m``: the small-M hybrid. A dense layer or 1x1 conv
      whose GEMM has at most this many rows (batch x tokens or pixels)
      runs weight-only (``'dequant'``) instead of act-quantized int8;
      then no LayerNorm producer, no GroupNorm producer before
      ``proj_in``, no GEGLU kernel and no ``sec_attention*`` kernel runs,
      and neither bank (``mixdq_tpu/quant/state.py:276-287``); 0, the
      default, turns it off.

    ``deploy_compute`` (int8 mode): ``'int8_sec'`` (the port's default;
    the JAX package's default is ``'int8'``): every spatial conv on the
    int8 conv kernel with its adds in the epilogue, GN/LN producers
    emitting codes, 1x1 convs and dense layers on the int8 GEMM kernel,
    the whole-attention kernels under ``'auto'``; ``'int8'``: each
    layer's act-quantize as its own pass, then ``qmatmul`` (dense, 1x1
    convs) or ``qconv2d`` / ``qconv2d_s2`` (spatial convs, bias in the
    epilogue, ``extra_bias`` and the residual added after), no GN/LN
    producers and no whole-attention kernels; ``'dequant'`` (weight-only: acts stay in the model dtype, packed-W4
    dense entries run ``wq4_matmul``, the others the product with the
    int8 codes and then the per-channel scale, 1x1 convs likewise) or
    ``'pallas_dequant'`` (the same, with ``wq_matmul`` for the int8 dense
    entries; convs keep their act-quantized int8 path, as the JAX package's
    ``resolve_compute`` sends them). Act-protected entries (``act_off``)
    run weight-only under every compute."""

    deploy: Any = None  # Dict[str, DeployEntry]
    qparams: Any = None  # Dict[str, LayerQParams]
    ctrl: Any = None  # Dict[str, LayerCtrl]
    alphas: Any = None  # Dict[str, torch.Tensor]
    mode: str = "fp"
    bos_aware: bool = False
    fuse_qkv: bool = False
    gelu: str = "tanh"
    attn_impl: str = "einsum"
    deploy_compute: str = "int8_sec"
    out_fuse: frozenset = DEFAULT_OUT_FUSE
    ln_fold: bool = True
    int8_flash: str = "off"
    linear_bank: bool = True
    cross_kv: bool = False
    dequant_small_m: int = 0
    wq: QuantSpec = _WQ_DEFAULT
    aq: QuantSpec = _AQ_DEFAULT
    softmax_aq: Optional[QuantSpec] = None
    qkv_quant: bool = False
    soft_round: bool = False
    #: the process group a batch-wide statistic is all-reduced over: the
    #: dp group of a batch sharded over a mesh (``parallel.mesh``), whose
    #: ranks then take the statistic of the whole batch, as the JAX
    #: package does over its global batch (the int8 flash kernels'
    #: dynamic scales, ``ops/pallas_attention.py:387``); None: one batch
    batch_group: Any = None
    #: the banks' stacked constants, built at a step's first use
    #: (``deploy._bank_groups``); a replaced context starts empty
    bank_cache: dict = dataclasses.field(default_factory=dict, init=False,
                                         compare=False, repr=False)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r}: one of {MODES}")
        if self.gelu not in GELUS:
            raise ValueError(f"gelu {self.gelu!r}: one of {GELUS}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r}: one of "
                             f"{ATTN_IMPLS}")
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
        for f in ("linear_bank", "cross_kv"):
            if not isinstance(getattr(self, f), bool):
                raise ValueError(f"{f} {getattr(self, f)!r}: a bool")
        if not isinstance(self.dequant_small_m, int) or \
                isinstance(self.dequant_small_m, bool) or \
                self.dequant_small_m < 0:
            raise ValueError(f"dequant_small_m {self.dequant_small_m!r}: "
                             "an int >= 0")

    def entry(self, name: str):
        """The deploy entry of layer ``name`` in int8 mode, else None."""
        if self.mode != "int8" or not self.deploy:
            return None
        return self.deploy.get(name)

    def layer(self, name: str):
        """(qparams, control) of layer ``name``, each None if absent."""
        qp = self.qparams.get(name) if self.qparams is not None else None
        ct = self.ctrl.get(name) if self.ctrl is not None else None
        return qp, ct

    def quant_weight(self, name: str, w: torch.Tensor, channel_axis: int = -1,
                     split_part: int = 0) -> torch.Tensor:
        """``w`` fake-quantized under layer ``name``'s weight qparams at its
        control's bits (``split_part`` 1: the ``w0_*`` twins of a split
        conv's second half), per-channel deltas along ``channel_axis``;
        AdaRound rounding where ``alphas`` holds an alpha of ``w``'s shape
        (the primary part only). ``w`` itself outside fake mode, without
        qparams or control, or with the weight control off."""
        if self.mode != "fake":
            return w
        qp, ct = self.layer(name)
        if qp is None or ct is None:
            return w
        delta_l = qp.w_delta if split_part == 0 else qp.w0_delta
        zp_l = qp.w_zp if split_part == 0 else qp.w0_zp
        if delta_l is None or not ct.w_on:
            return w
        bits = self.wq.candidate_bits[ct.w_idx]
        delta, zp = delta_l[ct.w_idx], zp_l[ct.w_idx]
        if delta.ndim > 0:
            shape = [1] * w.ndim
            shape[channel_axis % w.ndim] = w.shape[channel_axis % w.ndim]
            delta, zp = delta.reshape(shape), zp.reshape(shape)
        alpha = (self.alphas.get(name)
                 if self.alphas is not None and split_part == 0 else None)
        if alpha is not None and alpha.shape == w.shape:
            return fake_quant_adaround(w, delta, zp, bits, alpha,
                                       sym=self.wq.sym,
                                       hard=not self.soft_round)
        return fake_quant(w, delta, zp, bits, sym=self.wq.sym,
                          ste=self.wq.round_mode.endswith("ste"))

    def quant_act(self, name: str, x: torch.Tensor, split_part: int = 0,
                  spec: Optional[QuantSpec] = None) -> torch.Tensor:
        """``x`` fake-quantized under layer ``name``'s act qparams (the
        ``a0_*`` twins for ``split_part`` 1) at its control's bits, with
        ``spec`` (default ``aq``); ``x`` itself as ``quant_weight``."""
        if self.mode != "fake":
            return x
        qp, ct = self.layer(name)
        if qp is None or ct is None:
            return x
        delta_l = qp.a_delta if split_part == 0 else qp.a0_delta
        zp_l = qp.a_zp if split_part == 0 else qp.a0_zp
        if delta_l is None or not ct.a_on:
            return x
        sp = spec or self.aq
        return fake_quant(x, delta_l[ct.a_idx], zp_l[ct.a_idx],
                          sp.candidate_bits[ct.a_idx], sym=sp.sym,
                          ste=sp.round_mode.endswith("ste"))


FP_CTX = QuantCtx()


def quantizable_layers(model: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    """``{canonical name: module}`` of every QDense/QConv in ``model``."""
    from ..models.layers import QConv, QDense

    return {n: m for n, m in model.named_modules()
            if isinstance(m, (QDense, QConv))}


def act_quantizers(model: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    """``{name: module}`` of every bare act quantizer (``QAct``: the
    attention's q/k/v/softmax) in ``model``."""
    from ..models.layers import QAct

    return {n: m for n, m in model.named_modules() if isinstance(m, QAct)}


@torch.no_grad()
def capture_acts(model: torch.nn.Module, args: Tuple,
                 ctx: Optional[QuantCtx] = None,
                 names: Optional[Sequence[str]] = None
                 ) -> Dict[str, torch.Tensor]:
    """``{name: input}`` of every quantizable layer and act quantizer (or
    those in ``names``) in one forward ``model(*args, ctx=ctx)`` (default:
    FP); a layer called twice keeps its last input."""
    mods = {**quantizable_layers(model), **act_quantizers(model)}
    if names is not None:
        mods = {n: mods[n] for n in names}
    seen: Dict[str, torch.Tensor] = {}

    def hook(mod, inputs):
        seen[mod.qname] = inputs[0]

    handles = [m.register_forward_pre_hook(hook) for m in mods.values()]
    try:
        model(*args, ctx=FP_CTX if ctx is None else ctx)
    finally:
        for h in handles:
            h.remove()
    return seen
