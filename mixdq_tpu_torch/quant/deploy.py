"""W8A8 deployment: int8 weights and fused-epilogue constants per layer
(port of the W8A8 part of ``mixdq_tpu/quant/deploy.py``).

Each deploy entry carries ``w_int`` (int8 codes), ``scale = s_w * s_a``,
``bias0 = zp_s * sum_K(w_int)``, and the act-quantize constants
``scale_inv``/``zp_shifted`` (Python floats, launch arguments of the
kernels). Self-attention q/k/v and cross-attention k/v fold into fused
``to_qkv``/``to_kv`` entries whose scales are rebuilt against the anchor
layer's act params. Layers with an entry run int8 and never read their fp
weight, which ``prune_deployed_weights`` then drops.

Not ported here: packed-W4 storage, weight-only (act-protected) entries,
channel-split convs (``conv_split``, built only when ``splits`` are
given; the SDXL-Turbo deploy of ``bench.py`` passes none), the hoisted ``time_emb_proj`` / cross-k/v banks (the per-layer path is
numerically the same) and precomputed BoS outputs.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops import qops
from .core import QuantSpec
from .state import LayerQParams, QuantCtx, quantizable_layers

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class DeployEntry:
    w_int: Optional[torch.Tensor] = None
    scale: Optional[torch.Tensor] = None
    bias0: Optional[torch.Tensor] = None
    scale_inv: Optional[float] = None
    zp_shifted: Optional[float] = None
    #: f32 [K, N] dequantized weight for the FP BoS token of cross-attn k/v
    bos_w: Optional[torch.Tensor] = None
    kind: str = "linear"  # linear | conv | fused_away
    a_bits: int = 8

    def replace(self, **kw) -> "DeployEntry":
        return dataclasses.replace(self, **kw)


def _entry(prep: Dict[str, Any], kind: str, a_bits: int) -> DeployEntry:
    prep = dict(prep)
    prep.pop("bias", None)
    return DeployEntry(kind=kind, a_bits=a_bits, **prep)


@torch.no_grad()
def build_deploy_params(
    model: torch.nn.Module,
    qparams: Dict[str, LayerQParams],
    layer_bits: Dict[str, Tuple[int, Optional[int]]],
    candidate_bits=(2, 4, 8),
    fuse_qkv: bool = False,
) -> Dict[str, DeployEntry]:
    """Deploy entries for every layer of ``layer_bits`` (name -> (w_bits,
    a_bits)) that has qparams. Weights of 2/4 bits ride int8 storage and
    math."""
    cb = list(candidate_bits)
    layers = quantizable_layers(model)
    deploy: Dict[str, DeployEntry] = {}
    for name, (w_bits, a_bits) in layer_bits.items():
        if name not in layers or name not in qparams:
            continue
        if a_bits is None:
            raise NotImplementedError(
                f"{name}: weight-only (act-protected) entries are not ported")
        qp = qparams[name]
        if qp.w_delta is None or qp.a_delta is None:
            continue
        w = layers[name].weight
        wb, ab = cb.index(w_bits), cb.index(a_bits)
        eff_bits = max(w_bits, 4)
        if w.ndim == 2:
            deploy[name] = _entry(qops.prepare_qlinear_params(
                w, qp.w_delta[wb], qp.a_delta[ab], qp.a_zp[ab],
                n_bits=eff_bits, a_bits=a_bits), "linear", a_bits)
        else:
            deploy[name] = _entry(qops.prepare_qconv_params(
                w, qp.w_delta[wb], qp.a_delta[ab], qp.a_zp[ab],
                n_bits=eff_bits, a_bits=a_bits), "conv", a_bits)
    if fuse_qkv:
        deploy = fuse_attention_projections(deploy, model, qparams,
                                            layer_bits, candidate_bits)
    return deploy


@torch.no_grad()
def fuse_attention_projections(
    deploy: Dict[str, DeployEntry],
    model: torch.nn.Module,
    qparams: Dict[str, LayerQParams],
    layer_bits: Dict[str, Tuple[int, Optional[int]]],
    candidate_bits=(2, 4, 8),
) -> Dict[str, DeployEntry]:
    """Fold ``attn1`` q/k/v into ``to_qkv`` and ``attn2`` k/v into
    ``to_kv``: one set of codes (the anchor's act params) feeds one
    ``[K, 3N]`` / ``[K, 2N]`` GEMM. Members become ``fused_away``."""
    cb = list(candidate_bits)
    layers = quantizable_layers(model)
    out = dict(deploy)

    def member_ok(n):
        e = deploy.get(n)
        return e is not None and e.kind == "linear" and e.w_int is not None

    prefixes = sorted({n[: -len(".to_q")] for n in deploy
                       if n.endswith(".to_q")})
    for prefix in prefixes:
        leaf = prefix.rsplit(".", 1)[-1]
        if leaf == "attn1":
            members = [f"{prefix}.to_q", f"{prefix}.to_k", f"{prefix}.to_v"]
            fused_name = f"{prefix}.to_qkv"
        elif leaf == "attn2":
            members = [f"{prefix}.to_k", f"{prefix}.to_v"]
            fused_name = f"{prefix}.to_kv"
        else:
            continue
        if not all(member_ok(n) for n in members):
            continue
        if len({deploy[n].a_bits for n in members}) != 1:
            continue
        ws = [layers[n].weight for n in members]
        if any(w.ndim != 2 or w.shape[0] != ws[0].shape[0] for w in ws):
            continue
        anchor = members[0]
        qa = qparams[anchor]
        fa_bits = deploy[anchor].a_bits
        ab = cb.index(layer_bits[anchor][1])
        preps = [qops.prepare_qlinear_params(
            w, qparams[n].w_delta[cb.index(layer_bits[n][0])], qa.a_delta[ab],
            qa.a_zp[ab], n_bits=max(layer_bits[n][0], 4), a_bits=fa_bits)
            for n, w in zip(members, ws)]
        out[fused_name] = DeployEntry(
            kind="linear", a_bits=fa_bits,
            w_int=torch.cat([p["w_int"] for p in preps], 1),
            scale=torch.cat([p["scale"] for p in preps]),
            bias0=torch.cat([p["bias0"] for p in preps]),
            scale_inv=preps[0]["scale_inv"],
            zp_shifted=preps[0]["zp_shifted"])
        for n in members:
            out[n] = DeployEntry(kind="fused_away")
    return out


def attach_bos_weights(deploy: Dict[str, DeployEntry]
                       ) -> Dict[str, DeployEntry]:
    """Give every cross-attention k/v entry its f32 dequantized weight
    ``w_int * s_w`` for the FP BoS token (computed once here instead of
    in every step)."""
    out = dict(deploy)
    for name, e in deploy.items():
        if ".attn2.to_k" in name or ".attn2.to_v" in name:
            if e.kind == "linear":
                out[name] = e.replace(bos_w=e.w_int.float()
                                      * (e.scale * e.scale_inv)[None, :])
    return out


def prune_deployed_weights(model: torch.nn.Module,
                           deploy: Dict[str, DeployEntry]) -> None:
    """Drop the fp weight of every deployed layer (its int8 entry replaces
    it); the model then runs only int8 with this deploy dict."""
    for name, m in quantizable_layers(model).items():
        if name in deploy:
            m.weight = None


def layer_bits_from_ctrl(ctrl, candidate_bits=(2, 4, 8)
                         ) -> Dict[str, Tuple[int, Optional[int]]]:
    cb = list(candidate_bits)
    return {n: (cb[c.w_idx], cb[c.a_idx] if c.a_on else None)
            for n, c in sorted(ctrl.items()) if c.w_on}


def deploy_unet_ctx(model: torch.nn.Module, qparams, ctrl, wq: QuantSpec,
                    bos_aware: bool = True,
                    fuse_qkv: bool = False) -> QuantCtx:
    """An int8-mode ``QuantCtx`` for ``model`` (``int8_sec`` compute)."""
    layer_bits = layer_bits_from_ctrl(ctrl, wq.candidate_bits)
    deploy = build_deploy_params(model, qparams, layer_bits,
                                 wq.candidate_bits, fuse_qkv=fuse_qkv)
    if bos_aware:
        deploy = attach_bos_weights(deploy)
    logger.info("deployed %d/%d layers to int8", len(deploy),
                len(quantizable_layers(model)))
    return QuantCtx(deploy=deploy, mode="int8", bos_aware=bos_aware,
                    fuse_qkv=fuse_qkv)
