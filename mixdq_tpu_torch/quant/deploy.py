"""Int8 deployment: integer weights and fused-epilogue constants per
layer (port of ``mixdq_tpu/quant/deploy.py``).

Each deploy entry carries ``w_int`` (int8 codes; 2-bit and 4-bit weights
ride int8 storage), or ``w_packed`` (halves-packed 4-bit codes, two per
byte, with ``pack_w4``), ``scale = s_w * s_a``, ``bias0 = zp_s *
sum_K(w_int)``, and the act-quantize constants ``scale_inv``/``zp_shifted``
(Python floats, launch arguments of the kernels). An act-protected layer
(act bits None) gets a weight-only entry (``act_off``): its acts stay in
the model dtype and the weight scale is ``scale * scale_inv``, built on
its 8-bit act params (placeholders, delta 1 and zero point 128, where it
has none). Self-attention q/k/v and
cross-attention k/v fold into fused ``to_qkv``/``to_kv`` entries whose
scales are rebuilt against the anchor layer's act params. Layers with an
entry never read their fp weight, which ``prune_deployed_weights`` then
drops.

Not ported here: channel-split convs (``conv_split``, built only when
``splits`` are given; the SDXL-Turbo deploys of ``bench.py`` pass none),
AdaRound ``alphas``, device int4 storage (``use_int4_storage``, a TPU
workaround), the hoisted ``time_emb_proj`` / cross-k/v banks (the
per-layer path is numerically the same) and precomputed BoS outputs.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops import qops
from ..ops.wq_matmul import pack_w4_halves, unpack_w4_halves
from .core import QuantSpec
from .state import LayerQParams, QuantCtx, quantizable_layers

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class DeployEntry:
    w_int: Optional[torch.Tensor] = None
    #: uint8 [K/2, N] halves-packed 4-bit codes (instead of ``w_int``)
    w_packed: Optional[torch.Tensor] = None
    scale: Optional[torch.Tensor] = None
    bias0: Optional[torch.Tensor] = None
    scale_inv: Optional[float] = None
    zp_shifted: Optional[float] = None
    #: f32 [K, N] dequantized weight for the FP BoS token of cross-attn k/v
    bos_w: Optional[torch.Tensor] = None
    kind: str = "linear"  # linear | conv | fused_away
    a_bits: int = 8
    #: weight-only entry of an act-protected layer: acts stay FP
    act_off: bool = False

    def replace(self, **kw) -> "DeployEntry":
        return dataclasses.replace(self, **kw)

    def codes(self) -> torch.Tensor:
        """The int8 weight codes, unpacked if packed."""
        return (self.w_int if self.w_packed is None
                else unpack_w4_halves(self.w_packed))

    def w_delta(self) -> torch.Tensor:
        """The f32 per-column weight scale ``scale * scale_inv`` (the
        fused scale holds ``s_a``, divided back out)."""
        return self.scale * self.scale_inv


def _entry(prep: Dict[str, Any], kind: str, a_bits: int, act_off: bool,
           pack: bool) -> DeployEntry:
    prep = dict(prep)
    prep.pop("bias", None)
    if pack:
        prep["w_packed"] = pack_w4_halves(prep.pop("w_int"))
    return DeployEntry(kind=kind, a_bits=a_bits, act_off=act_off, **prep)


@torch.no_grad()
def build_deploy_params(
    model: torch.nn.Module,
    qparams: Dict[str, LayerQParams],
    layer_bits: Dict[str, Tuple[int, Optional[int]]],
    candidate_bits=(2, 4, 8),
    fuse_qkv: bool = False,
    pack_w4: bool = False,
    skip_spatial_convs: bool = False,
) -> Dict[str, DeployEntry]:
    """Deploy entries for every layer of ``layer_bits`` (name -> (w_bits,
    a_bits), a_bits None for an act-protected layer) that has qparams.
    Weights of 2/4 bits ride int8 storage and math; with ``pack_w4``,
    dense ones with an even K are halves-packed instead.
    ``skip_spatial_convs``: convs with a kernel larger than 1x1 stay FP
    (the weight-only deploys)."""
    cb = list(candidate_bits)
    layers = quantizable_layers(model)
    deploy: Dict[str, DeployEntry] = {}
    for name, (w_bits, a_bits) in layer_bits.items():
        if name not in layers or name not in qparams:
            continue
        act_off = a_bits is None
        qp = qparams[name]
        if qp.w_delta is None or (qp.a_delta is None and not act_off):
            continue
        w = layers[name].weight
        if skip_spatial_convs and w.ndim == 4 and w.shape[0] * w.shape[1] > 1:
            continue
        # weight-only entries never quantize acts: placeholder act params
        # (unused at run time) keep the scale factorization
        ab = cb.index(8 if act_off else a_bits)
        eff_a_bits = 8 if act_off else a_bits
        a_delta = (torch.ones(len(cb), device=w.device) if qp.a_delta is None
                   else qp.a_delta)
        a_zp = (torch.full((len(cb),), 128.0, device=w.device)
                if qp.a_zp is None else qp.a_zp)
        eff_bits = max(w_bits, 4)
        args = (w, qp.w_delta[cb.index(w_bits)], a_delta[ab], a_zp[ab])
        if w.ndim == 2:
            pack = pack_w4 and eff_bits == 4 and w.shape[0] % 2 == 0
            deploy[name] = _entry(qops.prepare_qlinear_params(
                *args, n_bits=eff_bits, a_bits=eff_a_bits), "linear",
                eff_a_bits, act_off, pack)
        else:
            deploy[name] = _entry(qops.prepare_qconv_params(
                *args, n_bits=eff_bits, a_bits=eff_a_bits), "conv",
                eff_a_bits, act_off, False)
    if fuse_qkv:
        deploy = fuse_attention_projections(deploy, model, qparams,
                                            layer_bits, candidate_bits,
                                            pack_w4=pack_w4)
    return deploy


@torch.no_grad()
def fuse_attention_projections(
    deploy: Dict[str, DeployEntry],
    model: torch.nn.Module,
    qparams: Dict[str, LayerQParams],
    layer_bits: Dict[str, Tuple[int, Optional[int]]],
    candidate_bits=(2, 4, 8),
    pack_w4: bool = False,
) -> Dict[str, DeployEntry]:
    """Fold ``attn1`` q/k/v into ``to_qkv`` and ``attn2`` k/v into
    ``to_kv``: one set of codes (the anchor's act params) feeds one
    ``[K, 3N]`` / ``[K, 2N]`` GEMM. Members become ``fused_away``. A
    weight-only (``act_off``) member keeps its triplet unfused; packed
    members fuse, each rebuilt at its own weight bits, and the fused entry
    is packed again (with ``pack_w4``) only when every member is W<=4."""
    cb = list(candidate_bits)
    layers = quantizable_layers(model)
    out = dict(deploy)

    def member_ok(n):
        e = deploy.get(n)
        return (e is not None and e.kind == "linear" and not e.act_off
                and (e.w_int is not None or e.w_packed is not None))

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
        w_int = torch.cat([p["w_int"] for p in preps], 1)
        packed = (pack_w4 and all(layer_bits[n][0] <= 4 for n in members)
                  and w_int.shape[0] % 2 == 0)
        out[fused_name] = DeployEntry(
            kind="linear", a_bits=fa_bits,
            w_int=None if packed else w_int,
            w_packed=pack_w4_halves(w_int) if packed else None,
            scale=torch.cat([p["scale"] for p in preps]),
            bias0=torch.cat([p["bias0"] for p in preps]),
            scale_inv=preps[0]["scale_inv"],
            zp_shifted=preps[0]["zp_shifted"])
        for n in members:
            out[n] = DeployEntry(kind="fused_away")
    return out


def unpack_packed_entries(deploy: Dict[str, DeployEntry]
                          ) -> Dict[str, DeployEntry]:
    """Every halves-packed entry with its int8 codes instead, unpacked
    once (the latency-optimal W4 deploy: 4x-packed at rest, int8 steps)."""
    return {k: (e.replace(w_int=e.codes(), w_packed=None)
                if e.w_packed is not None else e)
            for k, e in deploy.items()}


def attach_bos_weights(deploy: Dict[str, DeployEntry]
                       ) -> Dict[str, DeployEntry]:
    """Give every act-quantized cross-attention k/v entry its f32
    dequantized weight ``codes * s_w`` for the FP BoS token (computed once
    here instead of in every step); packed entries are unpacked for it.
    Weight-only entries take no BoS path and get none."""
    out = dict(deploy)
    for name, e in deploy.items():
        if ".attn2.to_k" in name or ".attn2.to_v" in name:
            if e.kind == "linear" and not e.act_off:
                out[name] = e.replace(
                    bos_w=e.codes().float() * e.w_delta()[None, :])
    return out


def prune_deployed_weights(model: torch.nn.Module,
                           deploy: Dict[str, DeployEntry]) -> None:
    """Drop the fp weight of every deployed layer (its entry replaces it,
    int8, packed or weight-only alike); the model then runs only with this
    deploy dict."""
    for name, m in quantizable_layers(model).items():
        if name in deploy:
            m.weight = None


def layer_bits_from_ctrl(ctrl, candidate_bits=(2, 4, 8)
                         ) -> Dict[str, Tuple[int, Optional[int]]]:
    """(w_bits, a_bits) of every layer whose weight is quantized; a_bits is
    None where its acts stay FP (weight-only)."""
    cb = list(candidate_bits)
    return {n: (cb[c.w_idx], cb[c.a_idx] if c.a_on else None)
            for n, c in sorted(ctrl.items()) if c.w_on}


def deploy_unet_ctx(model: torch.nn.Module, qparams, ctrl, wq: QuantSpec,
                    bos_aware: bool = True, fuse_qkv: bool = False,
                    pack_w4: bool = False, skip_spatial_convs: bool = False,
                    deploy_compute: str = "int8_sec") -> QuantCtx:
    """An int8-mode ``QuantCtx`` for ``model`` under ``deploy_compute``.
    BoS weights are attached only where a BoS path runs (``int8_sec``)."""
    layer_bits = layer_bits_from_ctrl(ctrl, wq.candidate_bits)
    deploy = build_deploy_params(model, qparams, layer_bits,
                                 wq.candidate_bits, fuse_qkv=fuse_qkv,
                                 pack_w4=pack_w4,
                                 skip_spatial_convs=skip_spatial_convs)
    if bos_aware and deploy_compute == "int8_sec":
        deploy = attach_bos_weights(deploy)
    logger.info("deployed %d/%d layers", len(deploy),
                len(quantizable_layers(model)))
    return QuantCtx(deploy=deploy, mode="int8", bos_aware=bos_aware,
                    fuse_qkv=fuse_qkv, deploy_compute=deploy_compute)
