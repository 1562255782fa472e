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
scales are rebuilt against the anchor layer's act params. A channel-split
conv (``splits``, the up blocks' concat-shortcut convs calibrated with
twin qparams) gets a ``conv_split`` entry: ``part0`` over input channels
``[:split]`` from the plain fields (``w_delta``, ``a_delta``, ``a_zp``)
and ``part1`` over ``[split:]`` from the ``*0`` twins. AdaRound
``alphas`` ({layer: alpha of the weight's shape}) fold into the codes as
the hard rounding ``floor(w / delta) + (alpha >= 0)`` (a split conv's
halves slice alpha on HWIO axis 2). Layers with an
entry never read their fp weight, which ``prune_deployed_weights`` then
drops.

Cross-attention k/v entries carry the first (BoS) token's FP output:
``precompute_bos_outputs`` computes ``bos_out = emb0 @ W_fp`` on the
unquantized weight before the prune (the reference's
``bos_pre_computed.pt``; CLIP's causal attention makes the BoS row of
every prompt the same), ``apply_bos_outputs`` fills it from a dict of
rows; an entry without one keeps ``bos_w``, the dequantized weight, for
the per-step fallback (``attach_bos_weights``).

The shared-input banks: every layer of a group reads the same tensor
(``silu(emb)`` for the ``*.time_emb_proj`` layers, the text embedding
for the fused ``*.attn2.to_kv`` ones), so ``precompute_linear_bank`` and
``precompute_cross_kv`` run each (K, N, act bits) group at the top of
the UNet forward as one act-quantize and one ``qmatmul`` over a layer
axis; each member's output equals its per-layer path bit for bit.

Not ported here: device int4 storage (``use_int4_storage``, a TPU
workaround).
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
    #: f32 [1, N] precomputed FP output of the BoS token (``bos_w`` then
    #: goes: an entry needs one or the other)
    bos_out: Optional[torch.Tensor] = None
    kind: str = "linear"  # linear | conv | conv_split | fused_away
    #: ``conv_split``: input channels of ``part0``; the two halves' entries
    split: int = 0
    part0: Optional["DeployEntry"] = None
    part1: Optional["DeployEntry"] = None
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
    splits: Optional[Dict[str, int]] = None,
    alphas: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, DeployEntry]:
    """Deploy entries for every layer of ``layer_bits`` (name -> (w_bits,
    a_bits), a_bits None for an act-protected layer) that has qparams.
    Weights of 2/4 bits ride int8 storage and math; with ``pack_w4``,
    dense ones with an even K are halves-packed instead.
    ``skip_spatial_convs``: convs with a kernel larger than 1x1 stay FP
    (the weight-only deploys). ``splits`` ({name: split}): a conv named
    there whose qparams hold the ``w0_*`` twins deploys as ``conv_split``
    (``mixdq_tpu/quant/deploy.py:158-173``). ``alphas``: AdaRound
    rounding offsets folded into the codes."""
    splits = splits or {}
    alphas = alphas or {}
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
        wb = cb.index(w_bits)
        alpha = alphas.get(name)
        args = (w, qp.w_delta[wb], a_delta[ab], a_zp[ab])
        if w.ndim == 2:
            pack = pack_w4 and eff_bits == 4 and w.shape[0] % 2 == 0
            deploy[name] = _entry(qops.prepare_qlinear_params(
                *args, n_bits=eff_bits, alpha=alpha, a_bits=eff_a_bits),
                "linear", eff_a_bits, act_off, pack)
        elif name in splits and qp.w0_delta is not None:
            # the plain fields hold the first slice, the *0 twins the
            # second (act twins: placeholders where absent, as above)
            s = splits[name]
            a0_delta = (torch.ones(len(cb), device=w.device)
                        if qp.a0_delta is None else qp.a0_delta)
            a0_zp = (torch.full((len(cb),), 128.0, device=w.device)
                     if qp.a0_zp is None else qp.a0_zp)
            parts = [_entry(qops.prepare_qconv_params(
                ws, wd[wb], ad[ab], az[ab], n_bits=eff_bits,
                alpha=None if alpha is None else alpha[:, :, sl, :],
                a_bits=eff_a_bits), "conv", eff_a_bits, act_off, False)
                for ws, wd, ad, az, sl in (
                    (w[:, :, :s, :], qp.w_delta, a_delta, a_zp,
                     slice(None, s)),
                    (w[:, :, s:, :], qp.w0_delta, a0_delta, a0_zp,
                     slice(s, None)))]
            deploy[name] = DeployEntry(kind="conv_split", split=s,
                                       a_bits=eff_a_bits, act_off=act_off,
                                       part0=parts[0], part1=parts[1])
        else:
            deploy[name] = _entry(qops.prepare_qconv_params(
                *args, n_bits=eff_bits, alpha=alpha, a_bits=eff_a_bits),
                "conv", eff_a_bits, act_off, False)
    if fuse_qkv:
        deploy = fuse_attention_projections(deploy, model, qparams,
                                            layer_bits, candidate_bits,
                                            pack_w4=pack_w4, alphas=alphas)
    return deploy


@torch.no_grad()
def fuse_attention_projections(
    deploy: Dict[str, DeployEntry],
    model: torch.nn.Module,
    qparams: Dict[str, LayerQParams],
    layer_bits: Dict[str, Tuple[int, Optional[int]]],
    candidate_bits=(2, 4, 8),
    pack_w4: bool = False,
    alphas: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, DeployEntry]:
    """Fold ``attn1`` q/k/v into ``to_qkv`` and ``attn2`` k/v into
    ``to_kv``: one set of codes (the anchor's act params) feeds one
    ``[K, 3N]`` / ``[K, 2N]`` GEMM. Members become ``fused_away``. A
    weight-only (``act_off``) member keeps its triplet unfused; packed
    members fuse, each rebuilt at its own weight bits, and the fused entry
    is packed again (with ``pack_w4``) only when every member is W<=4.
    ``alphas``: each member's AdaRound offsets, as in
    ``build_deploy_params``."""
    alphas = alphas or {}
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
            qa.a_zp[ab], n_bits=max(layer_bits[n][0], 4),
            alpha=alphas.get(n), a_bits=fa_bits)
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
            if e.kind == "linear" and not e.act_off and e.bos_out is None:
                out[name] = e.replace(
                    bos_w=e.codes().float() * e.w_delta()[None, :])
    return out


def _bos_targets(deploy: Dict[str, DeployEntry]):
    """(name, entry, members) of every cross-attention k/v entry: a fused
    ``to_kv`` with its members ``to_k`` and ``to_v``, or an unfused
    ``to_k`` / ``to_v`` (itself); ``fused_away`` entries are skipped."""
    for name, e in deploy.items():
        if name.endswith(".attn2.to_kv"):
            prefix = name[:-len(".to_kv")]
            yield name, e, (f"{prefix}.to_k", f"{prefix}.to_v")
        elif ((".attn2.to_k" in name or ".attn2.to_v" in name)
              and e.kind != "fused_away"):
            yield name, e, (name,)


@torch.no_grad()
def precompute_bos_outputs(deploy: Dict[str, DeployEntry],
                           model: torch.nn.Module,
                           bos_embedding: torch.Tensor
                           ) -> Dict[str, DeployEntry]:
    """Every cross-attention k/v entry with ``bos_out = emb0 @ W_fp`` in
    f32 on the layer's UNQUANTIZED weight (a fused ``to_kv``: its
    members' weights side by side) and no ``bos_w``
    (``mixdq_tpu/quant/deploy.py:384-418``). ``bos_embedding``: ``[D]``,
    the first token of any prompt's text embedding. Run it before
    ``prune_deployed_weights``, which drops the weights it reads."""
    layers = quantizable_layers(model)
    emb = bos_embedding.float().reshape(1, -1)
    out = dict(deploy)
    for name, e, members in _bos_targets(deploy):
        ws = [layers[m].weight for m in members]
        if any(w is None for w in ws):
            raise ValueError(f"{name}: the fp weight was pruned; compute "
                             "the BoS outputs before the prune")
        w = torch.cat([w.float() for w in ws], 1)
        out[name] = e.replace(bos_out=emb.to(w.device) @ w, bos_w=None)
    return out


def apply_bos_outputs(deploy: Dict[str, DeployEntry],
                      bos: Dict[str, Any]) -> Dict[str, DeployEntry]:
    """``bos_out`` of the cross-attention k/v entries from a dict of BoS
    rows ``{layer: [1, N]}`` (``mixdq_tpu/quant/deploy.py:422-445``): a
    fused ``to_kv`` takes its members' rows side by side, and only when
    both are there; entries without a row stay as they are."""
    out = dict(deploy)
    for name, e, members in _bos_targets(deploy):
        rows = [bos.get(m) for m in members]
        if any(r is None for r in rows):
            continue
        dev = next((t.device for t in (e.scale, e.w_int, e.w_packed)
                    if t is not None), None)
        y0 = torch.cat([torch.as_tensor(r, dtype=torch.float32, device=dev)
                        for r in rows], 1)
        out[name] = e.replace(bos_out=y0, bos_w=None)
    return out


def bos_row(x: torch.Tensor, dp: DeployEntry, dtype) -> torch.Tensor:
    """The FP output of the first (BoS) token of ``x`` ``[..., T, K]``
    through entry ``dp``: its ``bos_out`` broadcast over the batch, else
    the product with its dequantized weight ``bos_w`` (MixDQ's BoS
    protection of cross-attention k/v)."""
    if dp.bos_out is not None:
        return dp.bos_out.to(dtype).expand(*x.shape[:-2], 1,
                                           dp.bos_out.shape[-1])
    return (x[..., :1, :].float() @ dp.bos_w).to(dtype)


#: the constants of a bank group: the members' names and entries, their
#: stacked codes [L, K, N], scales and bias0 [L, N], act-quantize
#: constants [L, 1] and act clip range
_BankGroup = Tuple[Tuple[str, ...], Tuple[DeployEntry, ...], torch.Tensor,
                   torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                   Tuple[float, float]]


def _codes_shape(e: DeployEntry) -> Tuple[int, int]:
    """(K, N) of an entry's int8 codes, packed or not."""
    if e.w_int is not None:
        return tuple(e.w_int.shape)
    return 2 * e.w_packed.shape[0], e.w_packed.shape[1]


def _bank_member(e: DeployEntry) -> bool:
    """An act-quantized, unsplit linear entry with codes: what a bank
    takes (``mixdq_tpu/quant/deploy.py:508-511``)."""
    return (e.kind == "linear" and not e.act_off and e.scale_inv is not None
            and not e.split and (e.w_int is not None
                                 or e.w_packed is not None))


def _bank_groups(ctx: QuantCtx, suffix: str, K: int
                 ) -> Tuple[_BankGroup, ...]:
    """The bank groups of ``ctx``'s deploy by (K, N, act bits): every
    act-quantized, unsplit linear entry named ``*suffix`` whose weight
    takes ``K`` inputs (packed codes unpacked). Built once a
    context and kind (``ctx.bank_cache``; rebuilt when an entry changes),
    so that a step copies nothing from the host and stacks no weights."""
    entries = bank_members(ctx.deploy, suffix, K)
    key = (suffix, K)
    hit = ctx.bank_cache.get(key)
    if hit is not None and len(hit[0]) == len(entries) and all(
            a is b for a, b in zip(hit[0], entries.values())):
        return hit[1]
    groups: Dict[Tuple[int, int, int], list] = {}
    for name, e in entries.items():
        w = e.codes()
        groups.setdefault((w.shape[0], w.shape[1], e.a_bits), []).append(
            (name, e, w))
    built = []
    for (_, _, a_bits), members in sorted(groups.items()):
        names, es, ws = zip(*members)
        dev = ws[0].device

        def col(vals):
            return torch.tensor(vals, dtype=torch.float32).reshape(
                -1, 1).to(dev)
        built.append((names, es, torch.stack(ws).contiguous(),
                      torch.stack([e.scale for e in es]).contiguous(),
                      torch.stack([e.bias0 for e in es]).contiguous(),
                      col([e.scale_inv for e in es]),
                      col([e.zp_shifted for e in es]),
                      qops.act_clip_range(a_bits)))
    built = tuple(built)
    ctx.bank_cache[key] = (tuple(entries.values()), built)
    return built


def _bank_products(x: torch.Tensor, groups, dtype):
    """``{name: [..., N]}``: ``x`` ``[..., K]`` act-quantized with each
    member's constants (one elementwise pass a group), then one
    ``qmatmul`` over the group's layer axis."""
    from ..ops.qmatmul import qmatmul

    out = {}
    x32 = x.float().reshape(-1, x.shape[-1])
    for names, _, w, scale, bias0, sinv, zp, (lo, hi) in groups:
        L = len(names)
        codes = (torch.round(x32[None] * sinv[:, :, None]) + zp[:, :, None]
                 ).clamp_(lo, hi).to(torch.int8)
        y = qmatmul(codes, w, scale, bias0, out_dtype=dtype)
        y = y.reshape(L, *x.shape[:-1], w.shape[-1])
        for i, n in enumerate(names):
            out[n] = y[i]
    return out


def bank_ok(ctx: QuantCtx) -> bool:
    """Whether a bank may run under ``ctx``: int8 mode with a deploy,
    ``deploy_compute`` ``int8`` or ``int8_sec``, no small-M hybrid
    (``mixdq_tpu/quant/deploy.py:494-496``, ``:582-584``)."""
    return (ctx.mode == "int8" and bool(ctx.deploy)
            and not ctx.dequant_small_m
            and ctx.deploy_compute in ("int8", "int8_sec"))


def precompute_cross_kv(ehs: torch.Tensor, ctx: QuantCtx, dtype
                        ) -> Optional[Dict[str, torch.Tensor]]:
    """``{fused to_kv name: [B, T, 2C]}``: every act-quantized fused
    ``*.attn2.to_kv`` projection of the text embedding ``ehs`` ``[B, T,
    K]`` at once, one ``qmatmul`` over a layer axis per (K, N, act bits)
    group, with each member's BoS row (``bos_out``, else the dequantized
    fallback) as the per-layer path gives it
    (``mixdq_tpu/quant/deploy.py:455-559``). None where it does not apply:
    ``ctx.cross_kv`` off, not ``bank_ok``, no fused QKV/KV, or no
    entry."""
    if not (ctx.cross_kv and bank_ok(ctx) and ctx.fuse_qkv) or \
            ehs.ndim != 3:
        return None
    groups = _bank_groups(ctx, ".attn2.to_kv", ehs.shape[-1])
    if not groups:
        return None
    bank = _bank_products(ehs.to(dtype), groups, dtype)
    if ctx.bos_aware:
        for names, es, *_ in groups:
            for n, e in zip(names, es):
                bank[n] = torch.cat([bos_row(ehs.to(dtype), e, dtype),
                                     bank[n][..., 1:, :]], -2)
    return bank


def precompute_linear_bank(x: torch.Tensor, ctx: QuantCtx, dtype,
                           suffix: str = ".time_emb_proj"
                           ) -> Optional[Dict[str, torch.Tensor]]:
    """``{name: [B, N]}`` (before the bias): every act-quantized linear
    entry named ``*suffix`` applied to the shared input ``x`` ``[B, K]``,
    one ``qmatmul`` over a layer axis per (K, N, act bits) group
    (``mixdq_tpu/quant/deploy.py:562-631``). None where it does not
    apply: ``ctx.linear_bank`` off, not ``bank_ok``, or no entry."""
    if not (ctx.linear_bank and bank_ok(ctx)) or x.ndim != 2:
        return None
    groups = _bank_groups(ctx, suffix, x.shape[-1])
    if not groups:
        return None
    return _bank_products(x.to(dtype), groups, dtype)


def bank_members(deploy: Dict[str, DeployEntry], suffix: str, K: int
                 ) -> Dict[str, DeployEntry]:
    """The entries named ``*suffix`` that a bank on an input of ``K``
    features takes (the gates of ``_bank_groups``)."""
    return {n: e for n, e in sorted(deploy.items())
            if n.endswith(suffix) and _bank_member(e)
            and _codes_shape(e)[0] == K}


def bank_group_sizes(deploy: Dict[str, DeployEntry], suffix: str, K: int
                     ) -> Tuple[Tuple[int, int, int], ...]:
    """(N, act bits, layers) of each group of ``bank_members``, shapes
    only (``pipeline.expected_kernel_calls`` counts one ``qmatmul`` a
    group)."""
    groups: Dict[Tuple[int, int], int] = {}
    for e in bank_members(deploy, suffix, K).values():
        g = (_codes_shape(e)[1], e.a_bits)
        groups[g] = groups.get(g, 0) + 1
    return tuple((n, a, c) for (n, a), c in sorted(groups.items()))


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
                    deploy_compute: str = "int8_sec",
                    splits: Optional[Dict[str, int]] = None,
                    alphas: Optional[Dict[str, torch.Tensor]] = None
                    ) -> QuantCtx:
    """An int8-mode ``QuantCtx`` for ``model`` under ``deploy_compute``.
    BoS weights are attached only where a BoS path runs (``int8_sec`` and
    ``int8``); ``splits``: ``conv_split`` entries; ``alphas``: AdaRound
    offsets folded into the codes (``build_deploy_params``)."""
    layer_bits = layer_bits_from_ctrl(ctrl, wq.candidate_bits)
    deploy = build_deploy_params(model, qparams, layer_bits,
                                 wq.candidate_bits, fuse_qkv=fuse_qkv,
                                 pack_w4=pack_w4,
                                 skip_spatial_convs=skip_spatial_convs,
                                 splits=splits, alphas=alphas)
    if bos_aware and deploy_compute in ("int8", "int8_sec"):
        deploy = attach_bos_weights(deploy)
    logger.info("deployed %d/%d layers", len(deploy),
                len(quantizable_layers(model)))
    return QuantCtx(deploy=deploy, mode="int8", bos_aware=bos_aware,
                    fuse_qkv=fuse_qkv, deploy_compute=deploy_compute)
