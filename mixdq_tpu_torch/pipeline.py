"""Entry points of the quantized UNet step (the flow of the JAX package's
``bench.py``): build a UNet with random weights from a seed, calibrate it
on one sample, deploy it, and run UNet steps. ``quantize_w8a8`` deploys
every layer W8A8 (``int8_sec`` compute, fused QKV/KV, BoS-aware
cross-attention, ``attn_impl='auto'`` whole-attention kernels: the
``bench.py`` headline); ``quantize_mixed`` deploys a mixed-precision
configuration (per-layer weight and act bit maps and an act-protect
list, as ``bench.py``'s ``MIXDQ_BENCH_MP_*`` runs) under ``int8_sec`` or
one of the weight-only computes; ``fake_quant_ctx`` gives the fake-quant
simulation of either from the same calibration.

Everything runs on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .models import routing
from .models.attention import geglu_fusable
from .models.configs import get_family
from .models.layers import layer_compute
from .models.unet import UNet2DConditionModel
from .quant.calibrate import calibrate
from .quant.core import QuantSpec
from .quant.deploy import (DeployEntry, bank_group_sizes, bank_members,
                           deploy_unet_ctx, unpack_packed_entries)
from .quant.state import (FP_CTX, QuantCtx, apply_bitwidth_config,
                          protect_layers, quantizable_layers, uniform_ctrl)

BitMap = Optional[Dict[str, int]]

#: weight / activation quantizers of the W8A8 deploy (bench.py:110-111)
WQ = QuantSpec(sym=True, channel_wise=True, round_mode="nearest")
AQ = QuantSpec(running_stat=True)

#: text tokens of ``example_inputs``
TEXT_TOKENS = 77

Inputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
               Optional[Dict[str, torch.Tensor]]]


def resolve_device(device=None) -> torch.device:
    """``device`` or CUDA; raises when CUDA is asked for and absent."""
    d = torch.device(device if device is not None else "cuda")
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain versions on the CPU")
    return d


def build_unet(family: str = "sdxl-turbo", seed: int = 0,
               dtype=torch.bfloat16, device=None) -> UNet2DConditionModel:
    """The family's UNet at full width with random weights from ``seed``."""
    dev = resolve_device(device)
    unet = UNet2DConditionModel(get_family(family).unet, dtype=dtype,
                                device=dev)
    return unet.init_weights(seed).eval()


def example_inputs(family: str = "sdxl-turbo", batch: int = 1, seed: int = 0,
                   dtype=torch.bfloat16, device=None) -> Inputs:
    """One request: a latent, timestep 999, a text embedding of 77 tokens,
    and SDXL micro-conditioning (None for a family without it, SD1.5),
    all from ``seed``."""
    dev = resolve_device(device)
    f = get_family(family)
    cfg = f.unet
    rng = np.random.default_rng(seed)
    H = cfg.sample_size

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev, dtype)

    sample = normal(batch, H, H, cfg.in_channels)
    ehs = normal(batch, TEXT_TOKENS, cfg.cross_attention_dim)
    added = None
    if cfg.addition_embed_type == "text_time":
        px = float(H * 8)
        time_ids = torch.tensor([[px, px, 0.0, 0.0, px, px]] * batch,
                                device=dev, dtype=dtype)
        added = {"text_embeds": normal(batch, f.pooled_dim),
                 "time_ids": time_ids}
    return sample, torch.tensor(999.0, device=dev), ehs, added


def quantize_w8a8(unet: UNet2DConditionModel, calib: Inputs) -> QuantCtx:
    """Calibrate on ``calib`` and deploy every layer W8A8 with fused
    QKV/KV, under ``attn_impl='auto'`` (``dataclasses.replace`` the
    context's ``attn_impl`` for the einsum path on the same deploy)."""
    qparams = calibrate(unet, [calib], WQ, AQ)
    ctrl = uniform_ctrl(list(quantizable_layers(unet)), w_bits=8, a_bits=8)
    ctx = deploy_unet_ctx(unet, qparams, ctrl, WQ, fuse_qkv=True)
    return dataclasses.replace(ctx, attn_impl="auto")


def mixed_ctrl(unet: UNet2DConditionModel, weight_map: BitMap = None,
               act_map: BitMap = None, protect: Sequence[str] = (),
               w_bits: int = 8, a_bits: int = 8):
    """The per-layer controls of a configuration in ``bench.py``'s order:
    every layer W``w_bits``A``a_bits``, then the weight bit map, then the
    act-protect list, then the act bit map."""
    cb = WQ.candidate_bits
    ctrl = uniform_ctrl(list(quantizable_layers(unet)), w_bits=w_bits,
                        a_bits=a_bits)
    ctrl = apply_bitwidth_config(ctrl, weight_map or {}, "weight", cb)
    ctrl = protect_layers(ctrl, protect)
    return apply_bitwidth_config(ctrl, act_map or {}, "act", cb)


def fake_quant_ctx(unet: UNet2DConditionModel, calib: Inputs,
                   w_bits: int = 8, a_bits: int = 8,
                   weight_map: BitMap = None, act_map: BitMap = None,
                   act_protect: Sequence[str] = ()) -> QuantCtx:
    """The fake-quant simulation of the configuration (``mixed_ctrl``)
    calibrated on ``calib`` as ``quantize_w8a8`` / ``quantize_mixed``
    calibrate: a ``mode='fake'`` context, BoS-aware, under
    ``attn_impl='auto'`` (flash attention where the JAX package's routing
    takes it)."""
    qparams = calibrate(unet, [calib], WQ, AQ)
    ctrl = mixed_ctrl(unet, weight_map, act_map, act_protect, w_bits,
                      a_bits)
    return QuantCtx(mode="fake", qparams=qparams, ctrl=ctrl, wq=WQ, aq=AQ,
                    bos_aware=True, attn_impl="auto")


def quantize_mixed(unet: UNet2DConditionModel, calib: Inputs,
                   weight_map: Dict[str, int], act_map: Dict[str, int],
                   protect: Sequence[str],
                   deploy_compute: str = "int8_sec",
                   w_bits: int = 8) -> QuantCtx:
    """Calibrate on ``calib`` and deploy a mixed-precision configuration
    as ``bench.py:110-194`` does: every layer W``w_bits``A8, then the
    weight bit map, then the act-protect list (acts FP: weight-only
    entries), then
    the act bit map (which turns acts on again for any layer it names).
    Dense W<=4 weights are halves-packed. ``deploy_compute='int8_sec'``:
    fused QKV/KV, BoS-aware, the packed entries unpacked once, under
    ``attn_impl='auto'``; ``'dequant'`` / ``'pallas_dequant'``
    (weight-only): unfused, kept packed, spatial convs left FP."""
    qparams = calibrate(unet, [calib], WQ, AQ)
    ctrl = mixed_ctrl(unet, weight_map, act_map, protect, w_bits)
    sec = deploy_compute == "int8_sec"
    ctx = deploy_unet_ctx(unet, qparams, ctrl, WQ, fuse_qkv=sec,
                          pack_w4=True, skip_spatial_convs=not sec,
                          deploy_compute=deploy_compute)
    if sec:
        ctx = dataclasses.replace(ctx, deploy=unpack_packed_entries(
            ctx.deploy))
    return dataclasses.replace(ctx, attn_impl="auto")


#: the kernels whose launches ``expected_kernel_calls`` counts
KERNELS = ("qconv2d", "qconv2d_s2", "gn_silu_quantize", "ln_quantize",
           "geglu_qmatmul", "qmatmul") + routing.KERNELS + (
    "wq4_matmul", "wq_matmul", "geglu_out_qmatmul", "qmatmul_fused",
    "qmatmul_fused2")


@functools.lru_cache(maxsize=None)
def _layer_shapes(cfg) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    """(name, weight shape) of every quantizable layer of the UNet of
    ``cfg``, built on the meta device (no values)."""
    m = UNet2DConditionModel(cfg, torch.bfloat16, device="meta")
    return tuple((n, tuple(l.weight.shape))
                 for n, l in sorted(quantizable_layers(m).items()))


def w8a8_layout(cfg) -> Dict[str, DeployEntry]:
    """The entries of ``quantize_w8a8``'s deploy of the UNet of ``cfg``,
    kinds and shapes only (meta tensors): every layer int8, attention
    projections fused into ``to_qkv`` / ``to_kv``."""
    out = {}
    for n, shape in _layer_shapes(cfg):
        out[n] = DeployEntry(
            kind="linear" if len(shape) == 2 else "conv", scale_inv=1.0,
            w_int=torch.empty(shape, dtype=torch.int8, device="meta"))
    for n in [n for n in out if n.endswith((".attn1.to_q", ".attn2.to_q"))]:
        prefix = n[:-len(".to_q")]
        members = (("to_q", "to_k", "to_v") if prefix.endswith("attn1")
                   else ("to_k", "to_v"))
        K = out[f"{prefix}.{members[0]}"].w_int.shape[0]
        N = sum(out[f"{prefix}.{m}"].w_int.shape[1] for m in members)
        out[f"{prefix}.to_{''.join(m[-1] for m in members)}"] = DeployEntry(
            scale_inv=1.0,
            w_int=torch.empty((K, N), dtype=torch.int8, device="meta"))
        for m in members:
            out[f"{prefix}.{m}"] = DeployEntry(kind="fused_away")
    return out


def _level(cfg, name: str) -> int:
    """The UNet level of layer or block ``name`` (a dotted name under
    ``down_blocks.i``, ``mid_block`` or ``up_blocks.i``; 0 for the rest)."""
    parts = name.split(".")
    n = len(cfg.block_out_channels)
    return {"down_blocks": lambda: int(parts[1]), "mid_block": lambda: n - 1,
            "up_blocks": lambda: n - 1 - int(parts[1])}.get(
        parts[0], lambda: 0)()


def _site_shape(cfg, block: str) -> Tuple[int, int, int]:
    """(tokens, heads, head_dim) of transformer block ``block``."""
    level = _level(cfg, block)
    heads = cfg.num_attention_heads[level]
    d = cfg.attention_head_dim or cfg.block_out_channels[level] // heads
    side = cfg.sample_size // 2 ** level
    return side * side, heads, d


def _rows(cfg, name: str) -> int:
    """GEMM rows of layer ``name`` in a step of ``example_inputs`` (B=1):
    1 for the time and added-condition embeddings and every
    ``time_emb_proj``, the text tokens for cross-attention k/v, else the
    pixels (tokens) of the layer's level."""
    if name.startswith(("time_embedding.", "add_embedding.")) or \
            name.endswith(".time_emb_proj"):
        return 1
    if ".attn2.to_k" in name or ".attn2.to_v" in name:
        return TEXT_TOKENS
    return (cfg.sample_size // 2 ** _level(cfg, name)) ** 2


def expected_kernel_calls(cfg, attn_impl: str, mode: str = "int8",
                          deploy: Optional[Dict[str, DeployEntry]] = None,
                          compute: str = "int8_sec",
                          out_fuse: frozenset = routing.DEFAULT_OUT_FUSE,
                          ln_fold: bool = True,
                          int8_flash: str = "off",
                          qkv_quant: bool = False,
                          linear_bank: bool = True, cross_kv: bool = False,
                          fuse_qkv: Optional[bool] = None,
                          small_m: int = 0) -> Dict[str, int]:
    """Kernel calls of one UNet step of ``example_inputs`` implied by the
    UNet structure and a deploy: ``deploy`` under ``compute`` (default:
    ``w8a8_layout``, the deploy of ``quantize_w8a8``) in ``mode='int8'``,
    or the FP or fake-quant UNet (``mode='fp'`` / ``'fake'``: the
    attention kernels only; none in fake mode with ``qkv_quant``), under
    ``attn_impl`` and the context's kernel options ``out_fuse`` /
    ``ln_fold`` / ``int8_flash`` (``QuantCtx``; ``ctx_kernel_calls``
    reads them from a context).

    Each entry counts as the layers run it, by its kind, weight bits
    (packed or int8 codes) and act bits (act-quantized or weight-only,
    ``layers.layer_compute``): act-quantized dense entries on
    ``qmatmul``, weight-only ones on ``wq4_matmul`` (packed), on
    ``wq_matmul`` (``'pallas_dequant'``) or on no kernel; act-quantized
    convs on ``qconv2d`` / ``qconv2d_s2`` (spatial) or ``qmatmul`` (1x1;
    a ``conv_split`` entry's two halves, two), weight-only convs on none;
    a GroupNorm producer for every
    act-quantized resnet conv, ``conv_out`` and ``proj_in`` under
    ``int8_sec``. Each transformer block's attention sites go through
    ``routing.attention_route`` and its ff site through
    ``routing.whole_ff`` with the inputs its modules give them; a deferred
    LayerNorm counts an ``ln_quantize`` unless a whole-block kernel folds
    it (``ln_fold``).

    The banks (``QuantCtx.linear_bank`` / ``cross_kv``; ``fuse_qkv``: the
    context's, by default whether the deploy holds fused entries) count
    one ``qmatmul`` a group (``deploy.bank_group_sizes``) and none for
    their members; ``small_m`` (``QuantCtx.dequant_small_m``) sends each
    act-quantized dense entry and 1x1 conv of at most that many rows
    (``_rows``) to no kernel, turns the LayerNorm producers, ``proj_in``'s
    GroupNorm producer, the GEGLU kernels, the ``sec_attention*`` kernels
    and both banks off."""
    calls = dict.fromkeys(KERNELS, 0)
    shapes = dict(_layer_shapes(cfg))
    blocks = sorted({n[:n.index(".", n.index(".transformer_blocks.") + 20)]
                     for n in shapes if ".transformer_blocks." in n})
    if mode != "int8":
        for b in blocks:
            T, heads, d = _site_shape(cfg, b)
            for cross in (False, True):
                r = routing.attention_route(
                    mode=mode, attn_impl=attn_impl, fused=False, cross=cross,
                    heads=heads, head_dim=d, Tq=T,
                    Tk=TEXT_TOKENS if cross else T, C_in=heads * d,
                    qkv_quant=qkv_quant)
                if r.kernel != routing.EINSUM:
                    calls[r.kernel] += 1
        return calls
    deploy = w8a8_layout(cfg) if deploy is None else deploy
    sec = compute == "int8_sec"
    int8 = compute in ("int8", "int8_sec")
    if fuse_qkv is None:
        fuse_qkv = any(n.endswith((".to_qkv", ".to_kv")) for n in deploy)
    banked = set()
    if int8 and not small_m:
        for on, suffix, K in (
                (linear_bank, ".time_emb_proj", cfg.time_embed_dim),
                (cross_kv and fuse_qkv, ".attn2.to_kv",
                 cfg.cross_attention_dim)):
            if on:
                calls["qmatmul"] += len(bank_group_sizes(deploy, suffix, K))
                banked |= set(bank_members(deploy, suffix, K))

    def act(e):
        return routing.act_entry(e)

    def narrow(name):
        return bool(small_m) and _rows(cfg, name) <= small_m

    def dense(e, name=None):
        if e is None or name in banked:
            return
        c = layer_compute(compute, e)
        if c == "int8" and e.w_packed is None and narrow(name):
            return  # the small-M hybrid: weight-only, no kernel
        if c == "int8":
            calls["qmatmul"] += 1
        elif e.w_packed is not None:
            calls["wq4_matmul"] += 1
        elif c == "pallas_dequant":
            calls["wq_matmul"] += 1

    for name, e in deploy.items():
        if e.kind == "conv":
            if e.act_off or compute == "dequant":
                continue
            if tuple(e.w_int.shape[:2]) == (1, 1):
                calls["qmatmul"] += not (int8 and narrow(name))
            else:
                calls["qconv2d_s2" if ".downsamplers." in name
                      else "qconv2d"] += 1
            calls["gn_silu_quantize"] += sec and name.endswith(
                (".conv1", ".conv2", "conv_out"))
        elif e.kind == "conv_split":
            # a 1x1 product a half, act-quantized unless weight-only
            calls["qmatmul"] += 0 if e.act_off or compute == "dequant" or (
                int8 and narrow(name)) else 2
        elif e.kind == "linear" and ".transformer_blocks." not in name:
            dense(e, name)
            calls["gn_silu_quantize"] += (sec and name.endswith(".proj_in")
                                          and act(e) and not small_m)
    for b in blocks:
        T, heads, d = _site_shape(cfg, b)
        for cross, site in ((False, "attn1"), (True, "attn2")):
            a = f"{b}.{site}"
            f = deploy.get(f"{a}.to_kv" if cross else f"{a}.to_qkv")
            q, o = deploy.get(f"{a}.to_q"), deploy.get(f"{a}.to_out.0")
            # the deferred norm: norm1 before a fused to_qkv, norm2 before
            # to_q (attention.py:BasicTransformerBlock._ln)
            ln = sec and act(q if cross else f) and not small_m
            fn = f"{a}.to_kv" if cross else f"{a}.to_qkv"
            r = routing.attention_route(
                mode=mode, attn_impl=attn_impl, fused=f is not None,
                cross=cross, heads=heads, head_dim=d, Tq=T,
                Tk=TEXT_TOKENS if cross else T, C_in=heads * d, codes=ln,
                out_entry=act(o), q_entry=act(q), compute=compute,
                fused_codes=f is not None and f.w_int is not None,
                q_codes=q is not None and q.w_int is not None,
                out_codes=o is not None and o.w_int is not None,
                out_fuse=out_fuse, int8_flash=int8_flash,
                small_m=bool(small_m))
            if r.kernel != routing.EINSUM:
                calls[r.kernel] += 1
            whole = r.kernel in (routing.Q_OUT, routing.QKV_OUT)
            calls["ln_quantize"] += ln and not (ln_fold and whole)
            if r.kernel == routing.Q_OUT:  # to_q and to_out inside
                dense(f, fn)
                continue
            if r.kernel == routing.QKV_OUT:  # QKV and to_out inside
                continue
            if r.kernel == routing.QKV:
                dense(o, f"{a}.to_out.0")
                continue
            if r.kernel == routing.SEC_Q:
                dense(f, fn)
            elif f is not None:
                dense(f, fn)
                dense(q if cross else None, f"{a}.to_q")
            else:
                for m in ("to_q", "to_k", "to_v"):
                    dense(deploy.get(f"{a}.{m}"), f"{a}.{m}")
            dense(o, f"{a}.to_out.0")
        p, c = deploy.get(f"{b}.ff.net.0.proj"), deploy.get(f"{b}.ff.net.2")
        ln = sec and act(p) and not small_m
        C = heads * d
        if c is not None and routing.whole_ff(
                fusable=geglu_fusable(compute, p, c, small_m),
                net2_codes=c.w_int is not None, out_fuse=out_fuse, M=T, K=C,
                H=4 * C, C_out=C, ln=ln and ln_fold):
            calls["geglu_out_qmatmul"] += 1
            calls["ln_quantize"] += ln and not ln_fold
            continue
        calls["ln_quantize"] += ln
        if geglu_fusable(compute, p, c, small_m):
            calls["geglu_qmatmul"] += 1
        else:
            dense(p, f"{b}.ff.net.0.proj")
        dense(c, f"{b}.ff.net.2")
    return calls


def ctx_kernel_calls(cfg, ctx: QuantCtx) -> Dict[str, int]:
    """``expected_kernel_calls`` of one step of the UNet of ``cfg`` under
    ``ctx`` (its deploy, compute, ``attn_impl`` and kernel options)."""
    return expected_kernel_calls(
        cfg, ctx.attn_impl, mode=ctx.mode, deploy=ctx.deploy,
        compute=ctx.deploy_compute, out_fuse=ctx.out_fuse,
        ln_fold=ctx.ln_fold, int8_flash=ctx.int8_flash,
        qkv_quant=ctx.qkv_quant, linear_bank=ctx.linear_bank,
        cross_kv=ctx.cross_kv, fuse_qkv=ctx.fuse_qkv,
        small_m=ctx.dequant_small_m)


@torch.inference_mode()
def unet_step(unet: UNet2DConditionModel, inputs: Inputs,
              ctx: QuantCtx = FP_CTX) -> torch.Tensor:
    """One UNet step (noise prediction) under ``ctx``."""
    sample, t, ehs, added = inputs
    return unet(sample, t, ehs, added, ctx=ctx)
