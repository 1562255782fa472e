"""Entry points of the W8A8 UNet step (the flow of the JAX package's
``bench.py``): build a UNet with random weights from a seed, calibrate it
on one sample, deploy it W8A8 (``int8_sec`` compute, fused QKV/KV,
BoS-aware cross-attention, ``attn_impl='auto'`` whole-attention kernels:
the ``bench.py`` headline), and run UNet steps.

Everything runs on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .models import routing
from .models.configs import get_family
from .models.unet import UNet2DConditionModel
from .quant.calibrate import calibrate
from .quant.core import QuantSpec
from .quant.deploy import deploy_unet_ctx
from .quant.state import FP_CTX, QuantCtx, quantizable_layers, uniform_ctrl

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
    and SDXL micro-conditioning, all from ``seed``."""
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


def _resnet_channels(cfg):
    """(in, out) channels of every resnet, in the UNet's build order."""
    ch, L = cfg.block_out_channels, cfg.layers_per_block
    n = len(ch)
    out = []
    prev = ch[0]
    for i in range(n):
        out += [(prev if j == 0 else ch[i], ch[i]) for j in range(L)]
        prev = ch[i]
    out += [(ch[-1], ch[-1])] * 2
    rev = list(reversed(ch))
    for i in range(n):
        prev_ch, oc, skip = rev[max(i - 1, 0)], rev[i], rev[min(i + 1, n - 1)]
        out += [((prev_ch if j == 0 else oc) + (skip if j == L else oc), oc)
                for j in range(L + 1)]
    return out


#: the kernels whose launches ``expected_kernel_calls`` counts
KERNELS = ("qconv2d", "qconv2d_s2", "gn_silu_quantize", "ln_quantize",
           "geglu_qmatmul", "qmatmul") + routing.KERNELS


def _transformer_levels(cfg):
    """(tokens, heads, head_dim, transformers, blocks each) of every level
    that holds transformers, in the UNet's build order."""
    n, L = len(cfg.block_out_channels), cfg.layers_per_block
    out = []

    def level(i, count):
        h = cfg.num_attention_heads[i]
        d = cfg.attention_head_dim or cfg.block_out_channels[i] // h
        side = cfg.sample_size // 2 ** i
        out.append((side * side, h, d, count,
                    cfg.transformer_layers_per_block[i]))

    for i, b in enumerate(cfg.down_block_types):
        if b.startswith("CrossAttn"):
            level(i, L)
    level(n - 1, 1)
    for i, b in enumerate(cfg.up_block_types):
        if b.startswith("CrossAttn"):
            level(n - 1 - i, L + 1)
    return out


def _block_calls(T, heads, d, attn_impl, mode):
    """Kernel calls of one transformer block: both attention sites as
    ``routing.attention_route`` sends them, the deferred norms where they
    materialize, the GEGLU kernel and ``qmatmul`` for every other dense
    layer of the block."""
    calls = dict.fromkeys(KERNELS, 0)
    int8 = mode == "int8"  # the FP UNet has no deploy entries
    # qmatmul launches at the fused projections, to_q and to_out, by route
    dense = {routing.QKV: 1, routing.Q_OUT: 1, routing.SEC_Q: 2}
    for cross in (False, True):
        r = routing.attention_route(
            mode=mode, attn_impl=attn_impl, fused=int8, cross=cross,
            heads=heads, head_dim=d, Tq=T, Tk=TEXT_TOKENS if cross else T,
            C_in=heads * d)
        if r.kernel != routing.EINSUM:
            calls[r.kernel] += 1
        if not int8:
            continue
        calls["qmatmul"] += dense.get(r.kernel, 3 if cross else 2)
        calls["ln_quantize"] += r.kernel != routing.Q_OUT  # norm2 folds
    if not int8:
        return calls
    calls["ln_quantize"] += 1  # norm3 -> ff.net.0.proj
    calls["geglu_qmatmul"] += 1
    calls["qmatmul"] += 1  # ff.net.2
    return calls


def expected_kernel_calls(cfg, attn_impl: str,
                          mode: str = "int8") -> Dict[str, int]:
    """Kernel calls of one UNet step of ``example_inputs`` implied by the
    UNet structure, W8A8 (``mode='int8'``: the deploy of
    ``quantize_w8a8``) or the FP UNet (``mode='fp'``: the attention
    kernels only).

    W8A8: two 3x3 convs and two GN producers per resnet, conv_in /
    conv_out, one conv per resampler, one GN per transformer
    (``proj_in``) plus ``conv_norm_out``; ``qmatmul`` for the time (and
    SDXL added-condition) embeddings, each resnet's ``time_emb_proj`` and
    ``conv_shortcut`` (where its channels change), each transformer's
    ``proj_in`` / ``proj_out``; and per transformer block what
    ``_block_calls`` counts at its level's shape."""
    calls = dict.fromkeys(KERNELS, 0)
    for T, heads, d, count, blocks in _transformer_levels(cfg):
        per = _block_calls(T, heads, d, attn_impl, mode)
        for k, v in per.items():
            calls[k] += v * count * blocks
    if mode != "int8":
        return calls
    n = len(cfg.block_out_channels)
    res = _resnet_channels(cfg)
    resnets, shortcuts = len(res), sum(a != b for a, b in res)
    transformers = sum(t[3] for t in _transformer_levels(cfg))
    embeddings = 2 + (2 if cfg.addition_embed_type == "text_time" else 0)
    calls["qconv2d"] += 2 * resnets + 2 + (n - 1)
    calls["qconv2d_s2"] += n - 1
    calls["gn_silu_quantize"] += 2 * resnets + transformers + 1
    calls["qmatmul"] += embeddings + resnets + shortcuts + 2 * transformers
    return calls


@torch.inference_mode()
def unet_step(unet: UNet2DConditionModel, inputs: Inputs,
              ctx: QuantCtx = FP_CTX) -> torch.Tensor:
    """One UNet step (noise prediction) under ``ctx``."""
    sample, t, ehs, added = inputs
    return unet(sample, t, ehs, added, ctx=ctx)
