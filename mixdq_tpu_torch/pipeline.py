"""Entry points of the W8A8 UNet step (the flow of the JAX package's
``bench.py``): build a UNet with random weights from a seed, calibrate it
on one sample, deploy it W8A8 (``int8_sec`` compute, fused QKV/KV,
BoS-aware cross-attention, einsum attention), and run UNet steps.

Everything runs on CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .models.configs import get_family
from .models.unet import UNet2DConditionModel
from .quant.calibrate import calibrate
from .quant.core import QuantSpec
from .quant.deploy import deploy_unet_ctx
from .quant.state import FP_CTX, QuantCtx, quantizable_layers, uniform_ctrl

#: weight / activation quantizers of the W8A8 deploy (bench.py:110-111)
WQ = QuantSpec(sym=True, channel_wise=True, round_mode="nearest")
AQ = QuantSpec(running_stat=True)

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
    ehs = normal(batch, 77, cfg.cross_attention_dim)
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
    QKV/KV."""
    qparams = calibrate(unet, [calib], WQ, AQ)
    ctrl = uniform_ctrl(list(quantizable_layers(unet)), w_bits=8, a_bits=8)
    return deploy_unet_ctx(unet, qparams, ctrl, WQ, fuse_qkv=True)


def expected_kernel_calls(cfg) -> Dict[str, int]:
    """Kernel calls of one W8A8 step implied by the UNet structure: two
    3x3 convs and two GN producers per resnet, conv_in/conv_out, one conv
    per resampler, one GN per transformer (``proj_in``) plus
    ``conv_norm_out``, and three LN producers and one GEGLU per
    transformer block."""
    n, L = len(cfg.block_out_channels), cfg.layers_per_block
    tl = cfg.transformer_layers_per_block
    down_x = [i for i, b in enumerate(cfg.down_block_types)
              if b.startswith("CrossAttn")]
    up_x = [i for i, b in enumerate(cfg.up_block_types)
            if b.startswith("CrossAttn")]
    resnets = n * L + 2 + n * (L + 1)
    transformers = L * len(down_x) + 1 + (L + 1) * len(up_x)
    blocks = (sum(L * tl[i] for i in down_x) + tl[-1]
              + sum((L + 1) * tl[n - 1 - i] for i in up_x))
    return {"qconv2d": 2 * resnets + 2 + (n - 1), "qconv2d_s2": n - 1,
            "gn_silu_quantize": 2 * resnets + transformers + 1,
            "ln_quantize": 3 * blocks, "geglu_qmatmul": blocks}


@torch.inference_mode()
def unet_step(unet: UNet2DConditionModel, inputs: Inputs,
              ctx: QuantCtx = FP_CTX) -> torch.Tensor:
    """One UNet step (noise prediction) under ``ctx``."""
    sample, t, ehs, added = inputs
    return unet(sample, t, ehs, added, ctx=ctx)
