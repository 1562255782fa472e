"""AutoencoderKL (VAE), NHWC (port of ``mixdq_tpu/models/vae.py``): the
decoder of the text-to-image path, and the encoder. Structure as diffusers
AutoencoderKL: GroupNorm eps 1e-6, a single-head mid-block attention with
an f32 softmax, nearest 2x upsampling.

Every conv and dense of the encoder and decoder is a ``QConv`` /
``QDense``: under the FP context they are plain layers, and under an
int8 context (``quant.vae_quant.quantize_vae_decoder``) the ``decoder.*``
layers run the int8 kernels (``qconv2d`` for the 3x3 convs at every
level, ``qmatmul`` for the 1x1 shortcuts and the attention projections).
The GroupNorms stay plain, as in the JAX package. ``quant_conv`` and
``post_quant_conv`` are plain 1x1 convs (``Conv1x1``).

Module names follow the JAX package's flax names through
``canonical_name``: ``decoder.up_blocks_0_resnets_0.conv1``,
``decoder.mid_block.attentions.0.to_out.0``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..quant.state import FP_CTX, QuantCtx
from .configs import VAEConfig
from .layers import GroupNorm, QConv, QDense, lecun_normal_, name_layers
from .resnet import upsample_conv


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = GroupNorm(groups, in_channels, 1e-6, **kw)
        self.conv1 = QConv(in_channels, out_channels, (3, 3), padding=1, **kw)
        self.norm2 = GroupNorm(groups, out_channels, 1e-6, **kw)
        self.conv2 = QConv(out_channels, out_channels, (3, 3), padding=1,
                           **kw)
        self.conv_shortcut = (QConv(in_channels, out_channels, (1, 1), **kw)
                              if in_channels != out_channels else None)

    def forward(self, x, ctx: QuantCtx = FP_CTX):
        h = self.conv1(F.silu(self.norm1(x)), ctx)
        h = self.conv2(F.silu(self.norm2(h)), ctx)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x, ctx)
        return x + h


class VAEAttention(nn.Module):
    def __init__(self, channels: int, groups: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dtype = dtype
        self.group_norm = GroupNorm(groups, channels, 1e-6, **kw)
        self.to_q = QDense(channels, channels, **kw)
        self.to_k = QDense(channels, channels, **kw)
        self.to_v = QDense(channels, channels, **kw)
        self.to_out = nn.ModuleList([QDense(channels, channels, **kw)])

    def forward(self, x, ctx: QuantCtx = FP_CTX):
        B, H, W, C = x.shape
        h = self.group_norm(x).reshape(B, H * W, C)
        q, k, v = self.to_q(h, ctx), self.to_k(h, ctx), self.to_v(h, ctx)
        logits = torch.einsum("bqc,bkc->bqk", q, k) * C ** -0.5
        probs = torch.softmax(logits.float(), -1).to(self.dtype)
        o = self.to_out[0](torch.einsum("bqk,bkc->bqc", probs, v), ctx)
        return x + o.reshape(B, H, W, C)


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, groups: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.resnets = nn.ModuleList(
            [VAEResnetBlock(channels, channels, groups, **kw)
             for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels, groups, **kw)])

    def forward(self, x, ctx: QuantCtx = FP_CTX):
        x = self.resnets[0](x, ctx)
        x = self.attentions[0](x, ctx)
        return self.resnets[1](x, ctx)


class VAEDecoder(nn.Module):
    def __init__(self, cfg: VAEConfig, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        ch = list(reversed(cfg.block_out_channels))  # (512, 512, 256, 128)
        g = cfg.norm_num_groups
        self.conv_in = QConv(cfg.latent_channels, ch[0], (3, 3), padding=1,
                             **kw)
        self.mid_block = VAEMidBlock(ch[0], g, **kw)
        prev = ch[0]
        for i, c in enumerate(ch):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_blocks_{i}_resnets_{j}",
                                VAEResnetBlock(prev, c, g, **kw))
                prev = c
            if i != len(ch) - 1:
                self.add_module(f"up_blocks_{i}_upsampler",
                                QConv(c, c, (3, 3), padding=1, **kw))
        self.conv_norm_out = GroupNorm(g, ch[-1], 1e-6, **kw)
        self.conv_out = QConv(ch[-1], cfg.sample_channels, (3, 3), padding=1,
                              **kw)

    def forward(self, z, ctx: QuantCtx = FP_CTX):
        cfg = self.cfg
        n = len(cfg.block_out_channels)
        h = self.mid_block(self.conv_in(z, ctx), ctx)
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                h = getattr(self, f"up_blocks_{i}_resnets_{j}")(h, ctx)
            if i != n - 1:
                h = upsample_conv(getattr(self, f"up_blocks_{i}_upsampler"),
                                  h, ctx)
        return self.conv_out(F.silu(self.conv_norm_out(h)), ctx)


class VAEEncoder(nn.Module):
    def __init__(self, cfg: VAEConfig, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        ch = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = QConv(cfg.sample_channels, ch[0], (3, 3), padding=1,
                             **kw)
        prev = ch[0]
        for i, c in enumerate(ch):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_blocks_{i}_resnets_{j}",
                                VAEResnetBlock(prev, c, g, **kw))
                prev = c
            if i != len(ch) - 1:
                self.add_module(f"down_blocks_{i}_downsampler",
                                QConv(c, c, (3, 3), strides=(2, 2),
                                      padding=1, **kw))
        self.mid_block = VAEMidBlock(ch[-1], g, **kw)
        self.conv_norm_out = GroupNorm(g, ch[-1], 1e-6, **kw)
        self.conv_out = QConv(ch[-1], cfg.latent_channels * 2, (3, 3),
                              padding=1, **kw)

    def forward(self, x, ctx: QuantCtx = FP_CTX):
        cfg = self.cfg
        n = len(cfg.block_out_channels)
        h = self.conv_in(x, ctx)
        for i in range(n):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_blocks_{i}_resnets_{j}")(h, ctx)
            if i != n - 1:
                h = getattr(self, f"down_blocks_{i}_downsampler")(h, ctx)
        h = self.mid_block(h, ctx)
        return self.conv_out(F.silu(self.conv_norm_out(h)), ctx)


class Conv1x1(nn.Module):
    """A plain 1x1 NHWC conv with bias (flax ``nn.Conv`` of kernel 1x1):
    ``x @ weight[0, 0] + bias``, HWIO weight."""

    def __init__(self, in_features: int, features: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            1, 1, in_features, features, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=dtype,
                                             device=device))

    def forward(self, x):
        return x.to(self.dtype) @ self.weight[0, 0] + self.bias


class AutoencoderKL(nn.Module):
    """``encode(x) -> scaled latent``, ``decode(z) -> image in [-1, 1]``,
    ``forward(x) = decode(encode(x))``; NHWC."""

    def __init__(self, cfg: VAEConfig, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg, self.dtype = cfg, dtype
        self.encoder = VAEEncoder(cfg, **kw)
        self.decoder = VAEDecoder(cfg, **kw)
        self.quant_conv = Conv1x1(cfg.latent_channels * 2,
                                  cfg.latent_channels * 2, **kw)
        self.post_quant_conv = Conv1x1(cfg.latent_channels,
                                       cfg.latent_channels, **kw)
        name_layers(self)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "AutoencoderKL":
        """Random weights from ``generator``: lecun-normal kernels in name
        order, zero biases, unit norm scales."""
        for _, m in sorted(self.named_modules()):
            if isinstance(m, (QConv, QDense, Conv1x1)):
                w = m.weight
                lecun_normal_(w, w[..., 0].numel() if w.ndim == 4
                              else w.shape[0], generator)
        return self

    def encode(self, x: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               ctx: QuantCtx = FP_CTX) -> torch.Tensor:
        """The latent, pre-scaled by ``scaling_factor``: the mean, or a
        sample drawn from ``generator`` when one is given."""
        moments = self.quant_conv(self.encoder(x, ctx))
        mean, logvar = moments.chunk(2, -1)
        if generator is not None:
            std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
            mean = mean + std * torch.randn(
                mean.shape, generator=generator, device=mean.device,
                dtype=mean.dtype)
        return mean * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor, ctx: QuantCtx = FP_CTX) -> torch.Tensor:
        """Scaled latents ``[B, h, w, 4]`` -> image ``[B, 8h, 8w, 3]`` in
        about [-1, 1]."""
        z = z / self.cfg.scaling_factor
        return self.decoder(self.post_quant_conv(z), ctx)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                ctx: QuantCtx = FP_CTX) -> torch.Tensor:
        return self.decode(self.encode(x, generator, ctx), ctx)
