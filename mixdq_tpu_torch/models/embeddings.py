"""Timestep / added-condition embeddings (port of
``mixdq_tpu/models/embeddings.py``): sinusoidal projection with
``flip_sin_to_cos=True, downscale_freq_shift=0``, then Linear -> SiLU ->
Linear."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..quant.state import FP_CTX, QuantCtx
from .layers import QDense


def timestep_sinusoidal(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """``[B]`` timesteps -> ``[B, dim]`` f32 (diffusers
    ``get_timestep_embedding``, cos half first, max period 10000)."""
    half_dim = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / half_dim
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    out = torch.cat([torch.cos(emb), torch.sin(emb)], -1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, embed_dim: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.linear_1 = QDense(in_dim, embed_dim, dtype=dtype, device=device)
        self.linear_2 = QDense(embed_dim, embed_dim, dtype=dtype,
                               device=device)

    def forward(self, x, ctx: QuantCtx = FP_CTX):
        return self.linear_2(F.silu(self.linear_1(x, ctx)), ctx)
