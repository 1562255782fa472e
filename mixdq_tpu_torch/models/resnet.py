"""ResNet and up/down-sampling blocks, NHWC (port of
``mixdq_tpu/models/resnet.py``).

On the int8 path the ``GroupNorm -> SiLU -> act-quantize`` chain before a
conv is one ``gn_silu_quantize`` call emitting the conv's codes; the
time-embedding projection rides conv1's epilogue and the shortcut add
conv2's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gn_quant import gn_silu_quantize
from ..ops.qops import act_clip_range, quantize_per_tensor
from ..quant.state import FP_CTX, QuantCtx
from .attention import fused_entry
from .layers import GroupNorm, QConv, QDense, name_layers


def norm_act(x, norm: GroupNorm, consumer: str, ctx: QuantCtx):
    """GroupNorm + SiLU, as bf16 (fp path) or as the consumer conv's
    int8 codes (int8 path)."""
    dp = fused_entry(ctx, consumer, kind="conv")
    if dp is not None:
        return gn_silu_quantize(x, norm.weight, norm.bias, dp.scale_inv,
                                dp.zp_shifted, groups=norm.num_groups,
                                eps=norm.eps, clip=act_clip_range(dp.a_bits))
    return F.silu(norm(x))


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, groups: int = 32, eps: float = 1e-5,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = GroupNorm(groups, in_channels, eps, **kw)
        self.conv1 = QConv(in_channels, out_channels, (3, 3), padding=1, **kw)
        self.time_emb_proj = QDense(temb_channels, out_channels, **kw)
        self.norm2 = GroupNorm(groups, out_channels, eps, **kw)
        self.conv2 = QConv(out_channels, out_channels, (3, 3), padding=1,
                           **kw)
        self.conv_shortcut = (QConv(in_channels, out_channels, (1, 1), **kw)
                              if in_channels != out_channels else None)
        name_layers(self)

    def forward(self, x, temb, ctx: QuantCtx = FP_CTX, split: int = 0):
        h = norm_act(x, self.norm1, self.conv1.qname, ctx)
        t = self.time_emb_proj(F.silu(temb), ctx)
        h = self.conv1(h, ctx, extra_bias=t)
        h = norm_act(h, self.norm2, self.conv2.qname, ctx)
        residual = x
        if self.conv_shortcut is not None:
            residual = self.conv_shortcut(x, ctx, split=split)
        return self.conv2(h, ctx, residual=residual)


class Downsample2D(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = QConv(channels, channels, (3, 3), strides=(2, 2),
                          padding=1, dtype=dtype, device=device)

    def forward(self, x, ctx: QuantCtx = FP_CTX):
        return self.conv(x, ctx)


class Upsample2D(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = QConv(channels, channels, (3, 3), padding=1, dtype=dtype,
                          device=device)

    def forward(self, x, ctx: QuantCtx = FP_CTX):
        dp = fused_entry(ctx, self.conv.qname, kind="conv")
        if dp is not None:
            # quantize BEFORE the nearest 2x: duplicating pixels commutes
            # with per-tensor quantization, on 4x fewer elements
            x = quantize_per_tensor(x.to(self.dtype), dp.scale_inv,
                                    dp.zp_shifted,
                                    *act_clip_range(dp.a_bits))
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return self.conv(x, ctx)
