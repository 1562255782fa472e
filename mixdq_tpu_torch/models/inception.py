"""InceptionV3 feature extractor for FID (port of
``mixdq_tpu/models/inception.py``): torchvision's ``Inception3`` up to the
2048-d pool3 features, with the pytorch-fid pooling variants (the 3x3
stride-1 average pools exclude padding from the count; Mixed_7c's pool
branch is a 3x3 stride-1 max pool).

Each ``BasicConv2d`` is conv + bias + ReLU: torchvision's BatchNorm is
folded into the conv when a state dict is read
(``utils.torch_convert.load_inception_state_dict``). Weights are HWIO as
flax stores them, so ``convert.params_to_state_dict`` carries the JAX
package's params unchanged; module names are torchvision's
(``Mixed_6b.branch7x7_1.conv``), which are flax's too.

``InceptionV3Features`` takes ``[B, H, W, 3]`` images in [0, 1] (NHWC, as
the JAX module), resizes them to 299 (bilinear with antialiasing, as
``jax.image.resize``), maps them to [-1, 1] and runs the convolutions in
NCHW; the blocks take and return NCHW. These are XLA convolutions in the
JAX package (no Pallas kernel), so ``F.conv2d`` is their counterpart.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .clip import resize_bilinear

Pair = Tuple[int, int]


def _avg_pool_nopad_count(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pool, padding 1, padding not counted."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool(x: torch.Tensor, stride: int = 2, pad: int = 0
              ) -> torch.Tensor:
    """3x3 max pool (padding, where there is any, is -inf as in
    ``reduce_window``)."""
    return F.max_pool2d(x, 3, stride, pad)


class Conv(nn.Module):
    """NCHW conv with bias on an HWIO ``[kh, kw, C, K]`` weight."""

    def __init__(self, in_channels: int, features: int, kernel_size: Pair,
                 strides: Pair, padding: Pair, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.strides, self.padding = strides, padding
        self.weight = nn.Parameter(torch.empty(
            *kernel_size, in_channels, features, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=dtype,
                                             device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.permute(3, 2, 0, 1), self.bias,
                        self.strides, self.padding)


class BasicConv2d(nn.Module):
    """conv (+ the folded BatchNorm's bias) + ReLU."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Pair = (3, 3), strides: Pair = (1, 1),
                 padding: Pair = (0, 0), dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv(in_channels, features, kernel_size, strides, padding,
                         dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv(x))


class InceptionA(nn.Module):
    def __init__(self, in_channels: int, pool_features: int, **kw):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_channels, 64, (1, 1), **kw)
        self.branch5x5_1 = BasicConv2d(in_channels, 48, (1, 1), **kw)
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=(2, 2), **kw)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, (1, 1), **kw)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1),
                                          **kw)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=(1, 1),
                                          **kw)
        self.branch_pool = BasicConv2d(in_channels, pool_features, (1, 1),
                                       **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_nopad_count(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, in_channels: int, **kw):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_channels, 384, (3, 3), (2, 2), **kw)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 64, (1, 1), **kw)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1),
                                          **kw)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), (2, 2), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_channels: int, channels_7x7: int, **kw):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(in_channels, 192, (1, 1), **kw)
        self.branch7x7_1 = BasicConv2d(in_channels, c7, (1, 1), **kw)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3), **kw)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0), **kw)
        self.branch7x7dbl_1 = BasicConv2d(in_channels, c7, (1, 1), **kw)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0),
                                          **kw)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3),
                                          **kw)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0),
                                          **kw)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3),
                                          **kw)
        self.branch_pool = BasicConv2d(in_channels, 192, (1, 1), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_nopad_count(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, in_channels: int, **kw):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_channels, 192, (1, 1), **kw)
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), (2, 2), **kw)
        self.branch7x7x3_1 = BasicConv2d(in_channels, 192, (1, 1), **kw)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3),
                                         **kw)
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0),
                                         **kw)
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), (2, 2), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    """``pool``: ``'avg'`` (Mixed_7b, padding not counted) or ``'max'``
    (Mixed_7c: 3x3 stride-1 max pool, padding 1)."""

    def __init__(self, in_channels: int, pool: str = "avg", **kw):
        super().__init__()
        if pool not in ("avg", "max"):
            raise ValueError(f"pool {pool!r}: 'avg' or 'max'")
        self.pool = pool
        self.branch1x1 = BasicConv2d(in_channels, 320, (1, 1), **kw)
        self.branch3x3_1 = BasicConv2d(in_channels, 384, (1, 1), **kw)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1),
                                        **kw)
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0),
                                        **kw)
        self.branch3x3dbl_1 = BasicConv2d(in_channels, 448, (1, 1), **kw)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=(1, 1),
                                          **kw)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1),
                                           **kw)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0),
                                           **kw)
        self.branch_pool = BasicConv2d(in_channels, 192, (1, 1), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = (_max_pool(x, stride=1, pad=1) if self.pool == "max"
              else _avg_pool_nopad_count(x))
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], 1)


class InceptionV3Features(nn.Module):
    """Images ``[B, H, W, 3]`` in [0, 1] -> 2048-d FID (pool3) features
    ``[B, 2048]``: resized to 299, scaled to [-1, 1] (pytorch-fid's
    preprocessing), then the global average pool of Mixed_7c."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), (2, 2), **kw)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3), **kw)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=(1, 1),
                                         **kw)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1), **kw)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3), **kw)
        self.Mixed_5b = InceptionA(192, 32, **kw)
        self.Mixed_5c = InceptionA(256, 64, **kw)
        self.Mixed_5d = InceptionA(288, 64, **kw)
        self.Mixed_6a = InceptionB(288, **kw)
        self.Mixed_6b = InceptionC(768, 128, **kw)
        self.Mixed_6c = InceptionC(768, 160, **kw)
        self.Mixed_6d = InceptionC(768, 160, **kw)
        self.Mixed_6e = InceptionC(768, 192, **kw)
        self.Mixed_7a = InceptionD(768, **kw)
        self.Mixed_7b = InceptionE(1280, "avg", **kw)
        self.Mixed_7c = InceptionE(2048, "max", **kw)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear(images.to(self.dtype), 299) * 2.0 - 1.0
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
        x = _max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean((2, 3))
