"""Quant-aware layers: ``QDense``, ``QConv`` and the norms (port of
``mixdq_tpu/models/layers.py``).

Layouts follow the JAX package: activations NHWC, conv weights HWIO
``[kh, kw, C, K]``, dense weights ``[K, N]`` (in, out). Quantization is
driven by the ``QuantCtx`` passed to ``forward``: in ``'fp'`` mode the
layers run their fp weights; in ``'int8'`` mode a layer with a deploy
entry (``ctx.deploy[name]``, name = the module's dotted name) runs that
entry instead and never reads its fp weight: act-quantized int8 math, or
weight-only math (``layer_compute``) for act-protected entries and under
the ``'dequant'`` / ``'pallas_dequant'`` computes.

An int8 tensor passed as input holds THIS layer's activation codes
already (emitted upstream by ``ln_quantize`` / ``gn_silu_quantize``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.qconv import qconv2d, qconv2d_s2
from ..ops.qmatmul import geglu_qmatmul
from ..ops.qops import act_clip_range, qlinear, quantize_per_tensor
from ..ops.wq_matmul import wq4_matmul, wq_matmul
from ..quant.state import FP_CTX, QuantCtx


def name_layers(root: nn.Module) -> None:
    """Give every module under ``root`` its dotted name (``qname``), the
    key of its deploy entry. Each model calls this at the end of its
    ``__init__``, so the outermost model's names win."""
    for n, m in root.named_modules():
        m.qname = n


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> None:
    """flax ``lecun_normal``: truncated normal (2 std) with variance
    1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def codes_of(x: torch.Tensor, dp) -> torch.Tensor:
    """``x`` as the int8 act codes of deploy entry ``dp``."""
    if x.dtype == torch.int8:
        return x
    return quantize_per_tensor(x, dp.scale_inv, dp.zp_shifted,
                               *act_clip_range(dp.a_bits))


def layer_compute(compute: str, dp) -> str:
    """How one dense entry runs under the context's ``deploy_compute``
    (``mixdq_tpu/models/layers.py:54-70``, ``:250-255``): ``'int8'``
    (act-quantized int8 GEMM), ``'dequant'`` (weight-only: act-protected
    entries under every compute, and every entry under ``'dequant'``) or
    ``'pallas_dequant'``."""
    if dp.act_off:
        return "dequant"
    return "int8" if compute == "int8_sec" else compute


def deploy_linear(x: torch.Tensor, dp, compute: str, dtype) -> torch.Tensor:
    """One dense deploy entry under ``compute`` (``layer_compute``), no
    bias, no BoS handling (``mixdq_tpu/models/layers.py:90-161``):
    ``'int8'`` quantizes ``x`` (unless it holds the codes already) and runs
    ``qmatmul``, a packed entry unpacked first; the weight-only computes
    run a packed entry on ``wq4_matmul``, an int8 one on ``wq_matmul``
    (``'pallas_dequant'``) or as ``x @ codes`` times the per-column scale
    (``'dequant'``)."""
    if x.dtype == torch.int8 or compute == "int8":
        if dp.w_packed is not None:
            dp = dp.replace(w_int=dp.codes(), w_packed=None)
        if compute != "int8":
            raise ValueError(f"{compute}: a weight-only entry takes no codes")
        return qlinear(codes_of(x.to(dtype) if x.dtype != torch.int8 else x,
                                dp), dp.w_int, dp.scale, dp.bias0,
                       out_dtype=dtype)
    x = x.to(dtype)
    x2 = x.reshape(-1, x.shape[-1])
    if dp.w_packed is not None:
        y = wq4_matmul(x2, dp.w_packed, dp.w_delta(), out_dtype=dtype)
    elif compute == "pallas_dequant":
        y = wq_matmul(x2, dp.w_int, dp.w_delta(), out_dtype=dtype)
    else:
        return (x @ dp.w_int.to(dtype)) * dp.w_delta().to(dtype)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def bos_row(x: torch.Tensor, dp, dtype) -> torch.Tensor:
    """FP output of the first (BoS) token through the dequantized weight
    ``dp.bos_w`` — MixDQ's BoS protection of cross-attention k/v."""
    return (x[..., :1, :].float() @ dp.bos_w).to(dtype)


class QDense(nn.Module):
    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(in_features, features, dtype=dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=dtype,
                                              device=device))
                     if use_bias else None)

    def fan_in(self) -> int:
        return self.weight.shape[0]

    def forward(self, x: torch.Tensor, ctx: QuantCtx = FP_CTX,
                bos_aware: bool = False, geglu_out=None) -> torch.Tensor:
        """``geglu_out``: the downstream ``ff.net.2`` deploy entry — runs
        the fused GEGLU kernel and returns that consumer's int8 codes
        ``[..., features // 2]``."""
        dp = ctx.entry(self.qname)
        if dp is None:
            y = x.to(self.dtype) @ self.weight
            return y if self.bias is None else y + self.bias
        if dp.kind == "fused_away":
            raise ValueError(f"layer {self.qname} was folded into a fused "
                             "QKV/KV entry; call it through the attention")
        pre_codes = x.dtype == torch.int8
        if not pre_codes:
            x = x.to(self.dtype)
        if geglu_out is not None:
            codes = codes_of(x, dp)
            out = geglu_qmatmul(
                codes.reshape(-1, codes.shape[-1]), dp.w_int, dp.scale,
                dp.bias0, geglu_out.scale_inv, geglu_out.zp_shifted,
                bias=self.bias, gelu_tanh=(ctx.gelu == "tanh"),
                clip=act_clip_range(geglu_out.a_bits))
            return out.reshape(*codes.shape[:-1], out.shape[-1])
        compute = layer_compute(ctx.deploy_compute, dp)
        y = deploy_linear(x, dp, compute, self.dtype)
        # the weight-only routes quantize no acts: the BoS token needs no
        # protection there
        if compute == "int8" and bos_aware and ctx.bos_aware and x.ndim >= 3:
            if pre_codes:
                raise ValueError(f"{self.qname}: BoS protection needs the "
                                 "fp input")
            y = torch.cat([bos_row(x, dp, self.dtype), y[..., 1:, :]], -2)
        return y if self.bias is None else y + self.bias


class QConv(nn.Module):
    """NHWC/HWIO conv with symmetric integer ``padding``."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1),
                 padding: Union[int, Tuple[int, int]] = 0,
                 use_bias: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = ((padding, padding) if isinstance(padding, int)
                        else tuple(padding))
        self.weight = nn.Parameter(torch.empty(
            *self.kernel_size, in_features, features, dtype=dtype,
            device=device))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=dtype,
                                              device=device))
                     if use_bias else None)

    def fan_in(self) -> int:
        kh, kw, c, _ = self.weight.shape
        return kh * kw * c

    def _conv(self, x, w):
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     stride=self.strides, padding=self.padding)
        return y.permute(0, 2, 3, 1).contiguous()

    def forward(self, x: torch.Tensor, ctx: QuantCtx = FP_CTX, split: int = 0,
                extra_bias: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``split``: channel count of the first half of a concatenated
        input (calibration records the halves' ranges apart). ``extra_bias``
        ``[B, features]`` and ``residual`` ``[B, P, Q, features]`` are
        added exactly once — in the conv kernel's epilogue on the
        ``int8_sec`` path."""
        dp = ctx.entry(self.qname)
        if dp is None:
            w, scale = self.weight, None
        elif dp.act_off or ctx.deploy_compute == "dequant":
            # weight-only: the codes as the conv weight, the per-column
            # scale on the output (mixdq_tpu/models/layers.py:458-473)
            w, scale = dp.w_int.to(self.dtype), dp.w_delta().to(self.dtype)
        else:
            return self._conv_int8(x, dp, extra_bias, residual,
                                   fuse=ctx.deploy_compute == "int8_sec")
        y = self._conv(x.to(self.dtype), w)
        if scale is not None:
            y = y * scale
        if self.bias is not None:
            y = y + self.bias
        if extra_bias is not None:
            y = y + extra_bias.to(self.dtype)[:, None, None, :]
        if residual is not None:
            y = y + residual.to(self.dtype)
        return y

    def _conv_int8(self, x, e, eb, res, fuse):
        """One int8 conv of entry ``e``. ``fuse`` (``int8_sec``): every add
        in the conv kernel's epilogue; else (``'pallas_dequant'``, whose
        convs keep the JAX package's act-quantized int8 path) the bias
        alone, then the adds in the model dtype."""
        if x.dtype != torch.int8:
            x = x.to(self.dtype)
        codes, b = codes_of(x, e), self.bias
        if self.kernel_size == (1, 1) and self.strides == (1, 1):
            B, H, W, C = codes.shape
            y = qlinear(codes.reshape(-1, C), e.w_int.reshape(C, -1),
                        e.scale, e.bias0, bias=b, out_dtype=self.dtype)
            y = y.reshape(B, H, W, -1)
        else:
            if self.strides not in ((1, 1), (2, 2)):
                raise NotImplementedError(f"{self.qname}: stride "
                                          f"{self.strides}")
            conv = qconv2d if self.strides == (1, 1) else qconv2d_s2
            if res is not None:
                res = res.to(self.dtype).contiguous()
            y = conv(codes.contiguous(), e.w_int, e.scale, e.bias0,
                     e.zp_shifted, bias=b, extra_bias=eb if fuse else None,
                     residual=res if fuse else None, padding=self.padding,
                     out_dtype=self.dtype)
            if fuse:
                return y
        if eb is not None:
            y = y + eb.to(self.dtype)[:, None, None, :]
        return y if res is None else y + res.to(self.dtype)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over NHWC (f32 params and statistics,
    ``E[x^2] - mean^2`` variance; output in ``dtype``)."""

    def __init__(self, num_groups: int, channels: int, eps: float,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[0], x.shape[-1]
        xf = x.float().reshape(B, -1, self.num_groups, C // self.num_groups)
        mean = xf.mean((1, 3), keepdim=True)
        var = ((xf * xf).mean((1, 3), keepdim=True) - mean * mean).clamp_(
            min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(
            self.num_groups, -1)
        y = (xf - mean) * mul + self.bias.view(self.num_groups, -1)
        return y.reshape(x.shape).to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis (f32 params/statistics)."""

    def __init__(self, channels: int, eps: float = 1e-5, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_(min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(self.dtype)
