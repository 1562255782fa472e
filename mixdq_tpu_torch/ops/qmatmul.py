"""Fused GEGLU int8 projection (port of
``mixdq_tpu/ops/pallas_qmatmul.py:geglu_qmatmul``).

The proj GEMM over the value and gate halves of ``[K, 2H]``, the dequant
epilogues (``bias0`` cast to int32 before the subtraction), the gate
``v * gelu(g)`` and the consumer's (``ff.net.2``) act-quantize, emitting
that consumer's int8 codes ``[M, H]``. Kernel: ``csrc/geglu_qmatmul.cu``;
plain version: ``geglu_qmatmul_plain``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build, check_cuda_args, qops, register, use_kernel

COUNT = register("geglu_qmatmul")

_SQRT_2_OVER_PI = float(torch.tensor(math.sqrt(2 / math.pi),
                                     dtype=torch.float32))
_SQRT_HALF = float(torch.tensor(math.sqrt(0.5), dtype=torch.float32))


def gelu(x: torch.Tensor, approximate: bool = True) -> torch.Tensor:
    """``jax.nn.gelu`` step by step (tanh form by default)."""
    if approximate:
        cdf = 0.5 * (1.0 + torch.tanh(
            _SQRT_2_OVER_PI * (x + 0.044715 * (x * x * x))))
        return x * cdf
    return 0.5 * x * torch.special.erfc(-x * _SQRT_HALF)


def geglu_qmatmul_plain(x_int8, w_int8, scale, bias0, out_scale_inv: float,
                        out_zp_shifted: float, bias=None,
                        gelu_tanh: bool = True, clip=(-128.0, 127.0)):
    H = w_int8.shape[1] // 2
    acc = qops.int_gemm(x_int8, w_int8) - bias0.to(torch.int32)
    y = acc.float() * scale
    if bias is not None:
        y = y + bias.float()
    out = y[:, :H] * gelu(y[:, H:], gelu_tanh)
    q = torch.round(out * out_scale_inv) + out_zp_shifted
    return q.clamp_(clip[0], clip[1]).to(torch.int8)


def _lib():
    lib = _build.load("geglu_qmatmul.cu")
    f = lib.mixdq_geglu_qmatmul
    if f.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        f.argtypes = [P] * 6 + [I] * 4 + [F] * 4 + [P]
        f.restype = I
    return lib


def geglu_qmatmul(x_int8: torch.Tensor, w_int8: torch.Tensor,
                  scale: torch.Tensor, bias0: torch.Tensor,
                  out_scale_inv: float, out_zp_shifted: float,
                  bias: Optional[torch.Tensor] = None,
                  gelu_tanh: bool = True,
                  clip=(-128.0, 127.0)) -> torch.Tensor:
    """Codes ``[M, K]`` x ``[K, 2H]`` -> the consumer's codes ``[M, H]``;
    ``scale``/``bias0``/``bias`` are ``[2H]`` f32."""
    COUNT.calls += 1
    if not use_kernel(x_int8, w_int8, scale, bias0):
        return geglu_qmatmul_plain(x_int8, w_int8, scale, bias0,
                                   out_scale_inv, out_zp_shifted, bias,
                                   gelu_tanh, clip)
    M, K = x_int8.shape
    K2, N2 = w_int8.shape
    if x_int8.dtype != torch.int8 or w_int8.dtype != torch.int8 or \
            K2 != K or N2 % 2:
        raise ValueError(f"geglu_qmatmul: bad operands x "
                         f"{tuple(x_int8.shape)}, w {tuple(w_int8.shape)}")
    if scale.shape != (N2,) or bias0.shape != (N2,) or \
            scale.dtype != torch.float32 or bias0.dtype != torch.float32:
        raise ValueError("geglu_qmatmul: scale/bias0 must be f32 [2H]")
    if bias is not None:
        bias = bias.float().contiguous()
    check_cuda_args("geglu_qmatmul", x=x_int8, w=w_int8, scale=scale,
                    bias0=bias0)
    H = N2 // 2
    if (K % 16 == 0 and x_int8.data_ptr() % 16) or \
            (H % 16 == 0 and w_int8.data_ptr() % 16):
        raise ValueError("geglu_qmatmul: x/w must be 16-byte aligned")
    out = torch.empty((M, H), dtype=torch.int8, device=x_int8.device)
    lib = _lib()
    p = _build.ptr
    err = lib.mixdq_geglu_qmatmul(
        p(x_int8), p(w_int8), p(scale), p(bias0), p(bias), p(out), M, K, H,
        int(gelu_tanh), out_scale_inv, out_zp_shifted, clip[0], clip[1],
        _build.stream(x_int8.device))
    _build.check(lib, err, "geglu_qmatmul")
    COUNT.launches += 1
    return out
