"""Fused LayerNorm + int8 quantize (port of
``mixdq_tpu/ops/pallas_ln_quant.py:ln_quantize``).

``codes = quantize(layer_norm(x, gamma, beta), s_a, zp)`` emits the
downstream dense layer's int8 codes from the raw block input in one pass.
Kernel: ``csrc/ln_quant.cu`` (one warp per row, the row, gamma and beta
copied into shared memory with every copy in flight at once; memory-bound,
~3 bytes per element, below one launch's cost at the UNet's shapes).
Plain version: ``ln_quantize_plain``.
"""

from __future__ import annotations

import torch

from . import _build, check_cuda_args, register, use_kernel

COUNT = register("ln_quantize")


def ln_quantize_plain(x, gamma, beta, scale_inv: float, zp_shifted: float,
                      eps: float = 1e-5, clip=(-128.0, 127.0)):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * gamma.float() + beta.float()
    q = torch.round(y * scale_inv) + zp_shifted
    return q.clamp_(clip[0], clip[1]).to(torch.int8)


def ln_or_codes_plain(x, residual, ln):
    """(codes, residual) of a whole-block kernel's input: in LN-folded
    mode (``ln`` = ``(gamma, beta, x_scale_inv, x_zp_shifted, x_clip,
    eps)``) the raw input quantized, which is then the residual; else the
    given codes and residual."""
    if ln is None:
        return x, residual
    gamma, beta, x_sinv, x_zp, x_clip, eps = ln
    return ln_quantize_plain(x, gamma, beta, x_sinv, x_zp, eps, x_clip), x


def check_block_input(name, x, residual, ln, C_in, dt, res_shape):
    """The input of a whole-block kernel in ``dt`` (its output dtype):
    LN-folded, the raw stream in ``dt`` with f32 ``[C_in]`` gamma/beta;
    pre-coded, int8 codes and a ``res_shape`` residual in ``dt`` or None.
    Returns (gamma, beta, x_sinv, x_zp, x_clip, eps), zeros without
    ``ln``."""
    if ln is not None:
        gamma, beta, x_sinv, x_zp, x_clip, eps = ln
        if x.dtype != dt:
            raise TypeError(f"{name}: the raw input must be {dt}")
        for t in (gamma, beta):
            if t.dtype != torch.float32 or t.shape != (C_in,):
                raise ValueError(f"{name}: gamma/beta must be f32 [{C_in}]")
        return gamma, beta, x_sinv, x_zp, x_clip, eps
    if x.dtype != torch.int8:
        raise TypeError(f"{name}: x must be int8 codes without ln")
    if residual is not None and (tuple(residual.shape) != tuple(res_shape)
                                 or residual.dtype != dt):
        raise ValueError(f"{name}: residual must be {tuple(res_shape)} {dt}")
    return None, None, 0.0, 0.0, (0.0, 0.0), 0.0


def _lib():
    lib = _build.load("ln_quant.cu")
    f = lib.mixdq_ln_quantize
    if f.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        f.argtypes = [P, P, P, P, I, I, I, F, F, F, F, F, P]
        f.restype = I
    return lib


def ln_quantize(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                scale_inv: float, zp_shifted: float, eps: float = 1e-5,
                clip=(-128.0, 127.0)) -> torch.Tensor:
    """``quantize(layer_norm(x))`` -> int8 codes of ``x``'s shape
    (``[..., C]``, normalized over C; ``gamma``/``beta`` f32 ``[C]``)."""
    COUNT.calls += 1
    if not use_kernel(x, gamma, beta):
        return ln_quantize_plain(x, gamma, beta, scale_inv, zp_shifted, eps,
                                 clip)
    C = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"ln_quantize: x must be bf16 or f32, got {x.dtype}")
    if gamma.dtype != torch.float32 or beta.dtype != torch.float32 or \
            gamma.shape != (C,) or beta.shape != (C,):
        raise ValueError("ln_quantize: gamma/beta must be f32 [C]")
    check_cuda_args("ln_quantize", x=x, gamma=gamma, beta=beta)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    lib = _lib()
    err = lib.mixdq_ln_quantize(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        x.numel() // C, C, int(x.dtype == torch.bfloat16), scale_inv,
        zp_shifted, clip[0], clip[1], eps, _build.stream(x.device))
    _build.check(lib, err, "ln_quantize")
    COUNT.launches += 1
    return out
