"""Int8 GEMMs with fused epilogues (ports of
``mixdq_tpu/ops/pallas_qmatmul.py``).

* ``qmatmul`` (port of ``qmatmul``): codes ``[M, K]`` x weights
  ``[K, N]`` with the dequant epilogue of ``qops.qlinear``, for every
  dense layer and 1x1 conv. Kernel: ``csrc/qmatmul.cu``; plain version:
  ``qmatmul_plain``.
* ``geglu_qmatmul`` (port of ``geglu_qmatmul``): the proj GEMM over the
  value and gate halves of ``[K, 2H]``, the dequant epilogues (``bias0``
  cast to int32 before the subtraction), the gate ``v * gelu(g)`` and
  the consumer's (``ff.net.2``) act-quantize, emitting that consumer's
  int8 codes ``[M, H]``. Kernel: ``csrc/geglu_qmatmul.cu``; plain
  version: ``geglu_qmatmul_plain``.
* ``geglu_out_qmatmul`` (port of ``geglu_out_qmatmul``): the whole
  feed-forward: the pre-LayerNorm + proj act-quantize (LN-folded mode)
  or given codes, ``geglu_qmatmul``'s work, then the ``ff.net.2`` GEMM
  with ``qmatmul``'s epilogue, its bias and the residual add, in the
  model dtype. Kernel: ``csrc/geglu_qmatmul.cu``; plain version:
  ``geglu_out_qmatmul_plain``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build, check_cuda_args, qops, register, use_kernel
from .ln_quant import check_block_input, ln_or_codes_plain

COUNT = register("geglu_qmatmul")
QMATMUL_COUNT = register("qmatmul")
GEGLU_OUT_COUNT = register("geglu_out_qmatmul")

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
        g = lib.mixdq_geglu_out_qmatmul
        g.argtypes = [P] * 15 + [I] * 7 + [F] * 9 + [P]
        g.restype = I
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


def qmatmul_plain(x_int8, w_int8, scale, bias0, bias=None,
                  out_dtype=torch.bfloat16):
    acc = qops.int_gemm(x_int8, w_int8)
    out = (acc.float() - bias0) * scale
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def _qmatmul_lib():
    lib = _build.load("qmatmul.cu")
    f = lib.mixdq_qmatmul
    if f.argtypes is None:
        P, I = _build.P, _build.I
        f.argtypes = [P] * 6 + [I] * 4 + [P]
        f.restype = I
    return lib


def qmatmul(x_int8: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor,
            bias0: torch.Tensor, bias: Optional[torch.Tensor] = None,
            out_dtype=torch.bfloat16) -> torch.Tensor:
    """Codes ``[M, K]`` x ``[K, N]`` -> ``(f32(acc) - bias0) * scale
    (+ bias)`` in ``out_dtype`` (bf16 or f32), ``[M, N]``; ``scale`` and
    ``bias0`` are f32 ``[N]``.

    The epilogue is ``qops.qlinear``'s: the int32 sum converts to f32
    before ``bias0`` is subtracted. The Pallas ``qmatmul`` subtracts
    ``bias0`` in int32 instead; since ``bias0`` is integer-valued (the
    zero point is rounded), the two agree while ``|acc| < 2^24`` and may
    differ by one f32 ulp above that."""
    QMATMUL_COUNT.calls += 1
    if not use_kernel(x_int8, w_int8, scale, bias0):
        return qmatmul_plain(x_int8, w_int8, scale, bias0, bias, out_dtype)
    M, K = x_int8.shape
    K2, N = w_int8.shape
    if x_int8.dtype != torch.int8 or w_int8.dtype != torch.int8 or K2 != K:
        raise ValueError(f"qmatmul: bad operands x {tuple(x_int8.shape)}, "
                         f"w {tuple(w_int8.shape)}")
    if scale.shape != (N,) or bias0.shape != (N,) or \
            scale.dtype != torch.float32 or bias0.dtype != torch.float32:
        raise ValueError("qmatmul: scale/bias0 must be f32 [N]")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qmatmul: out_dtype {out_dtype}")
    if bias is not None:
        bias = bias.float().contiguous()
    check_cuda_args("qmatmul", x=x_int8, w=w_int8, scale=scale, bias0=bias0)
    out = torch.empty((M, N), dtype=out_dtype, device=x_int8.device)
    lib = _qmatmul_lib()
    p = _build.ptr
    err = lib.mixdq_qmatmul(
        p(x_int8), p(w_int8), p(scale), p(bias0), p(bias), p(out), M, K, N,
        int(out_dtype == torch.bfloat16), _build.stream(x_int8.device))
    _build.check(lib, err, "qmatmul")
    QMATMUL_COUNT.launches += 1
    return out


def geglu_out_qmatmul_plain(x, w_int8, scale, bias0, mid_scale_inv: float,
                            mid_zp_shifted: float, w2_int8, out_scale,
                            out_bias0, bias=None, out_bias=None,
                            residual=None, gelu_tanh: bool = True,
                            clip=(-128.0, 127.0), out_dtype=torch.bfloat16,
                            ln=None):
    codes, residual = ln_or_codes_plain(x, residual, ln)
    h = geglu_qmatmul_plain(codes, w_int8, scale, bias0, mid_scale_inv,
                            mid_zp_shifted, bias, gelu_tanh, clip)
    out = qmatmul_plain(h, w2_int8, out_scale, out_bias0, out_bias,
                        torch.float32)
    if residual is not None:
        out = out + residual.float()
    return out.to(out_dtype)


def geglu_out_qmatmul(x: torch.Tensor, w_int8: torch.Tensor,
                      scale: torch.Tensor, bias0: torch.Tensor,
                      mid_scale_inv: float, mid_zp_shifted: float,
                      w2_int8: torch.Tensor, out_scale: torch.Tensor,
                      out_bias0: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      out_bias: Optional[torch.Tensor] = None,
                      residual: Optional[torch.Tensor] = None,
                      gelu_tanh: bool = True, clip=(-128.0, 127.0),
                      out_dtype=torch.bfloat16, ln=None) -> torch.Tensor:
    """Whole feed-forward -> ``[M, C]`` in ``out_dtype`` (bf16 or f32).

    ``x``: the proj codes ``[M, K]``, or, in LN-folded mode (``ln`` =
    ``(gamma, beta, x_scale_inv, x_zp_shifted, x_clip, eps)``), the raw
    block input ``[M, K]`` in ``out_dtype``, which then is also the
    residual (``residual`` must be None). ``w_int8`` ``[K, 2H]`` with
    ``[2H]`` f32 ``scale``/``bias0``/``bias`` (the proj); ``mid_*`` the
    act quantizer of ``ff.net.2``, whose ``w2_int8`` ``[H, C]`` has f32
    ``[C]`` ``out_scale``/``out_bias0`` and ``out_bias``. H may be any
    width: the kernel masks the ragged columns where the JAX wrapper pads
    with zero rows of ``w2``."""
    GEGLU_OUT_COUNT.calls += 1
    if ln is not None and residual is not None:
        raise ValueError("geglu_out_qmatmul: in LN-folded mode the input is "
                         "the residual")
    if not use_kernel(x, w_int8, w2_int8, residual):
        return geglu_out_qmatmul_plain(
            x, w_int8, scale, bias0, mid_scale_inv, mid_zp_shifted, w2_int8,
            out_scale, out_bias0, bias, out_bias, residual, gelu_tanh, clip,
            out_dtype, ln)
    M, K = x.shape
    K2, N2 = w_int8.shape
    H, C = w2_int8.shape
    if (w_int8.dtype != torch.int8 or w2_int8.dtype != torch.int8
            or K2 != K or N2 != 2 * H):
        raise ValueError(f"geglu_out_qmatmul: bad operands x {tuple(x.shape)}"
                         f", w {tuple(w_int8.shape)}, w2 "
                         f"{tuple(w2_int8.shape)}")
    for t, n in ((scale, N2), (bias0, N2), (out_scale, C), (out_bias0, C)):
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError("geglu_out_qmatmul: scales/bias0 must be f32 "
                             "[2H] / [C]")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"geglu_out_qmatmul: out_dtype {out_dtype}")
    if ln is not None and K != C:
        raise ValueError("geglu_out_qmatmul: LN-folded mode takes the raw "
                         "input [M, C]")
    gamma, beta, x_sinv, x_zp, x_clip, eps = check_block_input(
        "geglu_out_qmatmul", x, residual, ln, K, out_dtype, (M, C))
    bias = None if bias is None else bias.float().contiguous()
    out_bias = None if out_bias is None else out_bias.float().contiguous()
    check_cuda_args("geglu_out_qmatmul", x=x, gamma=gamma, beta=beta,
                    w=w_int8, scale=scale, bias0=bias0, w2=w2_int8,
                    out_scale=out_scale, out_bias0=out_bias0,
                    residual=residual)
    dev = x.device
    codes = (torch.empty((M, K), dtype=torch.int8, device=dev)
             if ln is not None else x)
    h_ws = torch.empty((M, H), dtype=torch.int8, device=dev)
    out = torch.empty((M, C), dtype=out_dtype, device=dev)
    lib = _lib()
    p = _build.ptr
    err = lib.mixdq_geglu_out_qmatmul(
        p(x if ln is not None else None), p(gamma), p(beta), p(codes),
        p(w_int8), p(scale), p(bias0), p(bias), p(h_ws), p(w2_int8),
        p(out_scale), p(out_bias0), p(out_bias), p(residual), p(out), M, K,
        H, C, int(gelu_tanh), int(out_dtype == torch.bfloat16),
        int(ln is not None), mid_scale_inv, mid_zp_shifted, clip[0], clip[1],
        x_sinv, x_zp, x_clip[0], x_clip[1], eps, _build.stream(dev))
    _build.check(lib, err, "geglu_out_qmatmul")
    GEGLU_OUT_COUNT.launches += 1
    return out
