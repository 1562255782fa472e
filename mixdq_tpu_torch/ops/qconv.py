"""W8A8 NHWC convolution with fused epilogue (port of
``mixdq_tpu/ops/pallas_qconv.py:qconv2d_pallas`` and
``qconv2d_pallas_s2``).

``out = (acc - bias0) * scale + bias + extra_bias[b] + residual`` with
zp-code padding. Kernel: ``csrc/qconv.cu`` (implicit GEMM on int8
tensor cores, any stride, on the mainloop of ``csrc/igemm_s8.cuh``);
plain version: ``qconv2d_plain``. Its tile, ring depth and split-K are
``qconv_plan``: ``qmm_plan`` over ``M = B P Q`` pixels, ``Kdim = kh kw
C`` and ``K`` channels. The two wrappers keep the reference's split into
a stride-1 and a stride-2 entry, each with its own launch count.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, check_cuda_args, qops, register, sm_count, use_kernel
from .qmatmul import QmmPlan, igemm_scratch, qmm_plan, stored_vector

COUNT_S1 = register("qconv2d")
COUNT_S2 = register("qconv2d_s2")


def qconv2d_plain(x_int8, w_int8, scale, bias0, zp_shifted: float,
                  bias=None, extra_bias=None, residual=None, stride: int = 1,
                  padding=(1, 1), out_dtype=torch.bfloat16):
    acc = qops.conv_acc(x_int8, w_int8, zp_shifted, (stride, stride),
                        padding)
    out = (acc.float() - bias0) * scale
    if bias is not None:
        out = out + bias.float()
    if extra_bias is not None:
        out = out + extra_bias.float()[:, None, None, :]
    if residual is not None:
        out = out + residual.float()
    return out.to(out_dtype)


def _lib():
    lib = _build.load("qconv.cu")
    f = lib.mixdq_qconv2d
    if f.argtypes is None:
        P, I = _build.P, _build.I
        f.argtypes = [P] * 5 + [I, P, I] + [P] * 4 + [I] * 16 + [P]
        f.restype = I
    return lib


def conv_out_size(H: int, W: int, kh: int, kw: int, stride: int,
                  padding) -> tuple:
    ph, pw = padding
    return (H + 2 * ph - kh) // stride + 1, (W + 2 * pw - kw) // stride + 1


def qconv_plan(B: int, H: int, W: int, C: int, K: int, kh: int, kw: int,
               stride: int, padding, sms: int) -> QmmPlan:
    """The kernel's plan for one conv: ``qmm_plan`` of its GEMM view."""
    P, Q = conv_out_size(H, W, kh, kw, stride, padding)
    return qmm_plan(B * P * Q, kh * kw * C, K, sms)


def _launch(x_int8, w_int8, scale, bias0, zp_shifted, bias, extra_bias,
            residual, stride, padding, out_dtype):
    B, H, W, C = x_int8.shape
    kh, kw, C2, K = w_int8.shape
    ph, pw = padding
    P, Q = conv_out_size(H, W, kh, kw, stride, padding)
    if x_int8.dtype != torch.int8 or w_int8.dtype != torch.int8 or C2 != C:
        raise ValueError(f"qconv2d: bad operands x {tuple(x_int8.shape)} "
                         f"{x_int8.dtype}, w {tuple(w_int8.shape)} "
                         f"{w_int8.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qconv2d: out_dtype {out_dtype}")
    if scale.shape != (K,) or bias0.shape != (K,) or \
            scale.dtype != torch.float32 or bias0.dtype != torch.float32:
        raise ValueError("qconv2d: scale/bias0 must be f32 [K]")
    if residual is not None and (residual.shape != (B, P, Q, K)
                                 or residual.dtype != out_dtype):
        raise ValueError(f"qconv2d: residual {tuple(residual.shape)} "
                         f"{residual.dtype}")
    bias_bf16 = stored_vector("qconv2d", "bias", bias, (K,))
    eb_bf16 = stored_vector("qconv2d", "extra_bias", extra_bias, (B, K))
    check_cuda_args("qconv2d", x=x_int8, w=w_int8, scale=scale, bias0=bias0,
                    residual=residual)
    if (C % 16 == 0 and x_int8.data_ptr() % 16) or \
            (K % 16 == 0 and w_int8.data_ptr() % 16):
        raise ValueError("qconv2d: x/w must be 16-byte aligned")
    dev = x_int8.device
    plan = qconv_plan(B, H, W, C, K, kh, kw, stride, padding,
                      sm_count(dev.index or 0))
    out = torch.empty((B, P, Q, K), dtype=out_dtype, device=dev)
    ws, counters = igemm_scratch(plan, dev)
    lib = _lib()
    p = _build.ptr
    err = lib.mixdq_qconv2d(
        p(x_int8), p(w_int8), p(scale), p(bias0), p(bias), bias_bf16,
        p(extra_bias), eb_bf16, p(residual), p(out), p(ws), p(counters), B,
        H, W, C, K, kh, kw, stride, ph, pw, int(zp_shifted),
        int(out_dtype == torch.bfloat16), plan.bm, plan.stages, plan.splits,
        plan.split_k, _build.stream(dev))
    _build.check(lib, err, "qconv2d")
    return out


def _qconv(count, stride, x_int8, w_int8, scale, bias0, zp_shifted, bias,
           extra_bias, residual, padding, out_dtype):
    count.calls += 1
    if not use_kernel(x_int8, w_int8, scale, bias0):
        return qconv2d_plain(x_int8, w_int8, scale, bias0, zp_shifted, bias,
                             extra_bias, residual, stride, padding, out_dtype)
    out = _launch(x_int8, w_int8, scale, bias0, zp_shifted, bias, extra_bias,
                  residual, stride, tuple(padding), out_dtype)
    count.launches += 1
    return out


def qconv2d(x_int8: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor,
            bias0: torch.Tensor, zp_shifted: float,
            bias: Optional[torch.Tensor] = None,
            extra_bias: Optional[torch.Tensor] = None,
            residual: Optional[torch.Tensor] = None, padding=(1, 1),
            out_dtype=torch.bfloat16) -> torch.Tensor:
    """Stride-1 W8A8 conv: codes ``[B, H, W, C]`` x HWIO ``[kh, kw, C, K]``
    -> ``[B, P, Q, K]`` in ``out_dtype``; ``extra_bias`` ``[B, K]``,
    ``residual`` ``[B, P, Q, K]`` of ``out_dtype``."""
    return _qconv(COUNT_S1, 1, x_int8, w_int8, scale, bias0, zp_shifted,
                  bias, extra_bias, residual, padding, out_dtype)


def qconv2d_s2(x_int8: torch.Tensor, w_int8: torch.Tensor,
               scale: torch.Tensor, bias0: torch.Tensor, zp_shifted: float,
               bias: Optional[torch.Tensor] = None,
               extra_bias: Optional[torch.Tensor] = None,
               residual: Optional[torch.Tensor] = None, padding=(1, 1),
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """Stride-2 W8A8 conv (the downsamplers), same contract."""
    return _qconv(COUNT_S2, 2, x_int8, w_int8, scale, bias0, zp_shifted,
                  bias, extra_bias, residual, padding, out_dtype)
