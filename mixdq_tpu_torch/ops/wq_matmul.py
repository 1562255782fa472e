"""Weight-only GEMMs of the weight-only deploys (ports of
``mixdq_tpu/ops/pallas_wq_matmul.py``), and the halves-packed int4 layout.

* ``wq_matmul`` (port of ``wq_matmul``): x ``[M, K]`` times int8 weight
  codes ``[K, N]``, each code dequantized as ``bf16(code) * bf16(scale)``
  rounded to bf16, products summed in f32, ``+ bias``. Kernel:
  ``csrc/wq_matmul.cu``; plain version: ``wq_matmul_plain``.
* ``wq4_matmul`` (port of ``wq4_matmul``): the same over a halves-packed
  int4 weight ``[K/2, N]`` (``pack_w4_halves``), no bias. Kernel:
  ``csrc/wq_matmul.cu``; plain version: ``wq4_matmul_plain``.

Both cast x to bf16 first, whatever its dtype, as the TPU kernels do.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, check_cuda_args, register, use_kernel

WQ_COUNT = register("wq_matmul")
WQ4_COUNT = register("wq4_matmul")


def pack_w4_halves(w_int: torch.Tensor) -> torch.Tensor:
    """int4 codes ``[K, N]`` (values in [-8, 7], any integer dtype) ->
    uint8 ``[K/2, N]``: low nibble = row k + 8, high nibble = row
    k + K/2 + 8. K must be even."""
    K = w_int.shape[0]
    if K % 2:
        raise ValueError(f"pack_w4_halves: K={K} is odd")
    lo = (w_int[:K // 2].to(torch.int32) + 8).to(torch.uint8)
    hi = (w_int[K // 2:].to(torch.int32) + 8).to(torch.uint8)
    return lo | (hi << 4)


def unpack_w4_halves(w_packed: torch.Tensor) -> torch.Tensor:
    """The int8 codes ``[K, N]`` of a halves-packed ``[K/2, N]`` weight."""
    lo = (w_packed & 0xF).to(torch.int8) - 8
    hi = (w_packed >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], 0)


def dequant_bf16(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``bf16(code) * bf16(scale)`` rounded to bf16, ``[K, N]`` (the TPU
    kernels' in-tile dequantization)."""
    return codes.to(torch.bfloat16) * scale.to(torch.bfloat16)


def wq_matmul_plain(x, w_int, w_scale, bias=None, out_dtype=torch.bfloat16):
    out = x.to(torch.bfloat16).float() @ dequant_bf16(w_int, w_scale).float()
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


def wq4_matmul_plain(x, w_packed, w_scale, out_dtype=torch.bfloat16):
    Kh = w_packed.shape[0]
    xb = x.to(torch.bfloat16).float()
    lo = (w_packed & 0xF).to(torch.int32) - 8
    hi = (w_packed >> 4).to(torch.int32) - 8
    out = (xb[:, :Kh] @ dequant_bf16(lo, w_scale).float()
           + xb[:, Kh:] @ dequant_bf16(hi, w_scale).float())
    return out.to(out_dtype)


def _lib():
    lib = _build.load("wq_matmul.cu")
    if lib.mixdq_wq_matmul.argtypes is None:
        P, I = _build.P, _build.I
        lib.mixdq_wq_matmul.argtypes = [P] * 5 + [I] * 4 + [P]
        lib.mixdq_wq_matmul.restype = I
        lib.mixdq_wq4_matmul.argtypes = [P] * 4 + [I] * 4 + [P]
        lib.mixdq_wq4_matmul.restype = I
    return lib


def _check(name, x, w, w_scale, out_dtype, rows):
    """Shapes and dtypes of one launch; returns (x as contiguous bf16,
    f32 scale)."""
    M, K = x.shape
    if w.ndim != 2 or w.shape[0] != rows:
        raise ValueError(f"{name}: bad operands x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    N = w.shape[1]
    if w_scale.shape != (N,):
        raise ValueError(f"{name}: scale must be [N]")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: out_dtype {out_dtype}")
    xb = x.to(torch.bfloat16).contiguous()
    scale = w_scale.float().contiguous()
    check_cuda_args(name, w=w)
    return xb, scale


def wq_matmul(x: torch.Tensor, w_int: torch.Tensor, w_scale: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """x ``[M, K]`` times int8 codes ``[K, N]`` dequantized with the
    per-column ``w_scale`` ``[N]``, ``+ bias`` ``[N]`` -> ``[M, N]`` in
    ``out_dtype`` (bf16 or f32)."""
    WQ_COUNT.calls += 1
    if not use_kernel(x, w_int, w_scale, bias):
        return wq_matmul_plain(x, w_int, w_scale, bias, out_dtype)
    if w_int.dtype != torch.int8:
        raise ValueError("wq_matmul: w must be int8")
    xb, scale = _check("wq_matmul", x, w_int, w_scale, out_dtype, x.shape[1])
    if bias is not None:
        bias = bias.float().contiguous()
    M, K = x.shape
    N = w_int.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    lib = _lib()
    p = _build.ptr
    err = lib.mixdq_wq_matmul(p(xb), p(w_int), p(scale), p(bias), p(out), M,
                              K, N, int(out_dtype == torch.bfloat16),
                              _build.stream(x.device))
    _build.check(lib, err, "wq_matmul")
    WQ_COUNT.launches += 1
    return out


def wq4_matmul(x: torch.Tensor, w_packed: torch.Tensor,
               w_scale: torch.Tensor,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """x ``[M, K]`` times the halves-packed int4 codes ``[K/2, N]``
    dequantized with ``w_scale`` ``[N]`` -> ``[M, N]`` in ``out_dtype``."""
    WQ4_COUNT.calls += 1
    if not use_kernel(x, w_packed, w_scale):
        return wq4_matmul_plain(x, w_packed, w_scale, out_dtype)
    if w_packed.dtype != torch.uint8 or x.shape[1] % 2:
        raise ValueError("wq4_matmul: w must be uint8 [K/2, N], K even")
    xb, scale = _check("wq4_matmul", x, w_packed, w_scale, out_dtype,
                       x.shape[1] // 2)
    M, K = x.shape
    N = w_packed.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    lib = _lib()
    p = _build.ptr
    err = lib.mixdq_wq4_matmul(p(xb), p(w_packed), p(scale), p(out), M, K, N,
                               int(out_dtype == torch.bfloat16),
                               _build.stream(x.device))
    _build.check(lib, err, "wq4_matmul")
    WQ4_COUNT.launches += 1
    return out
