"""Fused GroupNorm + SiLU + int8 quantize (port of
``mixdq_tpu/ops/pallas_gn_quant.py:gn_silu_quantize``).

``codes = quantize(silu(group_norm(x, gamma, beta)), s_a, zp)`` emits the
next conv's (or ``proj_in``'s, with ``silu=False``) int8 codes from the
raw input. Groups are contiguous channel ranges of width C/G. Kernel:
``csrc/gn_quant.cu`` (three launches: chunk partials, a finalize spread
over one block per group, apply); plain version:
``gn_silu_quantize_plain``, which keeps the reference's order:
per-channel sums, group sums, then ``y = x * a + b`` with ``a = gamma *
rstd`` and ``b = beta - mean * a``.
"""

from __future__ import annotations

import torch

from . import _build, check_cuda_args, register, use_kernel

COUNT = register("gn_silu_quantize")
#: row chunks of the stats pass per batch element (at most; ``csrc``:
#: PART_SLOTS); a channel's sums add in row order within a chunk, then in
#: chunk order
_STAT_CHUNKS = 64
_MAX_C = 6144  # finalize keeps 2C/G floats of sums in shared memory


def gn_silu_quantize_plain(x, gamma, beta, scale_inv: float,
                           zp_shifted: float, groups: int = 32,
                           eps: float = 1e-5, silu: bool = True,
                           clip=(-128.0, 127.0)):
    shape = x.shape
    B, C = shape[0], shape[-1]
    xf = x.float().reshape(B, -1, C)
    N, width = xf.shape[1], C // groups
    gsum = xf.sum(1).view(B, groups, width).sum(-1)
    gsq = (xf * xf).sum(1).view(B, groups, width).sum(-1)
    n = float(N * width)
    mean = gsum / n
    var = gsq / n - mean * mean
    rstd = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(width, -1)
    a = gamma.float() * rstd.repeat_interleave(width, -1)
    b = beta.float() - mean_c * a
    y = xf * a[:, None, :] + b[:, None, :]
    if silu:
        y = y * torch.sigmoid(y)
    q = torch.round(y * scale_inv) + zp_shifted
    return q.clamp_(clip[0], clip[1]).to(torch.int8).reshape(shape)


def _lib():
    lib = _build.load("gn_quant.cu")
    f = lib.mixdq_gn_quantize
    if f.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        f.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, I, F, F, F, F, F, P]
        f.restype = I
    return lib


def gn_silu_quantize(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, scale_inv: float, zp_shifted: float,
                     groups: int = 32, eps: float = 1e-5, silu: bool = True,
                     clip=(-128.0, 127.0)) -> torch.Tensor:
    """``quantize(silu(group_norm(x)))`` -> int8 codes of ``x``'s shape
    (``[B, ..., C]`` channels-last; ``gamma``/``beta`` f32 ``[C]``)."""
    COUNT.calls += 1
    if not use_kernel(x, gamma, beta):
        return gn_silu_quantize_plain(x, gamma, beta, scale_inv, zp_shifted,
                                      groups, eps, silu, clip)
    B, C = x.shape[0], x.shape[-1]
    N = x.numel() // (B * C)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"gn_silu_quantize: x must be bf16 or f32, "
                        f"got {x.dtype}")
    if C % groups or C > _MAX_C:
        raise ValueError(f"gn_silu_quantize: C={C} groups={groups}")
    if gamma.dtype != torch.float32 or beta.dtype != torch.float32 or \
            gamma.shape != (C,) or beta.shape != (C,):
        raise ValueError("gn_silu_quantize: gamma/beta must be f32 [C]")
    check_cuda_args("gn_silu_quantize", x=x, gamma=gamma, beta=beta)
    S = min(_STAT_CHUNKS, N)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    part = torch.empty((B, 2, C, _STAT_CHUNKS), dtype=torch.float32,
                       device=x.device)
    ab = torch.empty((B, 2, C), dtype=torch.float32, device=x.device)
    lib = _lib()
    err = lib.mixdq_gn_quantize(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        part.data_ptr(), ab.data_ptr(), B, N, C, groups, S,
        int(x.dtype == torch.bfloat16), int(silu), scale_inv, zp_shifted,
        clip[0], clip[1], eps, _build.stream(x.device))
    _build.check(lib, err, "gn_silu_quantize")
    COUNT.launches += 1
    return out
