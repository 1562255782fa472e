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
The kernels' schedule (tile, k step, split-K) is ``wq_plan``, a function
of the shapes and the card's SM count alone.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from . import _build, check_cuda_args, register, sm_count, use_kernel

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


#: the kernels' block tile (rows, columns), the x columns of a k step and
#: the ring depths where two blocks share an SM / a block has it alone
#: (``csrc/wq_matmul.cu``: TM, TN, XCOLS, STAGES_SHARED, STAGES_ALONE)
WQ_TILE = (128, 128)
WQ_XCOLS = 64
WQ_STAGES = (3, 5)


@dataclasses.dataclass(frozen=True)
class WqPlan:
    """One launch's schedule. ``tk`` weight rows per k step (64; 32 packed
    rows for W4, each feeding both halves of x); ``stages`` of the copy
    ring; ``rows`` weight rows in all (K, or K/2 packed); split ``s``
    takes rows ``[s * split_rows, min((s + 1) * split_rows, rows))``,
    whole k steps but for the last; ``ws_elems`` f32 partial sums
    ``[splits, M, N]`` (0 for one split)."""
    tm: int
    tn: int
    tk: int
    stages: int
    rows: int
    splits: int
    split_rows: int
    ws_elems: int


@functools.lru_cache(maxsize=4096)
def wq_plan(M: int, K: int, N: int, w4: bool, sms: int) -> WqPlan:
    """Split K only where the (M, N) tiles fill fewer than ``sms`` SMs:
    then into at most ``sms // tiles`` ranges of whole k steps, none
    empty, so that every block has an SM of its own in one wave. A block
    alone on its SM takes the deeper ring; where blocks outnumber the
    SMs, two share one with the shallower ring."""
    tm, tn = WQ_TILE
    tk = WQ_XCOLS // (2 if w4 else 1)
    rows = K // 2 if w4 else K
    steps = max(1, -(-rows // tk))
    tiles = -(-M // tm) * -(-N // tn)
    splits = 1 if tiles >= sms else min(steps, max(1, sms // tiles))
    per = -(-steps // splits)
    splits = -(-steps // per)
    stages = WQ_STAGES[0] if tiles * splits > sms else WQ_STAGES[1]
    return WqPlan(tm, tn, tk, stages, rows, splits, per * tk,
                  splits * M * N if splits > 1 else 0)


def _launch(fn, name, xb, w, scale, bias, M, K, N, out_dtype, w4):
    """One launch of ``fn`` (``mixdq_wq_matmul`` / ``mixdq_wq4_matmul``;
    bias is passed for the first only) under ``wq_plan``."""
    dev = xb.device
    plan = wq_plan(M, K, N, w4, sm_count(dev.index or 0))
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    ws = (torch.empty(plan.ws_elems, dtype=torch.float32, device=dev)
          if plan.splits > 1 else None)
    p = _build.ptr
    ptrs = [p(xb), p(w), p(scale)] + ([] if w4 else [p(bias)])
    err = fn(*ptrs, p(out), p(ws), M, K, N, int(out_dtype == torch.bfloat16),
             plan.tm, plan.tn, plan.tk, plan.stages, plan.splits,
             plan.split_rows, _build.stream(dev))
    _build.check(_lib(), err, name)
    return out


def _lib():
    lib = _build.load("wq_matmul.cu")
    if lib.mixdq_wq_matmul.argtypes is None:
        P, I = _build.P, _build.I
        lib.mixdq_wq_matmul.argtypes = [P] * 6 + [I] * 10 + [P]
        lib.mixdq_wq_matmul.restype = I
        lib.mixdq_wq4_matmul.argtypes = [P] * 5 + [I] * 10 + [P]
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
    out = _launch(_lib().mixdq_wq_matmul, "wq_matmul", xb, w_int, scale,
                  bias, M, K, w_int.shape[1], out_dtype, False)
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
    out = _launch(_lib().mixdq_wq4_matmul, "wq4_matmul", xb, w_packed, scale,
                  None, M, K, w_packed.shape[1], out_dtype, True)
    WQ4_COUNT.launches += 1
    return out
