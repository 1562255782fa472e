"""Int8 GEMMs with fused epilogues (ports of
``mixdq_tpu/ops/pallas_qmatmul.py``).

* ``qmatmul`` (port of ``qmatmul``): codes ``[M, K]`` x weights
  ``[K, N]`` with the dequant epilogue of ``qops.qlinear``, for every
  dense layer and 1x1 conv. Kernel: ``csrc/qmatmul.cu`` (the mainloop of
  ``csrc/igemm_s8.cuh``, shared with ``qconv2d``); plain version:
  ``qmatmul_plain``. Its tile, ring depth and split-K are ``qmm_plan``,
  a function of the shapes and the card's SM count alone. With a leading
  layer axis (``[L, M, K]`` x ``[L, K, N]``, the shared-input banks of
  ``quant/deploy.py``) one launch runs every member's per-layer GEMM
  (``layers_plan``); the plain version loops over the members.
* ``geglu_qmatmul`` (port of ``geglu_qmatmul``): the proj GEMM over the
  value and gate halves of ``[K, 2H]``, the dequant epilogues (``bias0``
  cast to int32 before the subtraction), the gate ``v * gelu(g)`` and
  the consumer's (``ff.net.2``) act-quantize, emitting that consumer's
  int8 codes ``[M, H]``. Kernel: ``csrc/geglu_qmatmul.cu`` (``qmatmul``'s
  mainloop, each tile's weight columns the values and gates of 64 output
  columns) under ``geglu_plan``; plain version: ``geglu_qmatmul_plain``.
* ``geglu_out_qmatmul`` (port of ``geglu_out_qmatmul``): the whole
  feed-forward: the pre-LayerNorm + proj act-quantize (LN-folded mode)
  or given codes, ``geglu_qmatmul``'s work, then the ``ff.net.2`` GEMM
  with ``qmatmul``'s epilogue, its bias and the residual add, in the
  model dtype. Kernel: ``csrc/geglu_qmatmul.cu`` (one cooperative launch:
  ``ln_quantize``'s LayerNorm row, ``geglu_qmatmul``'s tiles, then
  ``qmatmul``'s, all on ``qmatmul``'s mainloop) under
  ``geglu_out_plan``; plain version: ``geglu_out_qmatmul_plain``.
* ``qmatmul_fused`` and ``qmatmul_fused2`` (ports of ``qmatmul_fused``
  and ``qmatmul_fused2``): raw activations ``[M, K]``, cast to bf16 and
  act-quantized inside the kernel, times int8 ``[K, N]`` weights, with the
  epilogue ``f32(acc - int32(bias0)) * scale`` (no layer bias). Both run
  ``qmatmul``'s mainloop under ``qmm_plan``: the first quantizes in every
  output tile at every K step (its A loader reads bf16 x), the second
  each element once per call, into a codes workspace, in one cooperative
  launch (``fused2_grid``). No model path calls them; the kernel
  benchmark (``mixdq_tpu_torch/scripts/kernel_bench.py``) does. Kernels:
  ``csrc/qmatmul_fused.cu``; plain version (both): ``qmatmul_fused_plain``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build, check_cuda_args, qops, register, sm_count, use_kernel
from .ln_quant import check_block_input, ln_or_codes_plain

COUNT = register("geglu_qmatmul")
QMATMUL_COUNT = register("qmatmul")
GEGLU_OUT_COUNT = register("geglu_out_qmatmul")
FUSED_COUNT = register("qmatmul_fused")
FUSED2_COUNT = register("qmatmul_fused2")

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
        f.argtypes = [P] * 8 + [I] * 4 + [F] * 4 + [I] * 4 + [P]
        f.restype = I
        g = lib.mixdq_geglu_out_qmatmul
        g.argtypes = [P] * 17 + [I] * 7 + [F] * 9 + [I] * 7 + [P]
        g.restype = I
        lib.mixdq_geglu_out_per_sm.argtypes = []
        lib.mixdq_geglu_out_per_sm.restype = I
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
    dev = x_int8.device
    plan = geglu_plan(M, K, H, sm_count(dev.index or 0))
    out = torch.empty((M, H), dtype=torch.int8, device=dev)
    ws, counters = igemm_scratch(plan, dev)
    lib = _lib()
    p = _build.ptr
    err = lib.mixdq_geglu_qmatmul(
        p(x_int8), p(w_int8), p(scale), p(bias0), p(bias), p(out), p(ws),
        p(counters), M, K, H, int(gelu_tanh), out_scale_inv, out_zp_shifted,
        clip[0], clip[1], plan.bm, plan.stages, plan.splits, plan.split_k,
        _build.stream(dev))
    _build.check(lib, err, "geglu_qmatmul")
    COUNT.launches += 1
    return out


def qmatmul_plain(x_int8, w_int8, scale, bias0, bias=None,
                  out_dtype=torch.bfloat16):
    if x_int8.ndim == 3:  # the layer axis: one member at a time
        return torch.stack([qmatmul_plain(x, w, s, b, None, out_dtype)
                            for x, w, s, b in zip(x_int8, w_int8, scale,
                                                  bias0)])
    acc = qops.int_gemm(x_int8, w_int8)
    out = (acc.float() - bias0) * scale
    if bias is not None:
        out = out + bias.float()
    return out.to(out_dtype)


#: the int8 GEMM mainloop's block tile, k step (bytes) and ring depth
#: (``csrc/igemm_s8.cuh``: BM, BN, BK, STAGES)
QMM_TILE = (128, 128)
QMM_BK = 128
QMM_STAGES = 4
#: the fewest k steps a split takes (fewer cost more in partial sums than
#: they save)
QMM_MIN_SPLIT_STEPS = 2
#: split-K arrival counters per device (a split plan has fewer tiles than
#: SMs)
QMM_COUNTERS = 1024


@dataclasses.dataclass(frozen=True)
class QmmPlan:
    """One launch of the int8 GEMM mainloop over ``C [M, N] = A [M, kdim]
    B [kdim, N]``: ``bm x bn`` tiles, a ring of ``stages`` steps of ``bk``
    bytes of kdim; split ``s`` takes ``[s * split_k, min((s + 1) *
    split_k, kdim))``, whole steps but for the last. ``ws_elems`` int32
    partial tiles ``[tiles, splits, bm, bn]`` and ``counters`` per-tile
    arrival counters (both 0 for one split)."""
    bm: int
    bn: int
    bk: int
    stages: int
    kdim: int
    splits: int
    split_k: int
    tiles: int
    ws_elems: int
    counters: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits


@functools.lru_cache(maxsize=4096)
def qmm_plan(M: int, kdim: int, N: int, sms: int) -> QmmPlan:
    """Split K only where the (M, N) tiles fill fewer than ``sms`` SMs:
    then into at most ``sms // tiles`` ranges of whole k steps, none
    empty and none under ``QMM_MIN_SPLIT_STEPS`` steps but the last, so
    that every block has an SM of its own in one wave."""
    bm, bn = QMM_TILE
    steps = max(1, -(-kdim // QMM_BK))
    tiles = -(-M // bm) * -(-N // bn)
    splits = 1 if tiles >= sms else max(1, min(
        sms // tiles, steps // QMM_MIN_SPLIT_STEPS))
    per = -(-steps // splits)
    splits = -(-steps // per)
    split = splits > 1
    return QmmPlan(bm, bn, QMM_BK, QMM_STAGES, kdim, splits, per * QMM_BK,
                   tiles, tiles * splits * bm * bn if split else 0,
                   tiles if split else 0)


#: ``geglu_qmatmul``'s ring stages and the blocks an SM holds at once
#: (``csrc/geglu_qmatmul.cu``: GEGLU_STAGES, ``__launch_bounds__``)
GEGLU_STAGES = 2
GEGLU_BLOCKS_PER_SM = 2


@functools.lru_cache(maxsize=4096)
def geglu_plan(M: int, K: int, H: int, sms: int) -> QmmPlan:
    """``geglu_qmatmul``'s plan: ``qmm_plan`` over the ``2H`` weight
    columns and the ``GEGLU_BLOCKS_PER_SM * sms`` blocks the card holds,
    on a ring of ``GEGLU_STAGES``. A 128-column tile is the values and
    gates of 64 output columns (the kernel's B loader interleaves them),
    so the tiles, the splits (only where the tiles fill fewer than the
    resident blocks) and the workspace are the GEMM's."""
    return dataclasses.replace(
        qmm_plan(M, K, 2 * H, GEGLU_BLOCKS_PER_SM * sms),
        stages=GEGLU_STAGES)


@dataclasses.dataclass(frozen=True)
class GegluOutPlan:
    """One cooperative launch of ``geglu_out_qmatmul``: ``geglu`` the proj
    GEMM's plan over the ``2H`` weight columns (``[K, 2H]``), ``net2``
    ff.net.2's (``[H, C]``), both on ``qmatmul``'s ring;
    ``grid`` blocks (every one resident: the launch syncs its grid), and
    the int32 split workspace and counters that the two GEMM stages share,
    one stage at a time."""
    geglu: QmmPlan
    net2: QmmPlan
    grid: int
    ws_elems: int
    counters: int

    @property
    def splits(self) -> int:
        """The most splits of a GEMM stage (``igemm_scratch``)."""
        return max(self.geglu.splits, self.net2.splits)


@functools.lru_cache(maxsize=4096)
def geglu_out_plan(M: int, K: int, H: int, C: int, sms: int,
                   per_sm: int) -> GegluOutPlan:
    """The plan of one ``geglu_out_qmatmul`` launch on ``sms`` SMs holding
    ``per_sm`` blocks each: the GEGLU stage under ``geglu_plan``'s rule
    (``qmm_plan`` over 2H columns and the ``per_sm * sms`` resident
    blocks), ff.net.2 under ``qmm_plan(M, H, C, sms)``, both on
    ``qmatmul``'s ring, and a grid of one block per item of the larger stage
    ((tile, split) items) where the card holds that many at once, else as
    many as it holds. Blocks walk each stage's items in a grid stride."""
    if per_sm < 1 or sms < 1:
        raise ValueError(f"geglu_out_qmatmul: {per_sm} blocks per SM on "
                         f"{sms} SMs")
    geglu = qmm_plan(M, K, 2 * H, per_sm * sms)
    net2 = qmm_plan(M, H, C, sms)
    grid = min(per_sm * sms, max(geglu.blocks, net2.blocks))
    return GegluOutPlan(geglu, net2, grid, max(geglu.ws_elems, net2.ws_elems),
                        max(geglu.counters, net2.counters))


@functools.lru_cache(maxsize=None)
def _geglu_out_per_sm(index: int) -> int:
    """Blocks of ``geglu_out_qmatmul``'s kernels one SM of device
    ``index`` holds (at 256 threads and the ring's shared memory)."""
    with torch.cuda.device(index):
        return _lib().mixdq_geglu_out_per_sm()


def device_geglu_out_plan(dev: torch.device, M: int, K: int, H: int,
                          C: int) -> GegluOutPlan:
    """``geglu_out_plan`` on CUDA device ``dev``."""
    index = dev.index or 0
    return geglu_out_plan(M, K, H, C, sm_count(index),
                          _geglu_out_per_sm(index))


_COUNTERS: Dict[Tuple[str, int], torch.Tensor] = {}


def igemm_scratch(plan: QmmPlan, dev: torch.device):
    """(int32 workspace, arrival counters) of one launch under ``plan``,
    (None, None) for one split. The workspace is new (``torch.empty``);
    the counters are one zeroed buffer per device, allocated at the first
    split launch and kept: each tile's last block resets its counter."""
    if plan.splits == 1:
        return None, None
    key = (dev.type, dev.index or 0)
    counters = _COUNTERS.get(key)
    if counters is None:
        counters = _COUNTERS[key] = torch.zeros(QMM_COUNTERS,
                                                dtype=torch.int32, device=dev)
    if plan.counters > counters.numel():
        raise ValueError(f"split plan of {plan.counters} tiles exceeds the "
                         f"{counters.numel()} counters")
    return torch.empty(plan.ws_elems, dtype=torch.int32, device=dev), counters


def stored_vector(name: str, what: str, t: Optional[torch.Tensor],
                  shape) -> int:
    """Checks a vector the kernels read in its stored type (f32 or bf16,
    contiguous, of ``shape``); returns 1 for bf16, else 0."""
    if t is None:
        return 0
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: {what} must be f32 or bf16, not {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: {what} {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    check_cuda_args(name, **{what: t})
    return int(t.dtype == torch.bfloat16)


def _qmatmul_lib():
    lib = _build.load("qmatmul.cu")
    f = lib.mixdq_qmatmul
    if f.argtypes is None:
        P, I = _build.P, _build.I
        f.argtypes = [P] * 5 + [I] + [P] * 3 + [I] * 9 + [P]
        f.restype = I
    return lib


@functools.lru_cache(maxsize=4096)
def layers_plan(L: int, M: int, K: int, N: int, sms: int) -> QmmPlan:
    """The plan of a ``qmatmul`` over ``L`` layers: each member's
    ``qmm_plan`` on ``sms // L`` SMs (the members share the card), its
    workspace and counters ``L`` times over (member ``l``'s after the
    earlier members')."""
    p = qmm_plan(M, K, N, max(1, sms // L))
    return dataclasses.replace(p, tiles=L * p.tiles, ws_elems=L * p.ws_elems,
                               counters=L * p.counters)


def qmatmul(x_int8: torch.Tensor, w_int8: torch.Tensor, scale: torch.Tensor,
            bias0: torch.Tensor, bias: Optional[torch.Tensor] = None,
            out_dtype=torch.bfloat16) -> torch.Tensor:
    """Codes ``[M, K]`` x ``[K, N]`` -> ``(f32(acc) - bias0) * scale
    (+ bias)`` in ``out_dtype`` (bf16 or f32), ``[M, N]``; ``scale`` and
    ``bias0`` are f32 ``[N]``, ``bias`` f32 or bf16 ``[N]`` (read as
    stored).

    With a leading layer axis (the shared-input banks of
    ``quant/deploy.py``): codes ``[L, M, K]`` x ``[L, K, N]`` with
    ``scale`` / ``bias0`` ``[L, N]`` and no ``bias`` -> ``[L, M, N]``, one
    launch whose grid holds every member (``layers_plan``); member ``l``
    equals ``qmatmul`` of its own operands bit for bit.

    The epilogue is ``qops.qlinear``'s: the int32 sum converts to f32
    before ``bias0`` is subtracted. The Pallas ``qmatmul`` subtracts
    ``bias0`` in int32 instead; since ``bias0`` is integer-valued (the
    zero point is rounded), the two agree while ``|acc| < 2^24`` and may
    differ by one f32 ulp above that."""
    QMATMUL_COUNT.calls += 1
    if not use_kernel(x_int8, w_int8, scale, bias0):
        return qmatmul_plain(x_int8, w_int8, scale, bias0, bias, out_dtype)
    layered = x_int8.ndim == 3
    L = x_int8.shape[0] if layered else 1
    M, K = x_int8.shape[-2:]
    K2, N = w_int8.shape[-2:]
    lead = (L,) if layered else ()
    if x_int8.dtype != torch.int8 or w_int8.dtype != torch.int8 or \
            K2 != K or x_int8.ndim not in (2, 3) or \
            tuple(w_int8.shape[:-2]) != lead:
        raise ValueError(f"qmatmul: bad operands x {tuple(x_int8.shape)}, "
                         f"w {tuple(w_int8.shape)}")
    if scale.shape != lead + (N,) or bias0.shape != lead + (N,) or \
            scale.dtype != torch.float32 or bias0.dtype != torch.float32:
        raise ValueError(f"qmatmul: scale/bias0 must be f32 "
                         f"{list(lead + (N,))}")
    if layered and bias is not None:
        raise ValueError("qmatmul: a layer axis takes no bias")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"qmatmul: out_dtype {out_dtype}")
    bias_bf16 = stored_vector("qmatmul", "bias", bias, (N,))
    check_cuda_args("qmatmul", x=x_int8, w=w_int8, scale=scale, bias0=bias0)
    dev = x_int8.device
    sms = sm_count(dev.index or 0)
    plan = layers_plan(L, M, K, N, sms) if layered else qmm_plan(M, K, N,
                                                                  sms)
    out = torch.empty(lead + (M, N), dtype=out_dtype, device=dev)
    ws, counters = igemm_scratch(plan, dev)
    lib = _qmatmul_lib()
    p = _build.ptr
    err = lib.mixdq_qmatmul(
        p(x_int8), p(w_int8), p(scale), p(bias0), p(bias), bias_bf16, p(out),
        p(ws), p(counters), L, M, K, N, int(out_dtype == torch.bfloat16),
        plan.bm, plan.stages, plan.splits, plan.split_k, _build.stream(dev))
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
    plan = device_geglu_out_plan(dev, M, K, H, C)
    codes = (torch.empty((M, K), dtype=torch.int8, device=dev)
             if ln is not None else x)
    h_ws = torch.empty((M, H), dtype=torch.int8, device=dev)
    out = torch.empty((M, C), dtype=out_dtype, device=dev)
    ws, counters = igemm_scratch(plan, dev)
    lib = _lib()
    p = _build.ptr
    g, n2 = plan.geglu, plan.net2
    err = lib.mixdq_geglu_out_qmatmul(
        p(x if ln is not None else None), p(gamma), p(beta), p(codes),
        p(w_int8), p(scale), p(bias0), p(bias), p(h_ws), p(w2_int8),
        p(out_scale), p(out_bias0), p(out_bias), p(residual), p(out), p(ws),
        p(counters), M, K, H, C, int(gelu_tanh),
        int(out_dtype == torch.bfloat16), int(ln is not None), mid_scale_inv,
        mid_zp_shifted, clip[0], clip[1], x_sinv, x_zp, x_clip[0], x_clip[1],
        eps, g.bm, g.stages, g.splits, g.split_k, n2.splits, n2.split_k,
        plan.grid, _build.stream(dev))
    _build.check(lib, err, "geglu_out_qmatmul")
    GEGLU_OUT_COUNT.launches += 1
    return out


def qmatmul_fused_plain(x, w_int8, scale_inv: float, zp_shifted: float,
                        scale, bias0, out_dtype=torch.bfloat16):
    codes = qops.quantize_per_tensor(x.to(torch.bfloat16), scale_inv,
                                     zp_shifted)
    acc = qops.int_gemm(codes, w_int8) - bias0.to(torch.int32)
    return (acc.float() * scale).to(out_dtype)


def fused2_codes_shape(M: int, K: int) -> Tuple[int, int]:
    """``qmatmul_fused2``'s int8 codes workspace ``[M, ldc]``, ``ldc`` K
    rounded up to 16 bytes for the mainloop's 16-byte copies (codes past
    K meet zero weight rows)."""
    return M, -(-K // 16) * 16


def fused2_grid(plan: QmmPlan, per_sm: int, sms: int) -> int:
    """Blocks of ``qmatmul_fused2``'s cooperative launch: one per (tile,
    split) item of ``plan`` where the card holds them all at once, else
    as many as it holds (``per_sm`` blocks on each of ``sms`` SMs); the
    blocks walk the items in a grid stride. Every block must be resident:
    the launch syncs the grid once."""
    if per_sm < 1 or sms < 1:
        raise ValueError(f"qmatmul_fused2: {per_sm} blocks per SM on {sms} "
                         "SMs")
    return min(plan.blocks, per_sm * sms)


@functools.lru_cache(maxsize=None)
def _fused2_per_sm(index: int) -> int:
    """Blocks of ``qmatmul_fused2`` one SM of device ``index`` holds."""
    with torch.cuda.device(index):
        return _fused_lib().mixdq_qmatmul_fused2_per_sm()


def _fused(count, x, w_int8, scale_inv, zp_shifted, scale, bias0,
           out_dtype):
    """One wrapper of the two fused kernels."""
    name = count.name
    count.calls += 1
    if not use_kernel(x, w_int8, scale, bias0):
        return qmatmul_fused_plain(x, w_int8, scale_inv, zp_shifted, scale,
                                   bias0, out_dtype)
    M, K = x.shape
    K2, N = w_int8.shape
    if w_int8.dtype != torch.int8 or K2 != K:
        raise ValueError(f"{name}: bad operands x {tuple(x.shape)}, "
                         f"w {tuple(w_int8.shape)}")
    if scale.shape != (N,) or bias0.shape != (N,) or \
            scale.dtype != torch.float32 or bias0.dtype != torch.float32:
        raise ValueError(f"{name}: scale/bias0 must be f32 [N]")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: out_dtype {out_dtype}")
    # the kernels read rows of any stride: a bf16 row slice is not copied
    xb = x.to(torch.bfloat16)
    if xb.stride(1) != 1 or (M > 1 and xb.stride(0) < K):
        xb = xb.contiguous()
    ldx = xb.stride(0) if M > 1 else K
    check_cuda_args(name, w=w_int8, scale=scale, bias0=bias0)
    dev = x.device
    sms = sm_count(dev.index or 0)
    plan = qmm_plan(M, K, N, sms)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    ws, counters = igemm_scratch(plan, dev)
    lib = _fused_lib()
    p = _build.ptr
    common = (M, K, N, scale_inv, zp_shifted, int(out_dtype == torch.bfloat16),
              plan.bm, plan.stages, plan.splits, plan.split_k)
    if count is FUSED_COUNT:
        err = lib.mixdq_qmatmul_fused(
            p(xb), ldx, p(w_int8), p(scale), p(bias0), p(out), p(ws),
            p(counters), *common, _build.stream(dev))
    else:
        codes = torch.empty(fused2_codes_shape(M, K), dtype=torch.int8,
                            device=dev)
        grid = fused2_grid(plan, _fused2_per_sm(dev.index or 0), sms)
        err = lib.mixdq_qmatmul_fused2(
            p(xb), ldx, p(w_int8), p(scale), p(bias0), p(out), p(codes),
            codes.shape[1], p(ws), p(counters), *common, grid,
            _build.stream(dev))
    _build.check(lib, err, name)
    count.launches += 1
    return out


def _fused_lib():
    lib = _build.load("qmatmul_fused.cu")
    if lib.mixdq_qmatmul_fused.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        tail = [I] * 3 + [F] * 2 + [I] * 5
        lib.mixdq_qmatmul_fused.argtypes = [P, I] + [P] * 6 + tail + [P]
        lib.mixdq_qmatmul_fused.restype = I
        lib.mixdq_qmatmul_fused2.argtypes = ([P, I] + [P] * 5 + [I]
                                             + [P] * 2 + tail + [I, P])
        lib.mixdq_qmatmul_fused2.restype = I
        lib.mixdq_qmatmul_fused2_per_sm.argtypes = []
        lib.mixdq_qmatmul_fused2_per_sm.restype = I
    return lib


def qmatmul_fused(x: torch.Tensor, w_int8: torch.Tensor, scale_inv: float,
                  zp_shifted: float, scale: torch.Tensor, bias0: torch.Tensor,
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """Raw activations ``[M, K]`` (any float dtype, cast to bf16) x int8
    ``[K, N]`` -> ``f32(acc - int32(bias0)) * scale`` ``[M, N]`` in
    ``out_dtype`` (bf16 or f32), the codes ``clip(round(x * scale_inv) +
    zp_shifted, -128, 127)`` formed in every output tile."""
    return _fused(FUSED_COUNT, x, w_int8, scale_inv, zp_shifted, scale,
                  bias0, out_dtype)


def qmatmul_fused2(x: torch.Tensor, w_int8: torch.Tensor, scale_inv: float,
                   zp_shifted: float, scale: torch.Tensor,
                   bias0: torch.Tensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """``qmatmul_fused``'s function, each element quantized once per call
    into a codes workspace (``fused2_codes_shape``) that the same launch
    then multiplies; any K."""
    return _fused(FUSED2_COUNT, x, w_int8, scale_inv, zp_shifted, scale,
                  bias0, out_dtype)
