"""Whole-attention int8 kernels of the ``attn_impl='auto'`` path (ports of
``mixdq_tpu/ops/pallas_sec_attention.py``).

* ``sec_attention`` (port of ``sec_attention``): per-head softmax
  attention over q/k/v read at column offsets of their sources (the
  fused ``to_qkv`` output, or ``to_q``'s output and the fused ``to_kv``
  output, or three projections), and the ``to_out`` act-quantize,
  emitting ``to_out``'s int8 codes.
* ``sec_attention_q`` (port of ``sec_attention_q``): the ``to_q`` GEMM
  with its dequant epilogue (q cast to k's dtype), then the same
  attention over the k/v panels of the fused ``to_kv`` output.
* ``sec_attention_qkv`` (port of ``sec_attention_qkv``): self-attention
  from the norm1 codes: the fused ``[C, 3C]`` QKV GEMM with its dequant
  epilogue, q/k/v cast to bf16, then the same attention.
* ``sec_attention_q_out`` (port of ``sec_attention_q_out``): the whole
  cross-attention sub-block: the pre-LayerNorm + act-quantize (LN-folded
  mode) or given codes, ``sec_attention_q``'s work, the ``to_out`` GEMM,
  its bias and the residual add.
* ``sec_attention_qkv_out`` (port of ``sec_attention_qkv_out``): the
  whole self-attention sub-block: the pre-LayerNorm + act-quantize
  (LN-folded mode) or given codes, ``sec_attention_qkv``'s work, the
  ``to_out`` GEMM, its bias and the residual add.

Kernels: ``csrc/sec_attention.cu``: all but ``sec_attention`` are one
cooperative launch of grid-stride stages (LN, the projection GEMM,
attention, the to_out GEMM) whose GEMMs run ``qmatmul``'s mainloop under
``sec_plan``. Plain versions: the ``*_plain`` functions, which share
``_attend_codes_plain``, a step-by-step copy of the JAX
``_attend_codes``. The kernels take every shape with ``head_dim`` in
``HEAD_DIMS``; which of them runs at a site is the router's choice
(``models/routing.py``). ``probe`` records a launch's workspaces and its
stage times.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence

import torch

from . import _build, check_cuda_args, qops, register, sm_count, use_kernel
from .ln_quant import check_block_input, ln_or_codes_plain
from .qmatmul import QmmPlan, igemm_scratch, qmm_plan

SEC_COUNT = register("sec_attention")
Q_COUNT = register("sec_attention_q")
QKV_COUNT = register("sec_attention_qkv")
Q_OUT_COUNT = register("sec_attention_q_out")
QKV_OUT_COUNT = register("sec_attention_qkv_out")

HEAD_DIMS = (16, 32, 64, 128)
_FLOAT_TYPES = (torch.bfloat16, torch.float32)


def check_head_dim(head_dim: int) -> None:
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim}: the attention kernels take "
                         f"{HEAD_DIMS}")


def _attend_codes_plain(q, k, v, heads: int, head_dim: int, scale: float,
                        scale_inv: float, zp_shifted: float, clip):
    """Per-head softmax attention over q ``[B, Tq, heads*d]`` and k/v
    ``[B, Tk, heads*d]``, then the ``to_out`` act-quantize: int8 codes
    ``[B, Tq, heads*d]``. f32 logits scaled after the dot, the row max
    over all keys before any ``exp``, ``p`` cast to v's dtype for the PV
    product and the f32 row sum ``l`` of the uncast ``p``."""
    d = head_dim
    outs = []
    for i in range(heads):
        qi = q[..., i * d:(i + 1) * d].float()
        ki = k[..., i * d:(i + 1) * d].float()
        vi = v[..., i * d:(i + 1) * d]
        s = qi @ ki.transpose(-1, -2)
        s = s * scale
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(-1, keepdim=True)
        o = p.to(vi.dtype).float() @ vi.float()
        o = o / l
        outs.append((torch.round(o * scale_inv) + zp_shifted).clamp_(
            clip[0], clip[1]))
    return torch.cat(outs, -1).to(torch.int8)


def _proj_plain(x_codes, w_int8, scale, bias0, dtype):
    """``(f32(acc) - bias0) * scale`` cast to ``dtype``, over the last
    axis of the codes."""
    acc = qops.int_gemm(x_codes.reshape(-1, x_codes.shape[-1]), w_int8)
    y = (acc.float() - bias0) * scale
    return y.to(dtype).reshape(*x_codes.shape[:-1], -1)


def sec_attention_plain(q_src, k_src, v_src, out_scale_inv: float,
                        out_zp_shifted: float, *, heads: int, head_dim: int,
                        scale: float, q_off: int = 0, k_off: int = 0,
                        v_off: int = 0, clip=(-128.0, 127.0)):
    C = heads * head_dim
    return _attend_codes_plain(q_src[..., q_off:q_off + C],
                               k_src[..., k_off:k_off + C],
                               v_src[..., v_off:v_off + C], heads, head_dim,
                               scale, out_scale_inv, out_zp_shifted, clip)


def sec_attention_q_plain(x_codes, wq_int8, wq_scale, bias0, k_src, v_src,
                          out_scale_inv: float, out_zp_shifted: float, *,
                          heads: int, head_dim: int, scale: float,
                          k_off: int = 0, v_off: int = 0,
                          clip=(-128.0, 127.0)):
    q = _proj_plain(x_codes, wq_int8, wq_scale, bias0, k_src.dtype)
    return sec_attention_plain(q, k_src, v_src, out_scale_inv,
                               out_zp_shifted, heads=heads,
                               head_dim=head_dim, scale=scale, k_off=k_off,
                               v_off=v_off, clip=clip)


def sec_attention_qkv_plain(x_codes, w_int8, w_scale, bias0,
                            out_scale_inv: float, out_zp_shifted: float, *,
                            heads: int, head_dim: int, scale: float,
                            clip=(-128.0, 127.0)):
    C = x_codes.shape[-1]
    y = _proj_plain(x_codes, w_int8, w_scale, bias0, torch.bfloat16)
    return _attend_codes_plain(y[..., :C], y[..., C:2 * C], y[..., 2 * C:],
                               heads, head_dim, scale, out_scale_inv,
                               out_zp_shifted, clip)


def sec_attention_q_out_plain(x, wq_int8, wq_scale, bias0, k_src, v_src,
                              mid_scale_inv: float, mid_zp_shifted: float,
                              wout_int8, out_scale, out_bias0, out_bias,
                              residual, *, heads: int, head_dim: int,
                              scale: float, k_off: int = 0, v_off: int = 0,
                              out_dtype=torch.bfloat16,
                              clip=(-128.0, 127.0), ln=None):
    codes, residual = ln_or_codes_plain(x, residual, ln)
    o_codes = sec_attention_q_plain(
        codes, wq_int8, wq_scale, bias0, k_src, v_src, mid_scale_inv,
        mid_zp_shifted, heads=heads, head_dim=head_dim, scale=scale,
        k_off=k_off, v_off=v_off, clip=clip)
    return _out_proj_plain(o_codes, wout_int8, out_scale, out_bias0,
                           out_bias, residual, out_dtype)


def _out_proj_plain(o_codes, wout_int8, out_scale, out_bias0, out_bias,
                    residual, out_dtype):
    """The whole-block tail: ``(f32(acc) - bias0) * scale``, then ``+
    bias``, then ``+ f32(residual)``, one cast to ``out_dtype``."""
    out = _proj_plain(o_codes, wout_int8, out_scale, out_bias0, torch.float32)
    if out_bias is not None:
        out = out + out_bias.float()
    if residual is not None:
        out = out + residual.float()
    return out.to(out_dtype)


def sec_attention_qkv_out_plain(x, w_int8, w_scale, bias0,
                                mid_scale_inv: float, mid_zp_shifted: float,
                                wout_int8, out_scale, out_bias0, out_bias,
                                residual, *, heads: int, head_dim: int,
                                scale: float, out_dtype=torch.bfloat16,
                                clip=(-128.0, 127.0), ln=None):
    codes, residual = ln_or_codes_plain(x, residual, ln)
    o_codes = sec_attention_qkv_plain(
        codes, w_int8, w_scale, bias0, mid_scale_inv, mid_zp_shifted,
        heads=heads, head_dim=head_dim, scale=scale, clip=clip)
    return _out_proj_plain(o_codes, wout_int8, out_scale, out_bias0,
                           out_bias, residual, out_dtype)


def _lib():
    lib = _build.load("sec_attention.cu")
    f = lib.mixdq_sec_attention
    if f.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        f.argtypes = [P] * 3 + [I] * 3 + [P] + [I] * 6 + [F] * 5 + [P]
        f.restype = I
    return lib


#: the C entry's kind of each cooperative kernel
_KINDS = {"sec_attention_q": 0, "sec_attention_qkv": 1,
          "sec_attention_q_out": 2, "sec_attention_qkv_out": 3}


def _coop_lib(head_dim: int):
    """The cooperative kernels at ``head_dim`` (one source a head dim)."""
    lib = _build.load(f"sec_coop_d{head_dim}.cu")
    f = lib.mixdq_sec_attention_coop
    if f.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        f.argtypes = ([I] + [P] * 9 + [I, P, I, P, I] + [P] * 10 + [I] * 11
                      + [F] * 10 + [I] * 7 + [P])
        f.restype = I
        lib.mixdq_sec_attention_per_sm.argtypes = []
        lib.mixdq_sec_attention_per_sm.restype = I
    return lib


@dataclasses.dataclass(frozen=True)
class SecPlan:
    """One cooperative launch of the ``sec_attention*`` kernels: ``proj``
    the to_q (``[C_in, C]``) or fused QKV (``[C, 3C]``) GEMM's plan,
    ``out`` the to_out GEMM's (``[C, C_in]``) or None, ``attn_items`` the
    (batch, head, 64-row) attention items, ``grid`` blocks (every one
    resident: the launch syncs its grid), and the int32 split workspace
    and counters that the GEMM stages share, one stage at a time."""
    proj: QmmPlan
    out: Optional[QmmPlan]
    attn_items: int
    grid: int
    ws_elems: int
    counters: int

    @property
    def gemms(self):
        return (self.proj,) if self.out is None else (self.proj, self.out)

    @property
    def splits(self) -> int:
        """The most splits of a GEMM stage (``igemm_scratch``)."""
        return max(p.splits for p in self.gemms)


@functools.lru_cache(maxsize=4096)
def sec_plan(B: int, Tq: int, C_in: int, heads: int, head_dim: int,
             sms: int, per_sm: int, *, qkv: bool, out: bool) -> SecPlan:
    """The plan of one cooperative launch at batch ``B``, ``Tq`` query
    rows, ``heads`` heads of ``head_dim`` (C = heads * head_dim) and input
    width ``C_in`` (C for the fused QKV GEMM), on ``sms`` SMs holding
    ``per_sm`` blocks each: each GEMM stage under ``qmm_plan`` over ``M =
    B * Tq`` rows, and a grid of one block per item of the largest stage
    (GEMM (tile, split) items or (batch, head, 64-row) attention items)
    where the card holds that many at once, else as many as it holds.
    Blocks walk every stage's items in a grid stride (attention items two
    at once a block where they outnumber the blocks)."""
    if per_sm < 1 or sms < 1:
        raise ValueError(f"sec_attention: {per_sm} blocks per SM on {sms} "
                         "SMs")
    M, C = B * Tq, heads * head_dim
    proj = qmm_plan(M, C_in, 3 * C if qkv else C, sms)
    tail = qmm_plan(M, C, C_in, sms) if out else None
    items = B * heads * -(-Tq // 64)
    gemms = (proj,) if tail is None else (proj, tail)
    grid = min(per_sm * sms, max(items, *(p.blocks for p in gemms)))
    return SecPlan(proj, tail, items, grid, max(p.ws_elems for p in gemms),
                   max(p.counters for p in gemms))


@functools.lru_cache(maxsize=None)
def _per_sm(index: int, head_dim: int) -> int:
    """Blocks of the cooperative kernels at ``head_dim`` one SM of device
    ``index`` holds (at their 256 threads and 128 KB of dynamic shared
    memory)."""
    with torch.cuda.device(index):
        return _coop_lib(head_dim).mixdq_sec_attention_per_sm()


def _plan(dev, B, Tq, C_in, heads, head_dim, *, qkv, out) -> SecPlan:
    index = dev.index or 0
    return sec_plan(B, Tq, C_in, heads, head_dim, sm_count(index),
                    _per_sm(index, head_dim), qkv=qkv, out=out)


_PROBES: Optional[List[dict]] = None
#: the stages between the stamps of a probed launch
STAGES = ("ln", "proj", "attention", "out")


@contextlib.contextmanager
def probe():
    """Within the block, every cooperative ``sec_attention*`` launch
    appends its tensors to the yielded list, a dict a launch: ``codes``
    (the projection's codes, written by the kernel in LN-folded mode),
    ``proj`` (the q or q | k | v workspace), ``o`` (to_out's codes: the
    output of the kernels without to_out), ``out`` (the whole-block
    output or None) and ``stamps`` (int64 ``[5]``, the device's global
    timer in ns at the start and after each of ``STAGES``: ``stage_ms``).
    Each probed launch syncs its grid once more at its end."""
    global _PROBES
    prev, _PROBES = _PROBES, []
    try:
        yield _PROBES
    finally:
        _PROBES = prev


def stage_ms(rec: dict) -> Dict[str, float]:
    """Device ms of each stage of a probed launch (0 where it has none)."""
    t = rec["stamps"].tolist()
    return {name: (t[i + 1] - t[i]) / 1e6 for i, name in enumerate(STAGES)}


def _panel_ptr(t: torch.Tensor, off: int) -> int:
    return t.data_ptr() + off * t.element_size()


def check_panels(name: str, C: int, *panels) -> torch.dtype:
    """The q/k/v sources a kernel reads in place, as ``(tensor, column
    offset)`` pairs: contiguous ``[B, T, >= offset + C]`` of one dtype,
    bf16 or f32; a bf16 panel starts on 16 bytes and its rows are a
    multiple of 16 bytes (the kernels' vector loads). Returns the dtype."""
    dt = panels[0][0].dtype
    if dt not in _FLOAT_TYPES:
        raise TypeError(f"{name}: q/k/v must be bf16 or f32, not {dt}")
    for t, off in panels:
        if t.dtype != dt or t.ndim != 3 or t.shape[-1] < off + C:
            raise ValueError(f"{name}: panel at {off} of {tuple(t.shape)} "
                             f"{t.dtype} out of range for {C} {dt} columns")
        if not t.is_contiguous():
            raise ValueError(f"{name}: q/k/v sources must be contiguous")
        if dt == torch.bfloat16 and (_panel_ptr(t, off) % 16
                                     or t.shape[-1] % 8):
            raise ValueError(f"{name}: bf16 panels must start on 16 bytes "
                             "with rows a multiple of 16 bytes")
    return dt


def sec_attention(q_src: torch.Tensor, k_src: torch.Tensor,
                  v_src: torch.Tensor, out_scale_inv: float,
                  out_zp_shifted: float, *, heads: int, head_dim: int,
                  scale: float, q_off: int = 0, k_off: int = 0,
                  v_off: int = 0, clip=(-128.0, 127.0)) -> torch.Tensor:
    """Softmax attention over q ``[B, Tq, >= q_off + C]`` and k/v ``[B,
    Tk, >= off + C]`` read at their column offsets (bf16 or f32, one
    dtype) -> ``to_out``'s int8 codes ``[B, Tq, C]``, C = heads *
    head_dim."""
    SEC_COUNT.calls += 1
    check_head_dim(head_dim)
    if not use_kernel(q_src, k_src, v_src):
        return sec_attention_plain(
            q_src, k_src, v_src, out_scale_inv, out_zp_shifted, heads=heads,
            head_dim=head_dim, scale=scale, q_off=q_off, k_off=k_off,
            v_off=v_off, clip=clip)
    C = heads * head_dim
    dt = check_panels("sec_attention", C, (q_src, q_off), (k_src, k_off),
                      (v_src, v_off))
    B, Tq = q_src.shape[:2]
    Tk = k_src.shape[1]
    if k_src.shape[0] != B or v_src.shape[:2] != (B, Tk):
        raise ValueError("sec_attention: q/k/v batch or key counts differ")
    out = torch.empty((B, Tq, C), dtype=torch.int8, device=q_src.device)
    lib = _lib()
    err = lib.mixdq_sec_attention(
        _panel_ptr(q_src, q_off), _panel_ptr(k_src, k_off),
        _panel_ptr(v_src, v_off), q_src.shape[-1], k_src.shape[-1],
        v_src.shape[-1], _build.ptr(out), B, Tq, Tk, heads, head_dim,
        int(dt == torch.bfloat16), scale, out_scale_inv, out_zp_shifted,
        clip[0], clip[1], _build.stream(q_src.device))
    _build.check(lib, err, "sec_attention")
    SEC_COUNT.launches += 1
    return out


def _coop(name: str, plan: SecPlan, *, codes, w, w_scale, bias0, proj, q,
          k, v, o, Tk: int, heads: int, head_dim: int, scale: float,
          mid, x=None, fold=None, tail=None) -> None:
    """One launch of the cooperative kernel: ``codes`` ``[B, Tq, Kp]``
    (written in LN-folded mode: ``x`` the raw input, ``fold`` its
    ``check_block_input`` tuple) x ``w`` ``[Kp, Np]`` -> ``proj`` ``[.., Np]``
    (q's dtype); attention over the ``(tensor, column offset)`` panels
    ``q``/``k``/``v`` with the quantizer ``mid`` = (scale_inv,
    zp_shifted, clip) -> ``o``; ``tail`` = (wout, out_scale, out_bias0,
    out_bias, residual, out) or None."""
    dev = codes.device
    B, Tq, Kp = codes.shape
    ws, counters = igemm_scratch(plan, dev)
    stamps = (torch.zeros(5, dtype=torch.int64, device=dev)
              if _PROBES is not None else None)
    gamma, beta, x_sinv, x_zp, x_clip, eps = (
        fold or (None, None, 0.0, 0.0, (0.0, 0.0), 0.0))
    wout, so, b0o, bo, res, out = tail or (None,) * 6
    tail_split = (plan.out.splits, plan.out.split_k) if plan.out else (0, 0)
    (qt, qo), (kt, ko), (vt, vo) = q, k, v
    mid_sinv, mid_zp, clip = mid
    out_dt = (out if out is not None else proj).dtype
    p = _build.ptr
    lib = _coop_lib(head_dim)
    err = lib.mixdq_sec_attention_coop(
        _KINDS[name], p(x if fold is not None else None), p(gamma), p(beta),
        p(codes), p(w), p(w_scale), p(bias0), p(proj), _panel_ptr(qt, qo),
        qt.shape[-1], _panel_ptr(kt, ko), kt.shape[-1], _panel_ptr(vt, vo),
        vt.shape[-1], p(o), p(wout), p(so), p(b0o), p(bo), p(res), p(out),
        p(ws), p(counters), p(stamps), B, Tq, Tk, Kp, w.shape[1],
        0 if wout is None else wout.shape[1], heads, head_dim,
        int(proj.dtype == torch.bfloat16), int(out_dt == torch.bfloat16),
        int(fold is not None), scale, mid_sinv, mid_zp, clip[0], clip[1],
        x_sinv, x_zp, x_clip[0], x_clip[1], eps, plan.proj.bm,
        plan.proj.stages, plan.proj.splits, plan.proj.split_k, *tail_split,
        plan.grid, _build.stream(dev))
    _build.check(lib, err, name)
    if _PROBES is not None:
        _PROBES.append(dict(codes=codes, proj=proj, o=o, out=out,
                            stamps=stamps))


def sec_attention_q(x_codes: torch.Tensor, wq_int8: torch.Tensor,
                    wq_scale: torch.Tensor, bias0: torch.Tensor,
                    k_src: torch.Tensor, v_src: torch.Tensor,
                    out_scale_inv: float, out_zp_shifted: float, *,
                    heads: int, head_dim: int, scale: float, k_off: int = 0,
                    v_off: int = 0, clip=(-128.0, 127.0)) -> torch.Tensor:
    """Cross-attention from to_q's codes ``x_codes`` ``[B, Tq, C_in]``:
    the to_q GEMM (``wq_int8`` ``[C_in, C]``, f32 ``[C]`` scale and
    ``bias0``; q in k's dtype), then attention over the k/v panels of
    ``k_src``/``v_src`` ``[B, Tk, >= off + C]`` (the fused ``to_kv``
    output) -> ``to_out``'s int8 codes ``[B, Tq, C]``."""
    Q_COUNT.calls += 1
    check_head_dim(head_dim)
    if not use_kernel(x_codes, wq_int8, wq_scale, bias0, k_src, v_src):
        return sec_attention_q_plain(
            x_codes, wq_int8, wq_scale, bias0, k_src, v_src, out_scale_inv,
            out_zp_shifted, heads=heads, head_dim=head_dim, scale=scale,
            k_off=k_off, v_off=v_off, clip=clip)
    B, Tq, C_in = x_codes.shape
    C = heads * head_dim
    dt = check_panels("sec_attention_q", C, (k_src, k_off), (v_src, v_off))
    Tk = k_src.shape[1]
    if x_codes.dtype != torch.int8 or k_src.shape[0] != B or \
            v_src.shape[:2] != (B, Tk):
        raise ValueError("sec_attention_q: int8 codes [B, Tq, C_in] and k/v "
                         "[B, Tk, ...] expected")
    _check_weight("sec_attention_q", wq_int8, C_in, C, wq_scale, bias0)
    check_cuda_args("sec_attention_q", x=x_codes, wq=wq_int8,
                    wq_scale=wq_scale, bias0=bias0)
    dev = x_codes.device
    q_ws = torch.empty((B, Tq, C), dtype=dt, device=dev)
    out = torch.empty((B, Tq, C), dtype=torch.int8, device=dev)
    _coop("sec_attention_q",
          _plan(dev, B, Tq, C_in, heads, head_dim, qkv=False, out=False),
          codes=x_codes, w=wq_int8, w_scale=wq_scale, bias0=bias0,
          proj=q_ws, q=(q_ws, 0), k=(k_src, k_off), v=(v_src, v_off),
          o=out, Tk=Tk, heads=heads, head_dim=head_dim, scale=scale,
          mid=(out_scale_inv, out_zp_shifted, clip))
    Q_COUNT.launches += 1
    return out


def _check_weight(name, w, k, n, scale, bias0):
    """An int8 ``[k, n]`` weight with f32 ``[n]`` scale and ``bias0``."""
    if w.dtype != torch.int8 or w.shape != (k, n):
        raise ValueError(f"{name}: weight {tuple(w.shape)} {w.dtype}, "
                         f"expected int8 [{k}, {n}]")
    for t in (scale, bias0):
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"{name}: scale/bias0 must be f32 [{n}]")


def sec_attention_qkv(x_codes: torch.Tensor, w_int8: torch.Tensor,
                      w_scale: torch.Tensor, bias0: torch.Tensor,
                      out_scale_inv: float, out_zp_shifted: float, *,
                      heads: int, head_dim: int, scale: float,
                      clip=(-128.0, 127.0)) -> torch.Tensor:
    """Self-attention from the norm1 codes ``x_codes`` ``[B, T, C]``
    through the fused QKV weight ``[C, 3C]`` (q | k | v column panels,
    ``w_scale``/``bias0`` f32 ``[3C]``) -> ``to_out``'s int8 codes
    ``[B, T, C]``."""
    QKV_COUNT.calls += 1
    check_head_dim(head_dim)
    if not use_kernel(x_codes, w_int8, w_scale, bias0):
        return sec_attention_qkv_plain(
            x_codes, w_int8, w_scale, bias0, out_scale_inv, out_zp_shifted,
            heads=heads, head_dim=head_dim, scale=scale, clip=clip)
    B, T, C = x_codes.shape
    if heads * head_dim != C or x_codes.dtype != torch.int8:
        raise ValueError(f"sec_attention_qkv: codes {tuple(x_codes.shape)} "
                         f"{x_codes.dtype} for {heads} heads of {head_dim}")
    _check_weight("sec_attention_qkv", w_int8, C, 3 * C, w_scale, bias0)
    check_cuda_args("sec_attention_qkv", x=x_codes, w=w_int8, scale=w_scale,
                    bias0=bias0)
    dev = x_codes.device
    ws = torch.empty((B, T, 3 * C), dtype=torch.bfloat16, device=dev)
    out = torch.empty((B, T, C), dtype=torch.int8, device=dev)
    _coop("sec_attention_qkv",
          _plan(dev, B, T, C, heads, head_dim, qkv=True, out=False),
          codes=x_codes, w=w_int8, w_scale=w_scale, bias0=bias0, proj=ws,
          q=(ws, 0), k=(ws, C), v=(ws, 2 * C), o=out, Tk=T, heads=heads,
          head_dim=head_dim, scale=scale,
          mid=(out_scale_inv, out_zp_shifted, clip))
    QKV_COUNT.launches += 1
    return out


def sec_attention_q_out(x: torch.Tensor, wq_int8: torch.Tensor,
                        wq_scale: torch.Tensor, bias0: torch.Tensor,
                        k_src: torch.Tensor, v_src: torch.Tensor,
                        mid_scale_inv: float, mid_zp_shifted: float,
                        wout_int8: torch.Tensor, out_scale: torch.Tensor,
                        out_bias0: torch.Tensor,
                        out_bias: Optional[torch.Tensor],
                        residual: Optional[torch.Tensor], *, heads: int,
                        head_dim: int, scale: float, k_off: int = 0,
                        v_off: int = 0, out_dtype=torch.bfloat16,
                        clip=(-128.0, 127.0),
                        ln: Optional[Sequence] = None) -> torch.Tensor:
    """Whole cross-attention sub-block -> ``[B, Tq, C_in]`` in
    ``out_dtype``.

    ``x``: the int8 codes of ``to_q`` ``[B, Tq, C_in]``, or, in LN-folded
    mode (``ln`` = ``(gamma, beta, x_scale_inv, x_zp_shifted, x_clip,
    eps)``), the raw block input, which then is also the residual
    (``residual`` must be None). ``k_src``/``v_src`` ``[B, Tk, >= off +
    C]`` hold k and v at column offsets ``k_off``/``v_off`` (the fused
    ``to_kv`` output); q is cast to their dtype. ``wq_int8`` ``[C_in, C]``
    and ``wout_int8`` ``[C, C_in]`` with f32 scales/``bias0``;
    ``out_bias`` the ``to_out`` bias or None."""
    Q_OUT_COUNT.calls += 1
    check_head_dim(head_dim)
    if ln is not None and residual is not None:
        raise ValueError("sec_attention_q_out: in LN-folded mode the input "
                         "is the residual")
    if not use_kernel(x, wq_int8, k_src, v_src, wout_int8, residual):
        return sec_attention_q_out_plain(
            x, wq_int8, wq_scale, bias0, k_src, v_src, mid_scale_inv,
            mid_zp_shifted, wout_int8, out_scale, out_bias0, out_bias,
            residual, heads=heads, head_dim=head_dim, scale=scale,
            k_off=k_off, v_off=v_off, out_dtype=out_dtype, clip=clip, ln=ln)
    B, Tq, C_in = x.shape
    C = heads * head_dim
    Tk = k_src.shape[1]
    dt = check_panels("sec_attention_q_out", C, (k_src, k_off),
                      (v_src, v_off))
    if out_dtype != dt:
        raise TypeError(f"sec_attention_q_out: out {out_dtype} must be k/v's "
                        f"{dt}")
    if k_src.shape[0] != B or v_src.shape[:2] != (B, Tk):
        raise ValueError("sec_attention_q_out: k/v batch or key counts "
                         "differ")
    fold = check_block_input("sec_attention_q_out", x, residual, ln, C_in, dt,
                             x.shape)
    _check_weight("sec_attention_q_out to_q", wq_int8, C_in, C, wq_scale,
                  bias0)
    _check_weight("sec_attention_q_out to_out", wout_int8, C, C_in,
                  out_scale, out_bias0)
    if out_bias is not None:
        out_bias = out_bias.float().contiguous()
    check_cuda_args("sec_attention_q_out", x=x, gamma=fold[0], beta=fold[1],
                    wq=wq_int8, wq_scale=wq_scale, bias0=bias0,
                    wout=wout_int8, out_scale=out_scale,
                    out_bias0=out_bias0, residual=residual)
    dev = x.device
    codes = (torch.empty((B, Tq, C_in), dtype=torch.int8, device=dev)
             if ln is not None else x)
    q_ws = torch.empty((B, Tq, C), dtype=dt, device=dev)
    o_ws = torch.empty((B, Tq, C), dtype=torch.int8, device=dev)
    out = torch.empty((B, Tq, C_in), dtype=dt, device=dev)
    _coop("sec_attention_q_out",
          _plan(dev, B, Tq, C_in, heads, head_dim, qkv=False, out=True),
          codes=codes, w=wq_int8, w_scale=wq_scale, bias0=bias0, proj=q_ws,
          q=(q_ws, 0), k=(k_src, k_off), v=(v_src, v_off), o=o_ws, Tk=Tk,
          heads=heads, head_dim=head_dim, scale=scale,
          mid=(mid_scale_inv, mid_zp_shifted, clip), x=x,
          fold=None if ln is None else fold,
          tail=(wout_int8, out_scale, out_bias0, out_bias, residual, out))
    Q_OUT_COUNT.launches += 1
    return out


def sec_attention_qkv_out(x: torch.Tensor, w_int8: torch.Tensor,
                          w_scale: torch.Tensor, bias0: torch.Tensor,
                          mid_scale_inv: float, mid_zp_shifted: float,
                          wout_int8: torch.Tensor, out_scale: torch.Tensor,
                          out_bias0: torch.Tensor,
                          out_bias: Optional[torch.Tensor],
                          residual: Optional[torch.Tensor], *, heads: int,
                          head_dim: int, scale: float,
                          out_dtype=torch.bfloat16, clip=(-128.0, 127.0),
                          ln: Optional[Sequence] = None) -> torch.Tensor:
    """Whole self-attention sub-block -> ``[B, T, C]`` in ``out_dtype``
    (bf16 or f32).

    ``x``: the int8 codes of the fused QKV entry ``[B, T, C]``, or, in
    LN-folded mode (``ln`` = ``(gamma, beta, x_scale_inv, x_zp_shifted,
    x_clip, eps)``), the raw block input in ``out_dtype``, which then is
    also the residual (``residual`` must be None). ``w_int8`` ``[C, 3C]``
    (q | k | v column panels; q/k/v cast to bf16 after the projection)
    and ``wout_int8`` ``[C, C]`` with f32 scales/``bias0``; ``out_bias``
    the ``to_out`` bias or None."""
    QKV_OUT_COUNT.calls += 1
    check_head_dim(head_dim)
    if ln is not None and residual is not None:
        raise ValueError("sec_attention_qkv_out: in LN-folded mode the "
                         "input is the residual")
    if not use_kernel(x, w_int8, wout_int8, residual):
        return sec_attention_qkv_out_plain(
            x, w_int8, w_scale, bias0, mid_scale_inv, mid_zp_shifted,
            wout_int8, out_scale, out_bias0, out_bias, residual, heads=heads,
            head_dim=head_dim, scale=scale, out_dtype=out_dtype, clip=clip,
            ln=ln)
    B, T, C = x.shape
    if heads * head_dim != C:
        raise ValueError(f"sec_attention_qkv_out: {tuple(x.shape)} for "
                         f"{heads} heads of {head_dim}")
    if out_dtype not in _FLOAT_TYPES:
        raise TypeError(f"sec_attention_qkv_out: out_dtype {out_dtype}")
    fold = check_block_input("sec_attention_qkv_out", x, residual, ln, C,
                             out_dtype, x.shape)
    _check_weight("sec_attention_qkv_out to_qkv", w_int8, C, 3 * C, w_scale,
                  bias0)
    _check_weight("sec_attention_qkv_out to_out", wout_int8, C, C, out_scale,
                  out_bias0)
    if out_bias is not None:
        out_bias = out_bias.float().contiguous()
    check_cuda_args("sec_attention_qkv_out", x=x, gamma=fold[0],
                    beta=fold[1], w=w_int8, scale=w_scale, bias0=bias0,
                    wout=wout_int8, out_scale=out_scale, out_bias0=out_bias0,
                    residual=residual)
    dev = x.device
    codes = (torch.empty((B, T, C), dtype=torch.int8, device=dev)
             if ln is not None else x)
    ws = torch.empty((B, T, 3 * C), dtype=torch.bfloat16, device=dev)
    o_ws = torch.empty((B, T, C), dtype=torch.int8, device=dev)
    out = torch.empty((B, T, C), dtype=out_dtype, device=dev)
    _coop("sec_attention_qkv_out",
          _plan(dev, B, T, C, heads, head_dim, qkv=True, out=True),
          codes=codes, w=w_int8, w_scale=w_scale, bias0=bias0, proj=ws,
          q=(ws, 0), k=(ws, C), v=(ws, 2 * C), o=o_ws, Tk=T, heads=heads,
          head_dim=head_dim, scale=scale,
          mid=(mid_scale_inv, mid_zp_shifted, clip), x=x,
          fold=None if ln is None else fold,
          tail=(wout_int8, out_scale, out_bias0, out_bias, residual, out))
    QKV_OUT_COUNT.launches += 1
    return out
