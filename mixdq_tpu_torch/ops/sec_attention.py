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

Kernels: ``csrc/sec_attention.cu``. Plain versions: the ``*_plain``
functions, which share ``_attend_codes_plain``, a step-by-step copy of
the JAX ``_attend_codes``. The kernels take every shape with
``head_dim`` in ``HEAD_DIMS``; which of them runs at a site is the
router's choice (``models/routing.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import _build, check_cuda_args, qops, register, use_kernel
from .ln_quant import check_block_input, ln_or_codes_plain

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
    if lib.mixdq_sec_attention_qkv.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        f = lib.mixdq_sec_attention_qkv
        f.argtypes = [P] * 6 + [I] * 5 + [F] * 5 + [P]
        f.restype = I
        f = lib.mixdq_sec_attention_q_out
        f.argtypes = [P] * 8 + [I] * 2 + [P] * 9 + [I] * 8 + [F] * 10 + [P]
        f.restype = I
        f = lib.mixdq_sec_attention
        f.argtypes = [P] * 3 + [I] * 3 + [P] + [I] * 6 + [F] * 5 + [P]
        f.restype = I
        f = lib.mixdq_sec_attention_q
        f.argtypes = [P] * 6 + [I] * 2 + [P] * 2 + [I] * 7 + [F] * 5 + [P]
        f.restype = I
        f = lib.mixdq_sec_attention_qkv_out
        f.argtypes = [P] * 15 + [I] * 6 + [F] * 10 + [P]
        f.restype = I
    return lib


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
    lib = _lib()
    p = _build.ptr
    err = lib.mixdq_sec_attention_q(
        p(x_codes), p(wq_int8), p(wq_scale), p(bias0),
        _panel_ptr(k_src, k_off), _panel_ptr(v_src, v_off), k_src.shape[-1],
        v_src.shape[-1], p(q_ws), p(out), B, Tq, Tk, C_in, heads, head_dim,
        int(dt == torch.bfloat16), scale, out_scale_inv, out_zp_shifted,
        clip[0], clip[1], _build.stream(dev))
    _build.check(lib, err, "sec_attention_q")
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
    ws = torch.empty((B * T, 3 * C), dtype=torch.bfloat16, device=dev)
    out = torch.empty((B, T, C), dtype=torch.int8, device=dev)
    lib = _lib()
    p = _build.ptr
    err = lib.mixdq_sec_attention_qkv(
        p(x_codes), p(w_int8), p(w_scale), p(bias0), p(ws), p(out), B, T,
        C, heads, head_dim, scale, out_scale_inv, out_zp_shifted, clip[0],
        clip[1], _build.stream(dev))
    _build.check(lib, err, "sec_attention_qkv")
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
    gamma, beta, x_sinv, x_zp, x_clip, eps = check_block_input(
        "sec_attention_q_out", x, residual, ln, C_in, dt, x.shape)
    codes = (torch.empty((B, Tq, C_in), dtype=torch.int8, device=x.device)
             if ln is not None else x)
    _check_weight("sec_attention_q_out to_q", wq_int8, C_in, C, wq_scale,
                  bias0)
    _check_weight("sec_attention_q_out to_out", wout_int8, C, C_in,
                  out_scale, out_bias0)
    if out_bias is not None:
        out_bias = out_bias.float().contiguous()
    check_cuda_args("sec_attention_q_out", x=x, gamma=gamma, beta=beta,
                    wq=wq_int8, wq_scale=wq_scale, bias0=bias0,
                    wout=wout_int8, out_scale=out_scale,
                    out_bias0=out_bias0, residual=residual)
    dev = x.device
    q_ws = torch.empty((B, Tq, C), dtype=dt, device=dev)
    o_ws = torch.empty((B, Tq, C), dtype=torch.int8, device=dev)
    out = torch.empty((B, Tq, C_in), dtype=dt, device=dev)
    lib = _lib()
    p = _build.ptr
    err = lib.mixdq_sec_attention_q_out(
        p(x if ln is not None else None), p(gamma), p(beta), p(wq_int8),
        p(wq_scale), p(bias0), _panel_ptr(k_src, k_off),
        _panel_ptr(v_src, v_off), k_src.shape[-1], v_src.shape[-1],
        p(wout_int8), p(out_scale), p(out_bias0), p(out_bias), p(residual),
        p(codes), p(q_ws), p(o_ws), p(out), B, Tq, Tk, C_in, heads,
        head_dim, int(dt == torch.bfloat16), int(ln is not None), scale,
        mid_scale_inv, mid_zp_shifted, clip[0], clip[1], x_sinv, x_zp,
        x_clip[0], x_clip[1], eps, _build.stream(dev))
    _build.check(lib, err, "sec_attention_q_out")
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
    gamma, beta, x_sinv, x_zp, x_clip, eps = check_block_input(
        "sec_attention_qkv_out", x, residual, ln, C, out_dtype, x.shape)
    _check_weight("sec_attention_qkv_out to_qkv", w_int8, C, 3 * C, w_scale,
                  bias0)
    _check_weight("sec_attention_qkv_out to_out", wout_int8, C, C, out_scale,
                  out_bias0)
    if out_bias is not None:
        out_bias = out_bias.float().contiguous()
    check_cuda_args("sec_attention_qkv_out", x=x, gamma=gamma, beta=beta,
                    w=w_int8, scale=w_scale, bias0=bias0, wout=wout_int8,
                    out_scale=out_scale, out_bias0=out_bias0,
                    residual=residual)
    dev = x.device
    codes = (torch.empty((B, T, C), dtype=torch.int8, device=dev)
             if ln is not None else x)
    ws = torch.empty((B * T, 3 * C), dtype=torch.bfloat16, device=dev)
    o_ws = torch.empty((B, T, C), dtype=torch.int8, device=dev)
    out = torch.empty((B, T, C), dtype=out_dtype, device=dev)
    lib = _lib()
    p = _build.ptr
    err = lib.mixdq_sec_attention_qkv_out(
        p(x if ln is not None else None), p(gamma), p(beta), p(codes),
        p(w_int8), p(w_scale), p(bias0), p(ws), p(o_ws), p(wout_int8),
        p(out_scale), p(out_bias0), p(out_bias), p(residual), p(out), B, T,
        heads, head_dim, int(out_dtype == torch.bfloat16),
        int(ln is not None), scale, mid_scale_inv, mid_zp_shifted,
        clip[0], clip[1], x_sinv, x_zp, x_clip[0], x_clip[1], eps,
        _build.stream(dev))
    _build.check(lib, err, "sec_attention_qkv_out")
    QKV_OUT_COUNT.launches += 1
    return out
