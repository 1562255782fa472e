"""Flash attention of the ``attn_impl='auto'`` path at ``Tq * Tk >= 2^22``
(port of ``mixdq_tpu/ops/pallas_attention.py:flash_attention`` and the
``mha`` wrapper that feeds it).

``flash_attention`` reads q/k/v at column offsets of their sources (the
fused ``to_qkv`` output at 0/C/2C, or three projections) and writes
``[B, Tq, heads * head_dim]`` in q's dtype for ``to_out``; ``mha``'s
head-major copies are not ported. The three flash kernels take the head
dims ``FLASH_HEAD_DIMS``: the TPU kernels zero-pad any d to 128 lanes;
these pad 40 / 80 / 160 (SD1.5) to the mma's depth in shared memory and
write d columns. Kernel: ``csrc/flash_attention.cu``.
Plain version: ``flash_attention_plain``, a step-by-step copy of the
online softmax of the TPU kernel.

The rounding of ``p`` to v's dtype is relative to the running max of the
key blocks seen so far, so the result depends on the key partition:
kernel and plain version keep ``mha``'s (``flash_block_keys``: 1024
keys, clipped to ``Tk`` rounded up to 128); the plain version also
takes another block size as ``bk``.

``int8_flash_attention`` and ``int8qkv_flash_attention`` (ports of
``int8_mha`` and ``int8qkv_mha``) take the same panels, quantize q and k
(and v) with ``quantize_sym_dynamic`` (plain PyTorch ops, as the JAX
package leaves them to XLA) and call ``int8_flash_codes`` (port of the
Pallas ``int8_flash_attention`` / ``int8qkv_flash_attention``), which
runs the online softmax with int8 QK^T (and int8 PV on ``p``
re-quantized to ``round(127 p)``). Its key blocks are the JAX wrappers'
``bk = 512`` (``int8_block_keys``) in kernel and plain version alike:
the codes of ``p`` depend on the running max. Kernels:
``csrc/int8_flash.cu``, under ``int8_flash_plan``. Plain versions:
``int8_flash_codes_plain`` and, with the quantize,
``int8_flash_attention_plain`` / ``int8qkv_flash_attention_plain``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import _build, check_cuda_args, register, use_kernel
from .sec_attention import _panel_ptr, check_panels

FLASH_COUNT = register("flash_attention")
INT8_COUNT = register("int8_flash_attention")
INT8QKV_COUNT = register("int8qkv_flash_attention")

#: the TPU kernel's running max before the first key block and the logit
#: of a masked key (``pallas_attention.py:32``)
MASKED = -1e30

#: head dims the three flash kernels are built for: the powers of two of
#: the ``sec_attention*`` kernels and SD1.5's 40 / 80 / 160 (8 heads at
#: 320 / 640 / 1280 channels), which the kernels pad to the mma's depth
#: (the TPU kernels zero-pad any d to 128 lanes)
FLASH_HEAD_DIMS = (16, 32, 40, 64, 80, 128, 160)


def check_flash_head_dim(head_dim: int) -> None:
    if head_dim not in FLASH_HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim}: the flash kernels take "
                         f"{FLASH_HEAD_DIMS}")


def flash_block_keys(Tk: int) -> int:
    """Keys per block of the bf16/f32 flash kernel: ``mha``'s 1024, clipped
    to ``Tk`` rounded up to 128 (``pallas_attention.py:96``, ``:135``)."""
    return min(1024, -(-Tk // 128) * 128)


def flash_attention_plain(q_src, k_src, v_src, *, heads: int, head_dim: int,
                          scale: float, q_off: int = 0, k_off: int = 0,
                          v_off: int = 0, bk: Optional[int] = None):
    """Online softmax over key blocks of ``bk`` (default:
    ``flash_block_keys``), per head: f32 logits scaled after the dot, ``alpha = exp(m - m')``,
    ``l = l alpha + sum p`` from the f32 ``p``, ``acc = acc alpha +
    p.astype(v.dtype) . v`` in f32, then ``acc / l`` in q's dtype. A
    ragged last block is sliced where the TPU pads and masks it; its
    masked keys add nothing."""
    d, C = head_dim, heads * head_dim
    B, Tq = q_src.shape[:2]
    Tk = k_src.shape[1]
    bk = bk or flash_block_keys(Tk)

    def per_head(src, off, T):  # [B, heads, T, d]
        return src[..., off:off + C].reshape(B, T, heads, d).transpose(1, 2)

    q = per_head(q_src, q_off, Tq).float()
    k = per_head(k_src, k_off, Tk).float()
    v = per_head(v_src, v_off, Tk)
    m = torch.full((B, heads, Tq, 1), MASKED, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, heads, Tq, d), device=q.device)
    for j0 in range(0, Tk, bk):
        s = q @ k[:, :, j0:j0 + bk].transpose(-1, -2)
        s = s * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        acc = acc * alpha + p.to(v.dtype).float() @ v[:, :, j0:j0 + bk].float()
    out = (acc / l).to(q_src.dtype)
    return out.transpose(1, 2).reshape(B, Tq, C)


def _lib():
    lib = _build.load("flash_attention.cu")
    if lib.mixdq_flash_attention.argtypes is None:
        P, I, F = _build.P, _build.I, _build.F
        lib.mixdq_flash_attention.argtypes = [P] * 4 + [I] * 10 + [F, P]
        lib.mixdq_flash_attention.restype = I
    return lib


def _int8_lib():
    lib = _build.load("int8_flash.cu")
    if lib.mixdq_int8_flash_attention.argtypes is None:
        P, I = _build.P, _build.I
        lib.mixdq_int8_flash_attention.argtypes = (
            [P] * 4 + [I] * 10 + [P] * 2 + [I] * 7 + [P])
        lib.mixdq_int8_flash_attention.restype = I
    return lib


def flash_attention(q_src: torch.Tensor, k_src: torch.Tensor,
                    v_src: torch.Tensor, *, heads: int, head_dim: int,
                    scale: float, q_off: int = 0, k_off: int = 0,
                    v_off: int = 0) -> torch.Tensor:
    """Softmax attention over q ``[B, Tq, >= q_off + C]`` and k/v ``[B,
    Tk, >= off + C]`` read at their column offsets (bf16 or f32, one
    dtype) -> ``[B, Tq, C]`` in that dtype, C = heads * head_dim."""
    FLASH_COUNT.calls += 1
    check_flash_head_dim(head_dim)
    if not use_kernel(q_src, k_src, v_src):
        return flash_attention_plain(
            q_src, k_src, v_src, heads=heads, head_dim=head_dim, scale=scale,
            q_off=q_off, k_off=k_off, v_off=v_off)
    C = heads * head_dim
    dt = check_panels("flash_attention", C, (q_src, q_off), (k_src, k_off),
                      (v_src, v_off))
    B, Tq = q_src.shape[:2]
    Tk = k_src.shape[1]
    if k_src.shape[0] != B or v_src.shape[:2] != (B, Tk):
        raise ValueError("flash_attention: q/k/v batch or key counts differ")
    out = torch.empty((B, Tq, C), dtype=dt, device=q_src.device)
    lib = _lib()
    err = lib.mixdq_flash_attention(
        _panel_ptr(q_src, q_off), _panel_ptr(k_src, k_off),
        _panel_ptr(v_src, v_off), _build.ptr(out), q_src.shape[-1],
        k_src.shape[-1], v_src.shape[-1], B, Tq, Tk, heads, head_dim,
        flash_block_keys(Tk), int(dt == torch.bfloat16), scale,
        _build.stream(q_src.device))
    _build.check(lib, err, "flash_attention")
    FLASH_COUNT.launches += 1
    return out


def quantize_sym_dynamic(x: torch.Tensor, group=None):
    """Per-tensor symmetric int8 codes of ``x`` and their f32 scale
    (``pallas_attention.py:382-389``): ``s = max |x| / 127 + 1e-12`` over
    the whole tensor, codes ``round(x / s)`` (half to even) clipped to
    +-127. ``group``: the process group over which the batch is sharded;
    the max is then all-reduced over it (the whole batch's)."""
    xf = x.float()
    amax = xf.abs().amax()
    if group is not None:
        import torch.distributed as dist

        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    s = amax / 127.0 + 1e-12
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def int8_block_keys(Tk: int) -> int:
    """Keys per block of the int8 flash kernels: the JAX wrappers' 512,
    clipped to ``Tk`` rounded up to 128 (``pallas_attention.py:217``)."""
    return min(512, -(-Tk // 128) * 128)


#: the int8 flash kernels' block (query rows, a warp per 16), ring depth
#: and keys a ring stage, one m16n8k32 step (``csrc/int8_flash.cu``:
#: I8_ROWS, I8_STAGES; ``csrc/attn_mma.cuh``: KCH)
INT8_FLASH_ROWS = 64
INT8_FLASH_STAGES = 4
INT8_FLASH_STAGE_KEYS = 32
#: blocks an SM each build is made for, by head dim: (bf16 v, int8 v)
#: (``I8Stage::MIN_BLOCKS``)
INT8_FLASH_BLOCKS = {16: (5, 5), 32: (5, 5), 40: (4, 4), 64: (5, 4),
                     80: (4, 3), 128: (2, 2), 160: (2, 2)}


@dataclasses.dataclass(frozen=True)
class Int8FlashPlan:
    """One int8 flash launch's block and key ring: ``rows`` query rows a
    block of ``threads``; ``stages`` ring stages of ``stage_keys`` keys,
    each ``stage_bytes`` (k code rows of ``int8_flash_depths(d)[0] + 16``
    bytes, then v rows: codes at the same stride, or bf16 of
    ``int8_flash_depths(d)[1] + 8`` elements);
    ``ring_bytes`` of dynamic shared memory; ``blocks_per_sm`` the build's
    launch bound. f32 v keeps the scalar path (64-row blocks of 128
    threads, no ring) under the bf16-v plan of its ``d``."""
    rows: int
    threads: int
    stages: int
    stage_keys: int
    stage_bytes: int
    ring_bytes: int
    blocks_per_sm: int


def int8_flash_depths(d: int):
    """(QK^T depth, PV depth) of the int8 flash kernels at head dim ``d``:
    ``d`` padded to the m16n8k32 step (32) and to 16 (``I8Stage::DP`` /
    ``DV``); the pads are zero in every ring stage."""
    return -(-d // 32) * 32, -(-d // 16) * 16


def int8_flash_plan(d: int, int8_v: bool) -> Int8FlashPlan:
    """The plan of the int8 flash kernel at head dim ``d`` with int8 v
    codes (``int8qkv_flash_attention``) or bf16 v; the C launcher refuses
    any other."""
    check_flash_head_dim(d)
    keys = INT8_FLASH_STAGE_KEYS
    dp, dv = int8_flash_depths(d)
    ldk = dp + 16
    stage = keys * (ldk + (ldk if int8_v else (dv + 8) * 2))
    return Int8FlashPlan(INT8_FLASH_ROWS, INT8_FLASH_ROWS // 16 * 32,
                         INT8_FLASH_STAGES, keys, stage,
                         INT8_FLASH_STAGES * stage,
                         INT8_FLASH_BLOCKS[d][int(int8_v)])


def s8_slot(q: int) -> int:
    """The k slot of local key ``q`` (0..31) of a 32-key step in the s8 A
    fragment of ``p`` built from the logits' accumulator layout (tile
    ``q // 8`` holds keys 2t, 2t+1 of a lane): mirror of
    ``csrc/int8_flash.cu:s8_slot``."""
    nt, w = q >> 3, q & 7
    return (nt >> 1) * 16 + (w >> 1) * 4 + (nt & 1) * 2 + (w & 1)


def _int8_operands(q_src, k_src, v_src, heads, head_dim, q_off, k_off, v_off,
                   int8_v, group=None):
    """Codes of q and k (and of v with ``int8_v``) and the scales, as
    ``int8_mha`` / ``int8qkv_mha`` make them: (q codes, k codes, v codes
    or None, s_q * s_k, s_v or None); ``group``: ``quantize_sym_dynamic``'s."""
    C = heads * head_dim
    qi, sq = quantize_sym_dynamic(q_src[..., q_off:q_off + C], group)
    ki, sk = quantize_sym_dynamic(k_src[..., k_off:k_off + C], group)
    vi, sv = (quantize_sym_dynamic(v_src[..., v_off:v_off + C], group)
              if int8_v else (None, None))
    return qi, ki, vi, sq * sk, sv


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def int8_flash_codes_plain(qi, ki, v_src, logit_scale, v_scale=None, *,
                           heads: int, head_dim: int, v_off: int = 0,
                           out_dtype=None, bk: Optional[int] = None):
    """The online softmax of ``_int8_flash_kernel`` (``v_scale`` None: the
    float v panel of ``v_src`` at ``v_off``, ``p`` cast to its dtype) or
    ``_int8qkv_flash_kernel`` (``v_src`` the v codes, ``p`` as ``round(127
    p)``, PV times ``v_scale / 127``) over key blocks of ``bk`` (default
    ``int8_block_keys``). The int32 products run in f32, exactly: every
    partial sum is an integer below 2^24."""
    B, Tq, C = qi.shape
    Tk, d = ki.shape[1], head_dim
    bk = bk or int8_block_keys(Tk)
    v = v_src[..., v_off:v_off + C]
    out_dtype = out_dtype or v.dtype
    ls = _f32(logit_scale)
    vs = None if v_scale is None else _f32(v_scale) / 127.0

    def per_head(t, T):  # [B, heads, T, d]
        return t.reshape(B, T, heads, d).transpose(1, 2)

    q, k = per_head(qi, Tq).float(), per_head(ki, Tk).float()
    vh = per_head(v, Tk)
    m = torch.full((B, heads, Tq, 1), MASKED, device=qi.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, heads, Tq, d), device=qi.device)
    for j0 in range(0, Tk, bk):
        s = (q @ k[:, :, j0:j0 + bk].transpose(-1, -2)) * ls
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        vb = vh[:, :, j0:j0 + bk]
        if vs is None:
            pv = p.to(vb.dtype).float() @ vb.float()
        else:
            pv = (torch.round(p * 127.0) @ vb.float()) * vs
        acc = acc * alpha + pv
    out = (acc / l).to(out_dtype)
    return out.transpose(1, 2).reshape(B, Tq, C)


def int8_flash_codes(qi: torch.Tensor, ki: torch.Tensor,
                     v_src: torch.Tensor, logit_scale, v_scale=None, *,
                     heads: int, head_dim: int, v_off: int = 0,
                     out_dtype=None) -> torch.Tensor:
    """The int8 flash kernels on codes (ports of the Pallas
    ``int8_flash_attention`` / ``int8qkv_flash_attention``): q codes
    ``[B, Tq, C]`` and k codes ``[B, Tk, C]`` (contiguous int8), the
    logit scale ``s_q * s_k * softmax scale``; with ``v_scale`` None
    (``int8_flash_attention``) the float v panel of ``v_src`` ``[B, Tk,
    >= v_off + C]``, read in place, and the output in its dtype; with
    ``v_scale`` = ``s_v`` (``int8qkv_flash_attention``) ``v_src`` the v
    codes ``[B, Tk, C]`` and the output in ``out_dtype`` (bf16 or f32)."""
    int8_v = v_scale is not None
    count = INT8QKV_COUNT if int8_v else INT8_COUNT
    count.calls += 1
    check_flash_head_dim(head_dim)
    if not use_kernel(qi, ki, v_src):
        return int8_flash_codes_plain(
            qi, ki, v_src, logit_scale, v_scale, heads=heads,
            head_dim=head_dim, v_off=v_off, out_dtype=out_dtype)
    name = count.name
    C = heads * head_dim
    B, Tq = qi.shape[:2]
    Tk = ki.shape[1]
    if (qi.dtype != torch.int8 or ki.dtype != torch.int8 or qi.shape[2] != C
            or ki.shape != (B, Tk, C)):
        raise ValueError(f"{name}: q/k must be int8 codes [B, T, {C}]")
    check_cuda_args(name, q=qi, k=ki)
    if int8_v:
        if v_src.dtype != torch.int8 or v_src.shape != (B, Tk, C) or v_off:
            raise ValueError(f"{name}: v must be int8 codes [B, Tk, {C}]")
        check_cuda_args(name, v=v_src)
        out_dtype = out_dtype or torch.bfloat16
        v_ptr, ldv, v_bf16 = _build.ptr(v_src), C, 0
    else:
        dt = check_panels(name, C, (v_src, v_off))
        if v_src.shape[:2] != (B, Tk) or (out_dtype or dt) != dt:
            raise ValueError(f"{name}: v [B, Tk, ...] of the output dtype")
        out_dtype = dt
        v_ptr, ldv = _panel_ptr(v_src, v_off), v_src.shape[-1]
        v_bf16 = int(dt == torch.bfloat16)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: out_dtype {out_dtype}")
    # the scales stay on the device: reading them here would wait for the
    # quantize that made them
    dev = qi.device
    ls = _f32(logit_scale).to(dev).reshape(1)
    vs = (_f32(v_scale).to(dev) / 127.0).reshape(1) if int8_v else None
    out = torch.empty((B, Tq, C), dtype=out_dtype, device=dev)
    plan = int8_flash_plan(head_dim, int8_v)
    lib = _int8_lib()
    err = lib.mixdq_int8_flash_attention(
        _build.ptr(qi), _build.ptr(ki), v_ptr, _build.ptr(out), ldv, B, Tq,
        Tk, heads, head_dim, int8_block_keys(Tk), int(int8_v), v_bf16,
        int(out_dtype == torch.bfloat16), _build.ptr(ls), _build.ptr(vs),
        *dataclasses.astuple(plan), _build.stream(dev))
    _build.check(lib, err, name)
    count.launches += 1
    return out


def int8_flash_attention_plain(q_src, k_src, v_src, *, heads: int,
                               head_dim: int, scale: float, q_off: int = 0,
                               k_off: int = 0, v_off: int = 0,
                               out_dtype=None, bk: Optional[int] = None,
                               group=None):
    qi, ki, _, s_qk, _ = _int8_operands(q_src, k_src, v_src, heads,
                                        head_dim, q_off, k_off, v_off, False,
                                        group)
    return int8_flash_codes_plain(qi, ki, v_src, s_qk * scale, heads=heads,
                                  head_dim=head_dim, v_off=v_off,
                                  out_dtype=out_dtype, bk=bk)


def int8qkv_flash_attention_plain(q_src, k_src, v_src, *, heads: int,
                                  head_dim: int, scale: float, q_off: int = 0,
                                  k_off: int = 0, v_off: int = 0,
                                  out_dtype=None, bk: Optional[int] = None,
                                  group=None):
    qi, ki, vi, s_qk, sv = _int8_operands(q_src, k_src, v_src, heads,
                                          head_dim, q_off, k_off, v_off, True,
                                          group)
    return int8_flash_codes_plain(qi, ki, vi, s_qk * scale, sv, heads=heads,
                                  head_dim=head_dim,
                                  out_dtype=out_dtype or v_src.dtype, bk=bk)


def int8_flash_attention(q_src: torch.Tensor, k_src: torch.Tensor,
                         v_src: torch.Tensor, *, heads: int, head_dim: int,
                         scale: float, q_off: int = 0, k_off: int = 0,
                         v_off: int = 0, out_dtype=None,
                         group=None) -> torch.Tensor:
    """``int8_mha``: flash attention with QK^T on int8 codes of q and k
    (per-tensor symmetric, from ``quantize_sym_dynamic``; ``group``: the
    process group of a sharded batch, whose max the scales take) and PV
    on ``p`` cast to v's dtype, over the panels ``flash_attention`` takes
    -> ``[B, Tq, C]`` in v's dtype (``out_dtype``, if given, must be
    it)."""
    qi, ki, _, s_qk, _ = _int8_operands(q_src, k_src, v_src, heads,
                                        head_dim, q_off, k_off, v_off, False,
                                        group)
    return int8_flash_codes(qi, ki, v_src, s_qk * scale, heads=heads,
                            head_dim=head_dim, v_off=v_off,
                            out_dtype=out_dtype)


def int8qkv_flash_attention(q_src: torch.Tensor, k_src: torch.Tensor,
                            v_src: torch.Tensor, *, heads: int,
                            head_dim: int, scale: float, q_off: int = 0,
                            k_off: int = 0, v_off: int = 0,
                            out_dtype=None, group=None) -> torch.Tensor:
    """``int8qkv_mha``: as ``int8_flash_attention`` with v as int8 codes
    too and PV on ``round(127 p)`` in int8 -> ``[B, Tq, C]`` in
    ``out_dtype`` (default: v's dtype; bf16 or f32)."""
    qi, ki, vi, s_qk, sv = _int8_operands(q_src, k_src, v_src, heads,
                                          head_dim, q_off, k_off, v_off, True,
                                          group)
    return int8_flash_codes(qi, ki, vi, s_qk * scale, sv, heads=heads,
                            head_dim=head_dim,
                            out_dtype=out_dtype or v_src.dtype)
