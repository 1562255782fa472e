"""Flash attention of the ``attn_impl='auto'`` path at ``Tq * Tk >= 2^22``
(port of ``mixdq_tpu/ops/pallas_attention.py:flash_attention`` and the
``mha`` wrapper that feeds it).

``flash_attention`` reads q/k/v at column offsets of their sources (the
fused ``to_qkv`` output at 0/C/2C, or three projections) and writes
``[B, Tq, heads * head_dim]`` in q's dtype for ``to_out``; ``mha``'s
head-major copies are not ported. Kernel: ``csrc/flash_attention.cu``.
Plain version: ``flash_attention_plain``, a step-by-step copy of the
online softmax of the TPU kernel.

The rounding of ``p`` to v's dtype is relative to the running max of the
key blocks seen so far, so the result depends on the key block size:
the kernel's is ``flash_block_keys(head_dim)``, and the plain version
takes it as ``bk``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, register, use_kernel
from .sec_attention import _panel_ptr, check_head_dim, check_panels

FLASH_COUNT = register("flash_attention")

#: the TPU kernel's running max before the first key block and the logit
#: of a masked key (``pallas_attention.py:32``)
MASKED = -1e30


def flash_block_keys(head_dim: int) -> int:
    """Keys per block of the kernel (its shared-memory chunk)."""
    return 64 if head_dim <= 64 else 32


def flash_attention_plain(q_src, k_src, v_src, *, heads: int, head_dim: int,
                          scale: float, q_off: int = 0, k_off: int = 0,
                          v_off: int = 0, bk: Optional[int] = None):
    """Online softmax over key blocks of ``bk`` (default: the kernel's),
    per head: f32 logits scaled after the dot, ``alpha = exp(m - m')``,
    ``l = l alpha + sum p`` from the f32 ``p``, ``acc = acc alpha +
    p.astype(v.dtype) . v`` in f32, then ``acc / l`` in q's dtype. A
    ragged last block is sliced where the TPU pads and masks it; its
    masked keys add nothing."""
    d, C = head_dim, heads * head_dim
    bk = bk or flash_block_keys(d)
    B, Tq = q_src.shape[:2]
    Tk = k_src.shape[1]

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
        lib.mixdq_flash_attention.argtypes = [P] * 4 + [I] * 9 + [F, P]
        lib.mixdq_flash_attention.restype = I
    return lib


def flash_attention(q_src: torch.Tensor, k_src: torch.Tensor,
                    v_src: torch.Tensor, *, heads: int, head_dim: int,
                    scale: float, q_off: int = 0, k_off: int = 0,
                    v_off: int = 0) -> torch.Tensor:
    """Softmax attention over q ``[B, Tq, >= q_off + C]`` and k/v ``[B,
    Tk, >= off + C]`` read at their column offsets (bf16 or f32, one
    dtype) -> ``[B, Tq, C]`` in that dtype, C = heads * head_dim."""
    FLASH_COUNT.calls += 1
    check_head_dim(head_dim)
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
        int(dt == torch.bfloat16), scale, _build.stream(q_src.device))
    _build.check(lib, err, "flash_attention")
    FLASH_COUNT.launches += 1
    return out
