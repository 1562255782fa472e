"""Attention / transformer blocks (port of ``mixdq_tpu/models/attention.py``
on its ``attn_impl='einsum'`` path).

On the int8 path the pre-LayerNorm of a dense consumer is DEFERRED: the
block passes the raw residual stream plus ``(gamma, beta, entry)`` and the
sub-module turns it into the consumer's int8 codes with ``ln_quantize``.
Attention projections run through fused QKV (self) / KV (cross) deploy
entries when ``ctx.fuse_qkv``; cross-attention k/v keep the first (BoS)
text token on the FP dequantized-weight path when ``ctx.bos_aware``.
The attention math is a matmul + f32 softmax chain.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.gn_quant import gn_silu_quantize
from ..ops.ln_quant import ln_quantize
from ..ops.qmatmul import gelu
from ..ops.qops import act_clip_range
from ..quant.state import FP_CTX, QuantCtx
from .layers import (GroupNorm, LayerNorm, QDense, bos_row, deploy_linear,
                     name_layers)


def deploy_res_add(residual: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Residual add in the model dtype (the JAX package pins it there with
    an optimization barrier; eager PyTorch adds in the operands' dtype)."""
    return residual + delta


def materialize_ln_codes(x: torch.Tensor, ln) -> torch.Tensor:
    """The deferred pre-LayerNorm + consumer act-quantize."""
    norm, dp = ln
    return ln_quantize(x, norm.weight, norm.bias, dp.scale_inv,
                       dp.zp_shifted, eps=norm.eps,
                       clip=act_clip_range(dp.a_bits))


def fused_entry(ctx: QuantCtx, name: Optional[str], kind: str = "linear"):
    """The deploy entry of ``name`` if its norm producer can emit its
    codes (int8 mode, act-quantized entry of ``kind``)."""
    if name is None:
        return None
    dp = ctx.entry(name)
    if dp is None or dp.kind != kind or dp.scale_inv is None:
        return None
    return dp


def geglu_fusable(ctx: QuantCtx, dp_p, dp_c) -> bool:
    """Whether proj GEMM + gate + the consumer's act-quantize run as one
    ``geglu_qmatmul``: plain int8 linear entries on both sides."""
    return (dp_p is not None and dp_p.kind == "linear"
            and dp_p.w_int is not None
            and dp_c is not None and dp_c.kind == "linear"
            and dp_c.scale_inv is not None)


class Attention(nn.Module):
    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 cross_attention_dim: Optional[int] = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.heads, self.head_dim, self.dtype = heads, head_dim, dtype
        inner = heads * head_dim
        kv_dim = cross_attention_dim or query_dim
        kw = dict(dtype=dtype, device=device)
        self.to_q = QDense(query_dim, inner, use_bias=False, **kw)
        self.to_k = QDense(kv_dim, inner, use_bias=False, **kw)
        self.to_v = QDense(kv_dim, inner, use_bias=False, **kw)
        self.to_out = nn.ModuleList([QDense(inner, query_dim, **kw)])

    def forward(self, hidden_states, encoder_hidden_states=None,
                ctx: QuantCtx = FP_CTX, residual=None, ln=None):
        """``residual``: when given, returns ``residual + attention``.
        ``ln`` = (LayerNorm module, consumer entry): ``hidden_states`` is
        the raw stream and the LN + act-quantize still has to run."""
        inner = self.heads * self.head_dim
        is_cross = encoder_hidden_states is not None
        kv_input = encoder_hidden_states if is_cross else hidden_states
        base = self.qname
        dp_f = (ctx.entry(base + (".to_kv" if is_cross else ".to_qkv"))
                if ctx.fuse_qkv else None)
        if dp_f is not None:
            if not is_cross and ln is not None:
                kv_input = hidden_states = materialize_ln_codes(
                    hidden_states, ln)
                ln = None
            y = deploy_linear(kv_input, dp_f, self.dtype)
            if is_cross and ctx.bos_aware and kv_input.ndim >= 3:
                y = torch.cat([bos_row(kv_input.to(self.dtype), dp_f,
                                       self.dtype), y[..., 1:, :]], -2)
            if is_cross:
                if ln is not None:
                    hidden_states = materialize_ln_codes(hidden_states, ln)
                q = self.to_q(hidden_states, ctx)
                k, v = y.split(inner, -1)
            else:
                q, k, v = y.split(inner, -1)
        else:
            if ln is not None:
                hidden_states = materialize_ln_codes(hidden_states, ln)
                if not is_cross:
                    kv_input = hidden_states
            q = self.to_q(hidden_states, ctx)
            k = self.to_k(kv_input, ctx, bos_aware=is_cross)
            v = self.to_v(kv_input, ctx, bos_aware=is_cross)

        B, Tq, _ = q.shape
        Tk = k.shape[1]
        qh = q.reshape(B, Tq, self.heads, self.head_dim).transpose(1, 2)
        kh = k.reshape(B, Tk, self.heads, self.head_dim).transpose(1, 2)
        vh = v.reshape(B, Tk, self.heads, self.head_dim).transpose(1, 2)
        logits = (qh @ kh.transpose(-1, -2)) * self.head_dim ** -0.5
        probs = torch.softmax(logits.float(), dim=-1).to(self.dtype)
        out = (probs @ vh).transpose(1, 2).reshape(B, Tq, inner)
        out = self.to_out[0](out, ctx)
        return out if residual is None else deploy_res_add(residual, out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner_dim: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.proj = QDense(dim, inner_dim * 2, dtype=dtype, device=device)

    def forward(self, x, ctx: QuantCtx = FP_CTX, consumer_dp=None):
        """``consumer_dp``: the ``ff.net.2`` entry; when the fused kernel
        applies, returns that consumer's int8 codes ``[..., inner]``."""
        if consumer_dp is not None and geglu_fusable(
                ctx, ctx.entry(self.proj.qname), consumer_dp):
            return self.proj(x, ctx, geglu_out=consumer_dp)
        h, gate = self.proj(x, ctx).chunk(2, -1)
        return (h.float() * gelu(gate.float(), ctx.gelu == "tanh")).to(
            self.dtype)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32,
                 device=None):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([
            GEGLU(dim, inner, dtype=dtype, device=device), nn.Identity(),
            QDense(inner, dim, dtype=dtype, device=device)])

    def forward(self, x, ctx: QuantCtx = FP_CTX, residual=None, ln=None):
        if ln is not None:
            x = materialize_ln_codes(x, ln)
        x = self.net[0](x, ctx, consumer_dp=ctx.entry(self.net[2].qname))
        x = self.net[2](x, ctx)
        return x if residual is None else deploy_res_add(residual, x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int,
                 cross_attention_dim: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = LayerNorm(dim, **kw)
        self.attn1 = Attention(dim, heads, head_dim, **kw)
        self.norm2 = LayerNorm(dim, **kw)
        self.attn2 = Attention(dim, heads, head_dim,
                               cross_attention_dim=cross_attention_dim, **kw)
        self.norm3 = LayerNorm(dim, **kw)
        self.ff = FeedForward(dim, **kw)

    def _ln(self, x, norm: LayerNorm, consumer: Optional[str], ctx):
        """Plain LayerNorm, or deferred (raw input + (norm, entry)) when
        the consumer is an int8 entry that takes codes."""
        dp = fused_entry(ctx, consumer)
        if dp is not None:
            return x, (norm, dp)
        return norm(x), None

    def forward(self, hidden_states, encoder_hidden_states,
                ctx: QuantCtx = FP_CTX):
        base = self.qname
        h, ln1 = self._ln(hidden_states, self.norm1,
                          f"{base}.attn1.to_qkv" if ctx.fuse_qkv else None,
                          ctx)
        hidden_states = self.attn1(h, None, ctx, residual=hidden_states,
                                   ln=ln1)
        h, ln2 = self._ln(hidden_states, self.norm2, f"{base}.attn2.to_q",
                          ctx)
        hidden_states = self.attn2(h, encoder_hidden_states, ctx,
                                   residual=hidden_states, ln=ln2)
        h, ln3 = self._ln(hidden_states, self.norm3, f"{base}.ff.net.0.proj",
                          ctx)
        return self.ff(h, ctx, residual=hidden_states, ln=ln3)


class Transformer2DModel(nn.Module):
    """Spatial transformer with linear ``proj_in``/``proj_out`` (the SDXL
    form): NHWC map -> tokens -> blocks -> map, plus the input."""

    def __init__(self, in_channels: int, heads: int, head_dim: int,
                 num_layers: int, cross_attention_dim: int,
                 use_linear_projection: bool = True,
                 norm_num_groups: int = 32, dtype=torch.float32,
                 device=None):
        super().__init__()
        if not use_linear_projection:
            raise NotImplementedError("conv proj_in/out (SD1.5) is not "
                                      "ported")
        kw = dict(dtype=dtype, device=device)
        inner = heads * head_dim
        self.in_channels, self.dtype = in_channels, dtype
        self.norm = GroupNorm(norm_num_groups, in_channels, 1e-6, **kw)
        self.proj_in = QDense(in_channels, inner, **kw)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(inner, heads, head_dim,
                                  cross_attention_dim, **kw)
            for _ in range(num_layers)])
        self.proj_out = QDense(inner, in_channels, **kw)
        name_layers(self)

    def forward(self, hidden_states, encoder_hidden_states,
                ctx: QuantCtx = FP_CTX):
        B, H, W, C = hidden_states.shape
        dp_in = fused_entry(ctx, self.proj_in.qname)
        if dp_in is not None:
            h = gn_silu_quantize(hidden_states, self.norm.weight,
                                 self.norm.bias, dp_in.scale_inv,
                                 dp_in.zp_shifted,
                                 groups=self.norm.num_groups,
                                 eps=self.norm.eps, silu=False,
                                 clip=act_clip_range(dp_in.a_bits))
        else:
            h = self.norm(hidden_states)
        h = self.proj_in(h.reshape(B, H * W, C), ctx)
        for blk in self.transformer_blocks:
            h = blk(h, encoder_hidden_states, ctx)
        h = self.proj_out(h, ctx).reshape(B, H, W, self.in_channels)
        return deploy_res_add(hidden_states, h)
