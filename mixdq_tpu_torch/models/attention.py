"""Attention / transformer blocks (port of ``mixdq_tpu/models/attention.py``
on its ``attn_impl='einsum'`` and ``'auto'`` paths).

On the int8 path the pre-LayerNorm of a dense consumer is DEFERRED: the
block passes the raw residual stream plus ``(gamma, beta, entry)`` and the
sub-module turns it into the consumer's int8 codes with ``ln_quantize``.
Attention projections run through fused QKV (self) / KV (cross) deploy
entries when ``ctx.fuse_qkv``; cross-attention k/v keep the first (BoS)
text token on the FP dequantized-weight path when ``ctx.bos_aware``.
Under ``'einsum'`` the attention math is a matmul + f32 softmax chain.
Under ``'auto'`` each site runs the kernel the JAX package picks for its
shape and the context's kernel options (``routing.attention_route``):
``sec_attention_qkv_out`` (attn1 in ``ctx.out_fuse``),
``sec_attention_qkv`` or ``sec_attention`` after the fused QKV GEMM, or
flash attention at ``Tq * Tk >= 2^22`` (int8 flash attention at int8
sites under ``ctx.int8_flash``), for self-attention;
``sec_attention_q_out`` (attn2 in ``ctx.out_fuse``), ``sec_attention_q``
or ``to_q`` + ``sec_attention`` for cross-attention. The feed-forward
runs ``geglu_out_qmatmul`` where ff is in ``ctx.out_fuse`` and its gate
holds (``routing.whole_ff``), else ``geglu_qmatmul`` and ``ff.net.2``.
With ``ctx.ln_fold`` off, the block materializes every deferred
LayerNorm's codes itself and the sub-modules get codes plus the raw
residual.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.gn_quant import gn_silu_quantize
from ..ops.ln_quant import ln_quantize
from ..ops.qmatmul import geglu_out_qmatmul, gelu
from ..ops.qops import act_clip_range
from ..ops.attention import (flash_attention, int8_flash_attention,
                             int8qkv_flash_attention)
from ..ops.sec_attention import (sec_attention, sec_attention_q,
                                 sec_attention_q_out, sec_attention_qkv,
                                 sec_attention_qkv_out)
from ..quant.state import FP_CTX, QuantCtx
from . import routing
from .layers import (GroupNorm, LayerNorm, QDense, bos_row, codes_of,
                     deploy_linear, layer_compute, name_layers)


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


def ln_fold_args(ln):
    """(gamma, beta, x_scale_inv, x_zp_shifted, x_clip, eps) of a deferred
    LayerNorm, for ``sec_attention_q_out``'s LN-folded mode."""
    norm, dp = ln
    return (norm.weight, norm.bias, dp.scale_inv, dp.zp_shifted,
            act_clip_range(dp.a_bits), norm.eps)


def fused_entry(ctx: QuantCtx, name: Optional[str], kind: str = "linear"):
    """The deploy entry of ``name`` if its norm producer can emit its
    codes (``int8_sec`` compute, act-quantized entry of ``kind``; the JAX
    package's ``fused_ln_entry`` / ``fused_gn_entry``)."""
    if name is None or ctx.deploy_compute != "int8_sec":
        return None
    dp = ctx.entry(name)
    if (dp is None or dp.kind != kind or dp.scale_inv is None
            or dp.act_off):
        return None
    return dp


def geglu_fusable(compute: str, dp_p, dp_c) -> bool:
    """Whether proj GEMM + gate + the consumer's act-quantize run as one
    ``geglu_qmatmul``: ``int8_sec`` compute, act-quantized int8 linear
    entries on both sides, the proj's codes unpacked."""
    return (compute == "int8_sec" and routing.act_entry(dp_p)
            and dp_p.w_int is not None and routing.act_entry(dp_c))


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
        the raw stream and the LN + act-quantize still has to run. The
        kernel of the site is ``routing.attention_route``'s choice; the
        deferred LayerNorm materializes where the JAX package's does."""
        is_cross = encoder_hidden_states is not None
        kv_input = encoder_hidden_states if is_cross else hidden_states
        dp_f = (ctx.entry(self.qname + (".to_kv" if is_cross else ".to_qkv"))
                if ctx.fuse_qkv else None)
        dp_q, dp_o = ctx.entry(self.to_q.qname), ctx.entry(self.to_out[0].qname)
        route = routing.attention_route(
            mode=ctx.mode, attn_impl=ctx.attn_impl, fused=dp_f is not None,
            cross=is_cross, heads=self.heads, head_dim=self.head_dim,
            Tq=hidden_states.shape[1], Tk=kv_input.shape[1],
            C_in=hidden_states.shape[-1],
            codes=ln is not None or hidden_states.dtype == torch.int8,
            out_entry=routing.act_entry(dp_o), q_entry=routing.act_entry(dp_q),
            compute=ctx.deploy_compute,
            fused_codes=dp_f is not None and dp_f.w_int is not None,
            q_codes=dp_q is not None and dp_q.w_int is not None,
            out_codes=dp_o is not None and dp_o.w_int is not None,
            out_fuse=ctx.out_fuse, int8_flash=ctx.int8_flash)
        if route.kernel == routing.QKV:
            return self._sec_self(hidden_states, ctx, residual, ln, dp_f)
        if route.kernel == routing.QKV_OUT:
            return self._sec_self_out(hidden_states, ctx, residual, ln, dp_f)
        if ln is not None and not (route.kernel == routing.Q_OUT
                                   or is_cross and dp_f is not None):
            # norm1 before the fused QKV GEMM, or any norm before the
            # unfused projections (attention.py:280-285, :404-409)
            hidden_states = materialize_ln_codes(hidden_states, ln)
            kv_input = kv_input if is_cross else hidden_states
            ln = None
        if dp_f is not None:
            compute = layer_compute(ctx.deploy_compute, dp_f)
            y = deploy_linear(kv_input, dp_f, compute, self.dtype)
            if (is_cross and compute == "int8" and ctx.bos_aware
                    and kv_input.ndim >= 3):
                y = torch.cat([bos_row(kv_input.to(self.dtype), dp_f,
                                       self.dtype), y[..., 1:, :]], -2)
            if route.kernel == routing.Q_OUT:
                return self._sec_cross(hidden_states, y, ctx, residual, ln)
            if is_cross:
                if ln is not None:  # attention.py:378-381, :396-398
                    hidden_states = materialize_ln_codes(hidden_states, ln)
                if route.kernel == routing.SEC_Q:
                    return self._finish(self._sec_q(hidden_states, y, ctx),
                                        ctx, residual)
                srcs = (self.to_q(hidden_states, ctx), y, y)
            else:
                srcs = (y, y, y)
        else:
            srcs = (self.to_q(hidden_states, ctx),
                    self.to_k(kv_input, ctx, bos_aware=is_cross),
                    self.to_v(kv_input, ctx, bos_aware=is_cross))
        kw = dict(heads=self.heads, head_dim=self.head_dim,
                  scale=self.head_dim ** -0.5, q_off=route.offsets[0],
                  k_off=route.offsets[1], v_off=route.offsets[2])
        if route.kernel == routing.SEC:
            dp_o = ctx.entry(self.to_out[0].qname)
            out = sec_attention(*srcs, dp_o.scale_inv, dp_o.zp_shifted,
                                clip=act_clip_range(dp_o.a_bits), **kw)
        elif route.kernel == routing.FLASH:
            out = flash_attention(*srcs, **kw).to(self.dtype)
        elif route.kernel in (routing.INT8_FLASH, routing.INT8QKV_FLASH):
            fn = (int8_flash_attention if route.kernel == routing.INT8_FLASH
                  else int8qkv_flash_attention)
            out = fn(*srcs, out_dtype=self.dtype, **kw)
        else:
            out = self._einsum(*srcs, route.offsets)
        return self._finish(out, ctx, residual)

    def _finish(self, out, ctx, residual):
        """``to_out``, then the residual add."""
        out = self.to_out[0](out, ctx)
        return out if residual is None else deploy_res_add(residual, out)

    def _einsum(self, q_src, k_src, v_src, offsets):
        """Matmul + f32 softmax chain over the q/k/v panels at
        ``offsets``."""
        inner = self.heads * self.head_dim
        q, k, v = (src[..., off:off + inner]
                   for src, off in zip((q_src, k_src, v_src), offsets))
        B, Tq, _ = q.shape
        Tk = k.shape[1]
        qh = q.reshape(B, Tq, self.heads, self.head_dim).transpose(1, 2)
        kh = k.reshape(B, Tk, self.heads, self.head_dim).transpose(1, 2)
        vh = v.reshape(B, Tk, self.heads, self.head_dim).transpose(1, 2)
        logits = (qh @ kh.transpose(-1, -2)) * self.head_dim ** -0.5
        probs = torch.softmax(logits.float(), dim=-1).to(self.dtype)
        return (probs @ vh).transpose(1, 2).reshape(B, Tq, inner)

    def _codes(self, x, dp):
        """``x`` as the act codes of entry ``dp`` (fp input in the model
        dtype first, as ``QDense`` does)."""
        return codes_of(x if x.dtype == torch.int8 else x.to(self.dtype), dp)

    def _sec_self(self, hidden_states, ctx, residual, ln, dp_f):
        """Self-attention: norm1 codes -> ``sec_attention_qkv`` -> to_out's
        codes -> ``to_out`` -> residual add."""
        codes = (materialize_ln_codes(hidden_states, ln) if ln is not None
                 else self._codes(hidden_states, dp_f))
        dp_o = ctx.entry(self.to_out[0].qname)
        codes = sec_attention_qkv(
            codes, dp_f.w_int, dp_f.scale, dp_f.bias0, dp_o.scale_inv,
            dp_o.zp_shifted, heads=self.heads, head_dim=self.head_dim,
            scale=self.head_dim ** -0.5, clip=act_clip_range(dp_o.a_bits))
        return self._finish(codes, ctx, residual)

    def _block_input(self, hidden_states, residual, ln, dp):
        """(x, fold, residual) of a whole-block kernel: LN-folded when the
        deferred LayerNorm's raw input is the residual, else the codes of
        entry ``dp`` plus the explicit residual."""
        if ln is not None and residual is hidden_states:
            return hidden_states.to(self.dtype), ln_fold_args(ln), None
        x = (materialize_ln_codes(hidden_states, ln) if ln is not None
             else self._codes(hidden_states, dp))
        return x, None, None if residual is None else residual.to(self.dtype)

    def _sec_self_out(self, hidden_states, ctx, residual, ln, dp_f):
        """Self-attention in one ``sec_attention_qkv_out``: the fused QKV
        GEMM, attention, ``to_out`` with its bias and the residual add."""
        dp_o = ctx.entry(self.to_out[0].qname)
        x, fold, residual = self._block_input(hidden_states, residual, ln,
                                              dp_f)
        return sec_attention_qkv_out(
            x, dp_f.w_int, dp_f.scale, dp_f.bias0, dp_o.scale_inv,
            dp_o.zp_shifted, dp_o.w_int, dp_o.scale, dp_o.bias0,
            self.to_out[0].bias, residual, heads=self.heads,
            head_dim=self.head_dim, scale=self.head_dim ** -0.5,
            out_dtype=self.dtype, clip=act_clip_range(dp_o.a_bits), ln=fold)

    def _sec_q(self, codes, y, ctx):
        """Cross-attention from to_q's codes in one ``sec_attention_q``
        over the k/v panels of the fused ``to_kv`` output ``y``: to_out's
        codes."""
        dp_q = ctx.entry(self.to_q.qname)
        dp_o = ctx.entry(self.to_out[0].qname)
        return sec_attention_q(
            codes, dp_q.w_int, dp_q.scale, dp_q.bias0, y, y, dp_o.scale_inv,
            dp_o.zp_shifted, heads=self.heads, head_dim=self.head_dim,
            scale=self.head_dim ** -0.5, k_off=0,
            v_off=self.heads * self.head_dim,
            clip=act_clip_range(dp_o.a_bits))

    def _sec_cross(self, hidden_states, y, ctx, residual, ln):
        """Cross-attention in one ``sec_attention_q_out`` over the k/v
        panels of the fused ``to_kv`` output ``y``: LN-folded when the
        deferred LayerNorm's raw input is the residual, else on to_q's
        codes plus the explicit residual."""
        dp_q = ctx.entry(self.to_q.qname)
        dp_o = ctx.entry(self.to_out[0].qname)
        x, fold, residual = self._block_input(hidden_states, residual, ln,
                                              dp_q)
        inner = self.heads * self.head_dim
        return sec_attention_q_out(
            x, dp_q.w_int, dp_q.scale, dp_q.bias0, y, y, dp_o.scale_inv,
            dp_o.zp_shifted, dp_o.w_int, dp_o.scale, dp_o.bias0,
            self.to_out[0].bias, residual, heads=self.heads,
            head_dim=self.head_dim,
            scale=self.head_dim ** -0.5, k_off=0, v_off=inner,
            out_dtype=self.dtype, clip=act_clip_range(dp_o.a_bits), ln=fold)


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
                ctx.deploy_compute, ctx.entry(self.proj.qname), consumer_dp):
            return self.proj(x, ctx, geglu_out=consumer_dp)
        h, gate = self.proj(x, ctx).chunk(2, -1)
        return (h.float() * gelu(gate.float(), ctx.gelu == "tanh")).to(
            self.dtype)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32,
                 device=None):
        super().__init__()
        inner = dim * mult
        self.dim, self.inner, self.dtype = dim, inner, dtype
        self.net = nn.ModuleList([
            GEGLU(dim, inner, dtype=dtype, device=device), nn.Identity(),
            QDense(inner, dim, dtype=dtype, device=device)])

    def forward(self, x, ctx: QuantCtx = FP_CTX, residual=None, ln=None):
        """``residual``: when given, returns ``residual + ff``. ``ln``: a
        deferred pre-LayerNorm (see ``Attention.forward``)."""
        dp_p = ctx.entry(self.net[0].proj.qname)
        dp_2 = ctx.entry(self.net[2].qname)
        if dp_2 is not None and (ln is None or residual is x) and \
                routing.whole_ff(
                    fusable=geglu_fusable(ctx.deploy_compute, dp_p, dp_2),
                    net2_codes=dp_2.w_int is not None, out_fuse=ctx.out_fuse,
                    M=x.numel() // x.shape[-1], K=x.shape[-1], H=self.inner,
                    C_out=self.dim, ln=ln is not None):
            return self._whole(x, ctx, residual, ln, dp_p, dp_2)
        if ln is not None:
            x = materialize_ln_codes(x, ln)
        x = self.net[0](x, ctx, consumer_dp=dp_2)
        x = self.net[2](x, ctx)
        return x if residual is None else deploy_res_add(residual, x)

    def _whole(self, x, ctx, residual, ln, dp_p, dp_2):
        """The whole feed-forward in one ``geglu_out_qmatmul``
        (``mixdq_tpu/models/attention.py:557-589``): LN-folded on the raw
        input, which is the residual, or on proj's codes plus the explicit
        residual."""
        lead, K, C = x.shape[:-1], x.shape[-1], self.dim
        if ln is not None:
            x, fold, res = x.to(self.dtype), ln_fold_args(ln), None
        else:
            x = codes_of(x if x.dtype == torch.int8 else x.to(self.dtype),
                         dp_p)
            fold = None
            res = (None if residual is None
                   else residual.to(self.dtype).reshape(-1, C))
        out = geglu_out_qmatmul(
            x.reshape(-1, K), dp_p.w_int, dp_p.scale, dp_p.bias0,
            dp_2.scale_inv, dp_2.zp_shifted, dp_2.w_int, dp_2.scale,
            dp_2.bias0, bias=self.net[0].proj.bias, out_bias=self.net[2].bias,
            residual=res, gelu_tanh=(ctx.gelu == "tanh"),
            clip=act_clip_range(dp_2.a_bits), out_dtype=self.dtype, ln=fold)
        return out.reshape(*lead, C)


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
        """Plain LayerNorm, or, when the consumer is an int8 entry that
        takes codes, deferred (raw input + (norm, entry)) or, with
        ``ctx.ln_fold`` off, its codes at once
        (``mixdq_tpu/models/attention.py:666-674``)."""
        dp = fused_entry(ctx, consumer)
        if dp is not None:
            if not ctx.ln_fold:
                return materialize_ln_codes(x, (norm, dp)), None
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
