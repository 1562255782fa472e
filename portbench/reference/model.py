"""The plain reference of the served models, in plain PyTorch: the SDXL
and SD1.5 UNets, the CLIP text towers and the VAE decoder, built from a
configuration file's published sizes (diffusers' ``config.json`` keys).

It imports nothing of the program under test. Activations are NHWC and
weights are stored as the benchmark makes them (dense ``[in, out]``,
conv HWIO), held in float32; each forward computes in the dtype of its
input, so the same modules run the bfloat16 calibration pass and the
float32 check.

Quantization follows the configuration's W8A8 recipe (MixDQ's uniform
baseline) through ``Quant``: every UNet linear and conv layer has its
weight fake-quantized per output channel (symmetric, ``absmax / (2^(b-1)
- 1)``) and its input per tensor (asymmetric, the calibration pass's min
and max, each containing 0), rounding half to even. The first (BoS) text
token of the cross-attention k / v projections keeps its unquantized
input (MixDQ's BoS-aware quantization). A concatenated up-block shortcut
conv quantizes its whole input on the range of its first (upstream) half,
as the W8A8 recipe calibrates it. Towers, VAE, norms, softmax and the
residual stream are not quantized (the control, ``lower_rest``, rounds
the towers' and the VAE's linear and conv layers to float8). The GEGLU
gate is the tanh form of GELU, as the served configuration states
(``gelu``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class Quant:
    """How the layers quantize. ``mode``: ``'fp'`` (nothing), ``'calib'``
    (record each quantized layer's input range into ``ranges``) or
    ``'fq'`` (fake-quantize at ``w_bits`` / ``a_bits`` on ``ranges``)."""

    def __init__(self, mode: str = "fp", w_bits: int = 8, a_bits: int = 8,
                 ranges: Optional[Dict[str, Tuple[torch.Tensor,
                                                  torch.Tensor]]] = None):
        if mode not in ("fp", "calib", "fq"):
            raise ValueError(f"mode {mode!r}")
        self.mode, self.w_bits, self.a_bits = mode, w_bits, a_bits
        self.ranges = {} if ranges is None else ranges

    def record(self, name: str, x: torch.Tensor) -> None:
        xf = x.float()
        lo, hi = xf.min().clamp(max=0.0), xf.max().clamp(min=0.0)
        if name in self.ranges:
            lo = torch.minimum(lo, self.ranges[name][0])
            hi = torch.maximum(hi, self.ranges[name][1])
        self.ranges[name] = (lo, hi)

    def act(self, name: str, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.ranges[name]
        levels = 2.0 ** self.a_bits - 1.0
        delta = ((hi - lo) / levels).clamp(min=1e-6)
        zp = torch.round(-lo / delta)
        xf = x.float()
        codes = (torch.round(xf / delta) + zp).clamp(0.0, levels)
        return ((codes - zp) * delta).to(x.dtype)

    def weight(self, w: torch.Tensor, dtype) -> torch.Tensor:
        """Per output channel (the last axis), symmetric."""
        wf = w.float()
        n = 2.0 ** (self.w_bits - 1) - 1.0
        amax = wf.reshape(-1, wf.shape[-1]).abs().amax(0)
        delta = (amax / n).clamp(min=1e-6)
        codes = torch.round(wf / delta).clamp(-n - 1.0, n)
        return (codes * delta).to(dtype)


FP = Quant()


def fp8(x: torch.Tensor, per_channel: bool = False) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 on a scale that puts its absolute
    maximum at 448 (per tensor, or per last-axis channel), in its dtype."""
    xf = x.float()
    amax = (xf.reshape(-1, xf.shape[-1]).abs().amax(0) if per_channel
            else xf.abs().amax())
    scale = (amax / 448.0).clamp(min=1e-12)
    return ((xf / scale).to(torch.float8_e4m3fn).float() * scale).to(
        x.dtype)


def lower_rest(m: nn.Module, on: bool) -> None:
    """The control one precision below the served bf16 in the text towers
    and the VAE: with ``on``, every linear and conv layer of the towers
    and the VAE decoder computes on its weight (per output channel) and
    input (per tensor) rounded to float8 e4m3."""
    for top in ("text_encoder", "text_encoder_2", "vae"):
        for mod in getattr(m, top, nn.Module()).modules():
            if isinstance(mod, (Linear, Conv)):
                mod.fp8 = on


def name_layers(root: nn.Module) -> None:
    for n, m in root.named_modules():
        m.qname = n


class Linear(nn.Module):
    """``x @ weight + bias`` on an ``[in, out]`` weight; ``quantized``:
    a UNet layer that ``Quant`` acts on."""

    def __init__(self, i: int, o: int, bias: bool = True,
                 quantized: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(i, o))
        self.bias = nn.Parameter(torch.empty(o)) if bias else None
        self.quantized, self.fp8 = quantized, False

    def forward(self, x, q: Quant = FP, bos: bool = False):
        dt = x.dtype
        w = self.weight.to(dt)
        if self.fp8:
            x, w = fp8(x), fp8(w, per_channel=True)
        if self.quantized and q.mode == "calib":
            q.record(self.qname, x)
        if self.quantized and q.mode == "fq":
            wq = q.weight(self.weight, dt)
            y = q.act(self.qname, x) @ wq
            if bos:
                y = torch.cat([x[..., :1, :] @ wq, y[..., 1:, :]], -2)
        else:
            y = x @ w
        return y if self.bias is None else y + self.bias.to(dt)


class Conv(nn.Module):
    """NHWC convolution on an HWIO weight, symmetric padding."""

    def __init__(self, i: int, o: int, k: int = 3, stride: int = 1,
                 quantized: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(k, k, i, o))
        self.bias = nn.Parameter(torch.empty(o))
        self.stride, self.pad, self.quantized = stride, k // 2, quantized
        self.fp8 = False

    def forward(self, x, q: Quant = FP, split: int = 0):
        dt = x.dtype
        w = self.weight.to(dt)
        if self.fp8:
            x, w = fp8(x), fp8(w, per_channel=True)
        if self.quantized and q.mode == "calib":
            q.record(self.qname, x[..., :split] if split else x)
        if self.quantized and q.mode == "fq":
            x, w = q.act(self.qname, x), q.weight(self.weight, dt)
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     self.bias.to(dt), stride=self.stride, padding=self.pad)
        return y.permute(0, 2, 3, 1)


class GroupNorm(nn.Module):
    def __init__(self, groups: int, c: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.groups,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.permute(0, 2, 3, 1).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def attention(q, k, v, heads: int):
    """Multi-head attention on ``[B, T, heads * d]`` projections, softmax
    in float32."""
    B, Tq, inner = q.shape
    d = inner // heads
    qh = q.reshape(B, Tq, heads, d).transpose(1, 2)
    kh = k.reshape(B, -1, heads, d).transpose(1, 2)
    vh = v.reshape(B, -1, heads, d).transpose(1, 2)
    p = torch.softmax((qh @ kh.transpose(-1, -2)).float() * d ** -0.5, -1)
    return (p.to(q.dtype) @ vh).transpose(1, 2).reshape(B, Tq, inner)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` with ``flip_sin_to_cos`` and no
    frequency shift: ``[cos, sin]`` of ``t * 10000^(-i / (dim / 2))``."""
    half = dim // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    arg = t.float()[:, None] * freq[None]
    return torch.cat([torch.cos(arg), torch.sin(arg)], -1)


class TimestepEmbedding(nn.Module):
    def __init__(self, i: int, o: int):
        super().__init__()
        self.linear_1 = Linear(i, o, quantized=True)
        self.linear_2 = Linear(o, o, quantized=True)

    def forward(self, x, q):
        return self.linear_2(F.silu(self.linear_1(x, q)), q)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, kv_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        kv = kv_dim or dim
        self.to_q = Linear(dim, dim, bias=False, quantized=True)
        self.to_k = Linear(kv, dim, bias=False, quantized=True)
        self.to_v = Linear(kv, dim, bias=False, quantized=True)
        self.to_out = nn.ModuleList([Linear(dim, dim, quantized=True)])

    def forward(self, x, q, ctx=None):
        cross = ctx is not None
        src = ctx if cross else x
        out = attention(self.to_q(x, q), self.to_k(src, q, bos=cross),
                        self.to_v(src, q, bos=cross), self.heads)
        return self.to_out[0](out, q)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, 2 * inner, quantized=True)

    def forward(self, x, q):
        h, gate = self.proj(x, q).chunk(2, -1)
        return (h.float() * gelu_tanh(gate.float())).to(x.dtype)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(),
                                  Linear(4 * dim, dim, quantized=True)])

    def forward(self, x, q):
        return self.net[2](self.net[0](x, q), q)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, cross_dim: int):
        super().__init__()
        self.norm1, self.norm2, self.norm3 = (LayerNorm(dim) for _ in
                                              range(3))
        self.attn1 = Attention(dim, heads)
        self.attn2 = Attention(dim, heads, cross_dim)
        self.ff = FeedForward(dim)

    def forward(self, x, ctx, q):
        x = x + self.attn1(self.norm1(x), q)
        x = x + self.attn2(self.norm2(x), q, ctx)
        return x + self.ff(self.norm3(x), q)


class Transformer2D(nn.Module):
    def __init__(self, c: int, heads: int, layers: int, cross_dim: int,
                 linear: bool, groups: int):
        super().__init__()
        self.linear = linear
        self.norm = GroupNorm(groups, c, 1e-6)
        proj = ((lambda i, o: Linear(i, o, quantized=True)) if linear else
                (lambda i, o: Conv(i, o, 1, quantized=True)))
        self.proj_in = proj(c, c)
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(c, heads, cross_dim) for _ in range(layers))
        self.proj_out = proj(c, c)

    def forward(self, x, ctx, q):
        B, H, W, C = x.shape
        h = self.norm(x)
        h = (self.proj_in(h.reshape(B, H * W, C), q) if self.linear
             else self.proj_in(h, q).reshape(B, H * W, C))
        for blk in self.transformer_blocks:
            h = blk(h, ctx, q)
        h = (self.proj_out(h, q).reshape(B, H, W, C) if self.linear
             else self.proj_out(h.reshape(B, H, W, C), q))
        return x + h


class Resnet(nn.Module):
    def __init__(self, i: int, o: int, temb: Optional[int], groups: int,
                 eps: float, quantized: bool):
        super().__init__()
        self.norm1 = GroupNorm(groups, i, eps)
        self.conv1 = Conv(i, o, quantized=quantized)
        if temb is not None:
            self.time_emb_proj = Linear(temb, o, quantized=quantized)
        self.norm2 = GroupNorm(groups, o, eps)
        self.conv2 = Conv(o, o, quantized=quantized)
        self.conv_shortcut = (Conv(i, o, 1, quantized=quantized)
                              if i != o else None)

    def forward(self, x, temb=None, q: Quant = FP, split: int = 0):
        h = self.conv1(F.silu(self.norm1(x)), q)
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb), q)[:, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)), q)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x, q, split)
        return x + h


class Block(nn.Module):
    def __init__(self, resnets, attentions=None, down=None, up=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions is not None:
            self.attentions = nn.ModuleList(attentions)
        if down is not None:
            self.downsamplers = nn.ModuleList([down])
        if up is not None:
            self.upsamplers = nn.ModuleList([up])


class Sampler(nn.Module):
    """``downsamplers.0`` (stride 2) / ``upsamplers.0`` (nearest 2x
    first)."""

    def __init__(self, c: int, down: bool):
        super().__init__()
        self.down = down
        self.conv = Conv(c, c, stride=2 if down else 1, quantized=True)

    def forward(self, x, q):
        if not self.down:
            x = x.repeat_interleave(2, 1).repeat_interleave(2, 2)
        return self.conv(x, q)


def unet_heads(u: dict):
    """Heads at each level: diffusers reads ``attention_head_dim`` as the
    head count when ``num_attention_heads`` is unset."""
    heads = u.get("num_attention_heads") or u["attention_head_dim"]
    n = len(u["block_out_channels"])
    return list(heads) if isinstance(heads, (list, tuple)) else [heads] * n


def per_level(v, n: int):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


class UNet(nn.Module):
    """``forward(sample [B, H, W, 4], t [B], ehs [B, 77, D], text_embeds,
    time_ids, q) -> eps``."""

    def __init__(self, u: dict):
        super().__init__()
        self.u = u
        ch = list(u["block_out_channels"])
        n, g = len(ch), u["norm_num_groups"]
        temb = ch[0] * 4
        heads = unet_heads(u)
        layers = per_level(u.get("transformer_layers_per_block", 1), n)
        cross = u["cross_attention_dim"]
        lin = u.get("use_linear_projection", False)
        lpb = u["layers_per_block"]

        def res(i, o):
            return Resnet(i, o, temb, g, 1e-5, True)

        def tf(c, lvl):
            return Transformer2D(c, heads[lvl], layers[lvl], cross, lin, g)

        self.time_embedding = TimestepEmbedding(ch[0], temb)
        if u.get("addition_embed_type") == "text_time":
            self.add_embedding = TimestepEmbedding(
                u["projection_class_embeddings_input_dim"], temb)
        self.conv_in = Conv(u["in_channels"], ch[0], quantized=True)
        self.down_blocks = nn.ModuleList()
        out = ch[0]
        for i, kind in enumerate(u["down_block_types"]):
            prev, out = out, ch[i]
            crossattn = kind.startswith("CrossAttn")
            self.down_blocks.append(Block(
                [res(prev if j == 0 else out, out) for j in range(lpb)],
                [tf(out, i) for _ in range(lpb)] if crossattn else None,
                down=Sampler(out, True) if i < n - 1 else None))
        self.mid_block = Block([res(ch[-1], ch[-1]) for _ in range(2)],
                               [tf(ch[-1], n - 1)])
        rev = ch[::-1]
        self.up_blocks = nn.ModuleList()
        for i, kind in enumerate(u["up_block_types"]):
            prev, out, skip = rev[max(i - 1, 0)], rev[i], rev[min(i + 1,
                                                                  n - 1)]
            crossattn = kind.startswith("CrossAttn")
            self.up_blocks.append(Block(
                [res((prev if j == 0 else out)
                     + (skip if j == lpb else out), out)
                 for j in range(lpb + 1)],
                [tf(out, n - 1 - i) for _ in range(lpb + 1)]
                if crossattn else None,
                up=Sampler(out, False) if i < n - 1 else None))
        self.conv_norm_out = GroupNorm(g, ch[0], 1e-5)
        self.conv_out = Conv(ch[0], u["out_channels"], quantized=True)
        name_layers(self)

    def forward(self, x, t, ehs, text_embeds, time_ids, q: Quant = FP):
        u, dt = self.u, x.dtype
        B = x.shape[0]
        emb = self.time_embedding(
            timestep_embedding(t.expand(B), u["block_out_channels"][0])
            .to(dt), q)
        if hasattr(self, "add_embedding"):
            tid = timestep_embedding(time_ids.reshape(-1),
                                     u["addition_time_embed_dim"])
            a = torch.cat([text_embeds.float(), tid.reshape(B, -1)], -1)
            emb = emb + self.add_embedding(a.to(dt), q)
        h = self.conv_in(x, q)
        skips = [h]
        for blk in self.down_blocks:
            attns = getattr(blk, "attentions", None)
            for j, r in enumerate(blk.resnets):
                h = r(h, emb, q)
                if attns is not None:
                    h = attns[j](h, ehs, q)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h, q)
                skips.append(h)
        mid = self.mid_block
        h = mid.resnets[0](h, emb, q)
        h = mid.attentions[0](h, ehs, q)
        h = mid.resnets[1](h, emb, q)
        for blk in self.up_blocks:
            attns = getattr(blk, "attentions", None)
            for j, r in enumerate(blk.resnets):
                split = h.shape[-1]
                h = r(torch.cat([h, skips.pop()], -1), emb, q, split)
                if attns is not None:
                    h = attns[j](h, ehs, q)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h, q)
        return self.conv_out(F.silu(self.conv_norm_out(h)), q)


# ---------------------------------------------------------------------------
# CLIP text towers
# ---------------------------------------------------------------------------


class Embedding(nn.Module):
    """A token table ``weight [vocab, c]``, left uninitialised: the
    benchmark makes every weight (``nn.Embedding`` would draw one, which
    on the meta device imports the compiler stack)."""

    def __init__(self, n: int, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, c))


class CLIPLayer(nn.Module):
    def __init__(self, c: int, heads: int, inner: int, act: str):
        super().__init__()
        self.heads = heads
        self.act = (lambda x: x * torch.sigmoid(1.702 * x)) \
            if act == "quick_gelu" else F.gelu
        self.layer_norm1 = LayerNorm(c)
        self.self_attn = nn.Module()
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, p, Linear(c, c))
        self.layer_norm2 = LayerNorm(c)
        self.fc1, self.fc2 = Linear(c, inner), Linear(inner, c)

    def forward(self, x):
        a, h = self.self_attn, self.layer_norm1(x)
        B, T, C = h.shape
        d = C // self.heads
        qh, kh, vh = (p(h).reshape(B, T, self.heads, d).transpose(1, 2)
                      for p in (a.q_proj, a.k_proj, a.v_proj))
        logits = (qh @ kh.transpose(-1, -2)).float() * d ** -0.5
        mask = torch.full((T, T), -math.inf, device=x.device).triu(1)
        p = torch.softmax(logits + mask, -1).to(x.dtype)
        o = (p @ vh).transpose(1, 2).reshape(B, T, C)
        x = x + a.out_proj(o)
        return x + self.fc2(self.act(self.fc1(self.layer_norm2(x))))


class CLIPText(nn.Module):
    """``forward(ids) -> (last, penultimate, pooled)``: the final-LN state,
    the state entering the last layer (``hidden_states[-2]``), and the
    final state at the EOS token (the highest id), projected when the
    tower has ``projection_dim`` and ``projected``."""

    def __init__(self, t: dict, projected: bool):
        super().__init__()
        c = t["hidden_size"]
        self.token_embedding = Embedding(t["vocab_size"], c)
        self.position_embedding = nn.Parameter(
            torch.empty(t["max_position_embeddings"], c))
        self.layers = nn.ModuleList(
            CLIPLayer(c, t["num_attention_heads"], t["intermediate_size"],
                      t["hidden_act"])
            for _ in range(t["num_hidden_layers"]))
        self.final_layer_norm = LayerNorm(c)
        self.text_projection = (Linear(c, t["projection_dim"], bias=False)
                                if projected else None)

    def forward(self, ids, dtype):
        T = ids.shape[1]
        x = (self.token_embedding.weight.to(dtype)[ids]
             + self.position_embedding[:T].to(dtype))
        pen = x
        for layer in self.layers:
            pen = x
            x = layer(x)
        last = self.final_layer_norm(x)
        pooled = last[torch.arange(ids.shape[0], device=ids.device),
                      ids.argmax(-1)]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return last, pen, pooled


# ---------------------------------------------------------------------------
# VAE decoder
# ---------------------------------------------------------------------------


class VAEAttention(nn.Module):
    def __init__(self, c: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(groups, c, 1e-6)
        self.to_q, self.to_k, self.to_v = (Linear(c, c) for _ in range(3))
        self.to_out = nn.ModuleList([Linear(c, c)])

    def forward(self, x):
        B, H, W, C = x.shape
        h = self.group_norm(x).reshape(B, H * W, C)
        o = attention(self.to_q(h), self.to_k(h), self.to_v(h), 1)
        return x + self.to_out[0](o).reshape(B, H, W, C)


class VAEDecoder(nn.Module):
    def __init__(self, v: dict):
        super().__init__()
        ch, g = list(v["block_out_channels"])[::-1], v["norm_num_groups"]

        def res(i, o):
            return Resnet(i, o, None, g, 1e-6, False)

        self.conv_in = Conv(v["latent_channels"], ch[0])
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList([res(ch[0], ch[0]),
                                                res(ch[0], ch[0])])
        self.mid_block.attentions = nn.ModuleList([VAEAttention(ch[0], g)])
        prev = ch[0]
        self.levels = []
        for i, c in enumerate(ch):
            names = []
            for j in range(v["layers_per_block"] + 1):
                names.append(f"up_blocks_{i}_resnets_{j}")
                self.add_module(names[-1], res(prev, c))
                prev = c
            up = f"up_blocks_{i}_upsampler" if i < len(ch) - 1 else None
            if up:
                self.add_module(up, Conv(c, c))
            self.levels.append((names, up))
        self.conv_norm_out = GroupNorm(g, ch[-1], 1e-6)
        self.conv_out = Conv(ch[-1], v["out_channels"])

    def forward(self, z):
        mid = self.mid_block
        h = mid.resnets[0](self.conv_in(z))
        h = mid.resnets[1](mid.attentions[0](h))
        for names, up in self.levels:
            for n in names:
                h = getattr(self, n)(h)
            if up:
                h = getattr(self, up)(
                    h.repeat_interleave(2, 1).repeat_interleave(2, 2))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class VAE(nn.Module):
    """The decode half of AutoencoderKL: ``decode(scaled latents) ->
    image in about [-1, 1]``."""

    def __init__(self, v: dict):
        super().__init__()
        self.scaling = v["scaling_factor"]
        self.decoder = VAEDecoder(v)
        self.post_quant_conv = Conv(v["latent_channels"],
                                    v["latent_channels"], 1)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z / self.scaling))


class Models(nn.Module):
    """The served modules of one configuration, under the program's state
    dict names: ``unet``, ``vae``, ``text_encoder`` and, for SDXL,
    ``text_encoder_2`` (projected: its pooled output conditions the
    UNet)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.unet = UNet(cfg["unet"])
        self.vae = VAE(cfg["vae"])
        self.text_encoder = CLIPText(cfg["text_encoder"], projected=False)
        self.sdxl = "text_encoder_2" in cfg
        if self.sdxl:
            self.text_encoder_2 = CLIPText(cfg["text_encoder_2"],
                                           projected=True)

    def encode(self, ids, dtype):
        """(prompt embeds, pooled or None): SDXL concatenates both towers'
        penultimate states; SD1.5 takes tower 1's final state."""
        if self.sdxl:
            _, p1, _ = self.text_encoder(ids, dtype)
            _, p2, pooled = self.text_encoder_2(ids, dtype)
            return torch.cat([p1, p2], -1), pooled
        return self.text_encoder(ids, dtype)[0], None
