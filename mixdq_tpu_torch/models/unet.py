"""UNet2DConditionModel, NHWC (port of ``mixdq_tpu/models/unet.py``:
the SDXL and SD1.5 layouts). Module names follow the diffusers qualified
names, so the layer names equal the JAX package's ``canonical_name``s.

Forward contract: ``(sample [B, H, W, C], timesteps [] or [B],
encoder_hidden_states [B, T, D], added_cond_kwargs {text_embeds,
time_ids} (SDXL; None without ``add_embedding``), ctx) -> noise
prediction [B, H, W, C]``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..quant.state import FP_CTX, QuantCtx
from .attention import Transformer2DModel
from .configs import UNetConfig
from .embeddings import TimestepEmbedding, timestep_sinusoidal
from .layers import GroupNorm, QConv, lecun_normal_, name_layers
from .resnet import Downsample2D, ResnetBlock2D, Upsample2D, norm_act


class _Block(nn.Module):
    """Down / mid / up block: resnets, optional transformers, optional
    resampler (``downsamplers.0`` / ``upsamplers.0``)."""

    def __init__(self, resnets, attentions=None, down=None, up=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions is not None:
            self.attentions = nn.ModuleList(attentions)
        if down is not None:
            self.downsamplers = nn.ModuleList([down])
        if up is not None:
            self.upsamplers = nn.ModuleList([up])

    def down(self, x, temb, ehs, ctx, banks=None):
        skips = []
        attns = getattr(self, "attentions", None)
        for i, res in enumerate(self.resnets):
            x = res(x, temb, ctx, banks=banks)
            if attns is not None:
                x = attns[i](x, ehs, ctx, banks)
            skips.append(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x, ctx)
            skips.append(x)
        return x, skips

    def mid(self, x, temb, ehs, ctx, banks=None):
        x = self.resnets[0](x, temb, ctx, banks=banks)
        x = self.attentions[0](x, ehs, ctx, banks)
        return self.resnets[1](x, temb, ctx, banks=banks)

    def up(self, x, skips, temb, ehs, ctx, banks=None):
        attns = getattr(self, "attentions", None)
        for i, res in enumerate(self.resnets):
            split = x.shape[-1]  # upstream channels, before the concat
            x = res(torch.cat([x, skips.pop()], -1), temb, ctx, split=split,
                    banks=banks)
            if attns is not None:
                x = attns[i](x, ehs, ctx, banks)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x, ctx)
        return x


def conv_shortcut_splits(cfg: UNetConfig) -> Dict[str, int]:
    """Channel splits of the up blocks' concat-shortcut convs (port of
    ``mixdq_tpu/models/unet.py:conv_shortcut_splits``): layer name ->
    upstream hidden channel count (the first half of the concatenated
    input). For SDXL: ``[1280, 1280, 1280, 1280, 640, 640, 640, 320,
    320]``."""
    rev = list(reversed(cfg.block_out_channels))
    out: Dict[str, int] = {}
    n_layers = cfg.layers_per_block + 1
    for i in range(len(cfg.up_block_types)):
        for j in range(n_layers):
            if j == 0:
                split = rev[0] if i == 0 else rev[i - 1]
            else:
                split = rev[i]
            out[f"up_blocks.{i}.resnets.{j}.conv_shortcut"] = split
    return out


class UNet2DConditionModel(nn.Module):
    def __init__(self, config: UNetConfig, dtype=torch.float32, device=None):
        super().__init__()
        cfg = self.config = config
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        ch = cfg.block_out_channels
        temb = cfg.time_embed_dim
        groups = cfg.norm_num_groups
        n = len(ch)

        def heads(i):
            h = cfg.num_attention_heads[i]
            return h, (cfg.attention_head_dim or ch[i] // h)

        def tf(c, i, layers):
            h, d = heads(i)
            return Transformer2DModel(c, h, d, layers,
                                      cfg.cross_attention_dim,
                                      cfg.use_linear_projection, groups, **kw)

        self.time_embedding = TimestepEmbedding(ch[0], temb, **kw)
        if cfg.addition_embed_type == "text_time":
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb, **kw)
        self.conv_in = QConv(cfg.in_channels, ch[0], (3, 3), padding=1, **kw)

        self.down_blocks = nn.ModuleList()
        out_ch = ch[0]
        for i, btype in enumerate(cfg.down_block_types):
            in_ch, out_ch = out_ch, ch[i]
            cross = btype == "CrossAttnDownBlock2D"
            if not cross and btype != "DownBlock2D":
                raise ValueError(f"unknown down block {btype}")
            resnets = [ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, temb,
                                     groups, **kw)
                       for j in range(cfg.layers_per_block)]
            attns = ([tf(out_ch, i, cfg.transformer_layers_per_block[i])
                      for _ in range(cfg.layers_per_block)] if cross else None)
            down = Downsample2D(out_ch, **kw) if i < n - 1 else None
            self.down_blocks.append(_Block(resnets, attns, down=down))

        self.mid_block = _Block(
            [ResnetBlock2D(ch[-1], ch[-1], temb, groups, **kw)
             for _ in range(2)],
            [tf(ch[-1], n - 1, cfg.transformer_layers_per_block[-1])])

        rev = list(reversed(ch))
        self.up_blocks = nn.ModuleList()
        for i, btype in enumerate(cfg.up_block_types):
            prev_ch, out_ch = rev[max(i - 1, 0)], rev[i]
            skip_ch = rev[min(i + 1, n - 1)]
            cross = btype == "CrossAttnUpBlock2D"
            if not cross and btype != "UpBlock2D":
                raise ValueError(f"unknown up block {btype}")
            n_layers = cfg.layers_per_block + 1
            resnets = []
            for j in range(n_layers):
                res_skip = skip_ch if j == n_layers - 1 else out_ch
                res_in = prev_ch if j == 0 else out_ch
                resnets.append(ResnetBlock2D(res_in + res_skip, out_ch, temb,
                                             groups, **kw))
            attns = ([tf(out_ch, n - 1 - i,
                         cfg.transformer_layers_per_block[n - 1 - i])
                      for _ in range(n_layers)] if cross else None)
            up = Upsample2D(out_ch, **kw) if i < n - 1 else None
            self.up_blocks.append(_Block(resnets, attns, up=up))

        self.conv_norm_out = GroupNorm(groups, ch[0], 1e-5, **kw)
        self.conv_out = QConv(ch[0], cfg.out_channels, (3, 3), padding=1,
                              **kw)
        name_layers(self)

    @torch.no_grad()
    def init_weights(self, seed: int) -> "UNet2DConditionModel":
        """Random weights from ``seed``: flax ``lecun_normal`` kernels in
        layer-name order, zero biases, unit norm scales."""
        from ..quant.state import quantizable_layers

        dev = next(self.parameters()).device
        gen = torch.Generator(device=dev).manual_seed(seed)
        for _, m in sorted(quantizable_layers(self).items()):
            lecun_normal_(m.weight, m.fan_in(), gen)
        return self

    def banks(self, emb: torch.Tensor, ehs: torch.Tensor, ctx: QuantCtx
              ) -> Optional[Dict[str, torch.Tensor]]:
        """The step's shared-input banks (``mixdq_tpu/models/unet.py:
        277-292``), ``{layer name: output}`` or None: the fused cross-
        attention k/v projections of ``ehs`` (``ctx.cross_kv``) and the
        ``time_emb_proj`` products of ``silu(emb)``, the tensor each
        resnet's projection reads (``ctx.linear_bank``)."""
        from ..quant.deploy import precompute_cross_kv, precompute_linear_bank

        if ctx.mode != "int8" or not ctx.deploy:
            return None
        banks = {}
        banks.update(precompute_cross_kv(ehs, ctx, self.dtype) or {})
        banks.update(precompute_linear_bank(F.silu(emb), ctx, self.dtype)
                     or {})
        return banks or None

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                added_cond_kwargs: Optional[Dict[str, torch.Tensor]] = None,
                ctx: QuantCtx = FP_CTX) -> torch.Tensor:
        cfg = self.config
        B = sample.shape[0]
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(B)
        t_emb = timestep_sinusoidal(timesteps, cfg.block_out_channels[0])
        emb = self.time_embedding(t_emb.to(self.dtype), ctx)
        if cfg.addition_embed_type == "text_time":
            if added_cond_kwargs is None:
                raise ValueError("SDXL UNet requires added_cond_kwargs"
                                 "{text_embeds, time_ids}")
            text_embeds = added_cond_kwargs["text_embeds"]
            t_ids = timestep_sinusoidal(
                added_cond_kwargs["time_ids"].reshape(-1),
                cfg.addition_time_embed_dim).reshape(B, -1)
            add_emb = torch.cat([text_embeds.float(), t_ids], -1)
            emb = emb + self.add_embedding(add_emb.to(self.dtype), ctx)

        sample = sample.to(self.dtype)
        ehs = encoder_hidden_states.to(self.dtype)
        banks = self.banks(emb, ehs, ctx)
        h = self.conv_in(sample, ctx)
        skips = [h]
        for blk in self.down_blocks:
            h, s = blk.down(h, emb, ehs, ctx, banks)
            skips.extend(s)
        h = self.mid_block.mid(h, emb, ehs, ctx, banks)
        n_layers = cfg.layers_per_block + 1
        for blk in self.up_blocks:
            block_skips = skips[-n_layers:]
            del skips[-n_layers:]
            h = blk.up(h, block_skips, emb, ehs, ctx, banks)
        h = norm_act(h, self.conv_norm_out, self.conv_out.qname, ctx)
        return self.conv_out(h, ctx)
