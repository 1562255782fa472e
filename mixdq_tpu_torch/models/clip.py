"""CLIP text encoders and the CLIP image tower (port of
``mixdq_tpu/models/clip.py``): the ViT-L/14 text tower, OpenCLIP bigG with
its pooled projection, which SDXL adds, and ``CLIPVisionModel``, the
feature extractor of CLIP-score and CLIP-FID (``scripts/evaluate.py``).

The text towers stay FP on every path, as in the JAX package: their
products are plain ``x @ w`` on ``[K, N]`` weights (``Dense``), not
quantizable layers. Module names follow the HF ``text_model.*`` space
as the JAX package's flax names map through ``canonical_name``
(``layers_3`` -> ``layers.3``).

SDXL prompt-embedding contract: each tower's *penultimate* hidden state
(the state entering the last layer), concatenated to the UNet's
cross-attention width; pooled output = the projected EOS-token embedding
of tower 2. Everything stays on the device: the EOS position is an
``argmax`` of the ids and a gather, so a captured graph holds the whole
encode.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .configs import CLIPTextConfig, CLIPVisionConfig
from .layers import LayerNorm, lecun_normal_, name_layers


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def exact_gelu(x: torch.Tensor) -> torch.Tensor:
    """HF ``gelu``: the exact erf form (bigG's activation)."""
    return F.gelu(x, approximate="none")


class Dense(nn.Module):
    """``x @ weight (+ bias)`` on a ``[in, out]`` weight in ``dtype``
    (flax ``nn.Dense`` with ``param_dtype=dtype``)."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(in_features, features, dtype=dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=dtype,
                                              device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.to(self.dtype) @ self.weight
        return y if self.bias is None else y + self.bias


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        c = cfg.hidden_size
        self.heads, self.dtype = cfg.num_heads, dtype
        self.q_proj, self.k_proj = Dense(c, c, **kw), Dense(c, c, **kw)
        self.v_proj, self.out_proj = Dense(c, c, **kw), Dense(c, c, **kw)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor
                ) -> torch.Tensor:
        B, T, C = x.shape
        d = C // self.heads
        q = self.q_proj(x).reshape(B, T, self.heads, d)
        k = self.k_proj(x).reshape(B, T, self.heads, d)
        v = self.v_proj(x).reshape(B, T, self.heads, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
        # the f32 mask promotes the logits; softmax in f32, then cast
        probs = torch.softmax(logits.float() + causal_mask, -1).to(self.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, T, C)
        return self.out_proj(out)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        c = cfg.hidden_size
        self.act = quick_gelu if cfg.hidden_act == "quick_gelu" else exact_gelu
        self.layer_norm1 = LayerNorm(c, 1e-5, **kw)
        self.self_attn = CLIPAttention(cfg, **kw)
        self.layer_norm2 = LayerNorm(c, 1e-5, **kw)
        self.fc1 = Dense(c, cfg.intermediate_size, **kw)
        self.fc2 = Dense(cfg.intermediate_size, c, **kw)

    def forward(self, x: torch.Tensor, causal_mask: torch.Tensor
                ) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.fc2(self.act(self.fc1(self.layer_norm2(x))))


class CLIPTextModel(nn.Module):
    """``forward(input_ids [B, T]) -> (last, penultimate, pooled)``:
    ``last`` the final-LN hidden state, ``penultimate`` the state entering
    the last layer (HF ``hidden_states[-2]``), ``pooled`` ``last`` at each
    sequence's EOS position (the argmax of its ids), through
    ``text_projection`` (no bias) when ``cfg.projection_dim`` is set."""

    def __init__(self, cfg: CLIPTextConfig, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg, self.dtype = cfg, dtype
        c = cfg.hidden_size
        self.token_embedding = nn.Embedding(cfg.vocab_size, c, **kw)
        # a raw f32 param, cast at use (the flax param's default dtype)
        self.position_embedding = nn.Parameter(torch.empty(
            cfg.max_position_embeddings, c, device=device))
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.final_layer_norm = LayerNorm(c, 1e-5, **kw)
        self.text_projection = (Dense(c, cfg.projection_dim, use_bias=False,
                                      **kw)
                                if cfg.projection_dim is not None else None)
        name_layers(self)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CLIPTextModel":
        """Random weights from ``generator``: lecun-normal dense kernels
        in name order, token embeddings N(0, 0.02), positions N(0, 0.01),
        zero biases, unit norm scales."""
        for _, m in sorted(self.named_modules()):
            if isinstance(m, Dense):
                lecun_normal_(m.weight, m.weight.shape[0], generator)
        self.token_embedding.weight.normal_(0.0, 0.02, generator=generator)
        self.position_embedding.normal_(0.0, 0.01, generator=generator)
        return self

    def forward(self, input_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        B, T = input_ids.shape
        ids = input_ids.long()
        x = self.token_embedding(ids) + self.position_embedding[:T].to(
            self.dtype)
        causal = torch.full((T, T), -math.inf, device=x.device).triu(1)
        penultimate = x
        for layer in self.layers:
            penultimate = x
            x = layer(x, causal)
        last = self.final_layer_norm(x)
        eos = torch.argmax(ids, -1)
        pooled = last[torch.arange(B, device=last.device), eos]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return last, penultimate, pooled


#: CLIP normalization (HF ``CLIPImageProcessor`` defaults)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def resize_bilinear(images: torch.Tensor, size: int) -> torch.Tensor:
    """``[B, H, W, C]`` -> ``[B, size, size, C]``, bilinear with
    antialiasing as ``jax.image.resize(..., "bilinear")`` (which
    antialiases when it downsamples; without ``antialias=True``
    ``F.interpolate`` differs from it by up to 0.54 at 512 -> 299)."""
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(size, size),
                      mode="bilinear", align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def preprocess_images(images: torch.Tensor, image_size: int = 224
                      ) -> torch.Tensor:
    """``[B, H, W, 3]`` images in [0, 1] -> CLIP-normalized ``[B, S, S,
    3]``."""
    if tuple(images.shape[1:3]) != (image_size, image_size):
        images = resize_bilinear(images, image_size)
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=images.dtype,
                        device=images.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=images.dtype,
                       device=images.device)
    return (images - mean) / std


class PatchEmbedding(nn.Module):
    """Stride-``patch`` conv without bias on an HWIO ``[p, p, 3, C]``
    weight (flax ``nn.Conv``'s layout): NHWC pixels -> ``[B, P, C]``
    patches in row-major order."""

    def __init__(self, patch: int, channels: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.patch, self.dtype = patch, dtype
        self.weight = nn.Parameter(torch.empty(patch, patch, 3, channels,
                                               dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2),
                     self.weight.permute(3, 2, 0, 1), stride=self.patch)
        return y.flatten(2).transpose(1, 2)


class CLIPVisionModel(nn.Module):
    """CLIP ViT image tower (HF ``vision_model.*`` naming; the module is
    ``pre_layrnorm``, HF's spelling, so converted checkpoints map one to
    one). ``forward(pixel_values [B, S, S, 3] CLIP-normalized, NHWC) ->
    (last_hidden_state, pooled)``: ``pooled`` the post-LN CLS row through
    ``visual_projection`` (no bias) when ``cfg.projection_dim`` is set.
    The encoder layers are the text towers' with a zero mask."""

    def __init__(self, cfg: CLIPVisionConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.cfg, self.dtype = cfg, dtype
        c = cfg.hidden_size
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.patch_embedding = PatchEmbedding(cfg.patch_size, c, **kw)
        # raw f32 params, cast at use (the flax params' default dtype)
        self.class_embedding = nn.Parameter(torch.empty(c, device=device))
        self.position_embedding = nn.Parameter(torch.empty(n_pos, c,
                                                           device=device))
        self.pre_layrnorm = LayerNorm(c, 1e-5, **kw)
        text_like = CLIPTextConfig(
            hidden_size=c, num_heads=cfg.num_heads,
            intermediate_size=cfg.intermediate_size,
            hidden_act=cfg.hidden_act)
        self.layers = nn.ModuleList(CLIPEncoderLayer(text_like, **kw)
                                    for _ in range(cfg.num_layers))
        self.post_layernorm = LayerNorm(c, 1e-5, **kw)
        self.visual_projection = (
            Dense(c, cfg.projection_dim, use_bias=False, **kw)
            if cfg.projection_dim is not None else None)
        name_layers(self)

    def forward(self, pixel_values: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        patches = self.patch_embedding(pixel_values)
        B, _, C = patches.shape
        cls = self.class_embedding.to(self.dtype).expand(B, 1, C)
        x = torch.cat([cls, patches], 1) + self.position_embedding[None].to(
            self.dtype)
        x = self.pre_layrnorm(x)
        zero_mask = torch.zeros(x.shape[1], x.shape[1], device=x.device)
        for layer in self.layers:
            x = layer(x, zero_mask)
        pooled = self.post_layernorm(x[:, 0])
        if self.visual_projection is not None:
            pooled = self.visual_projection(pooled)
        return x, pooled
