"""CLIP text encoders (port of ``mixdq_tpu/models/clip.py:25-117``): the
ViT-L/14 text tower, and OpenCLIP bigG with its pooled projection, which
SDXL adds.

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

from .configs import CLIPTextConfig
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

