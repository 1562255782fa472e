"""Weights from a seed, made on the device in the types they are served
in, one generator draw per module and dtype.

Names and shapes come from the plain reference's modules (under the
program's state dict names); values are unit normals scaled per tensor:
dense and conv kernels by ``1 / sqrt(fan_in)``, biases by 0.05, norm
scales ``1 + 0.05 n`` and shifts ``0.05 n``, token embeddings by 0.02 and
positions by 0.01. Norm parameters and positions are float32, the rest
the served dtype. The same seed gives the same values on every call, so
the reference can make them again once the program's state is freed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .reference.model import GroupNorm, LayerNorm, Models

Spec = Tuple[str, Tuple[int, ...], str]  # (name, shape, kind)


def specs(module: torch.nn.Module) -> List[Spec]:
    """(name, shape, kind) of every parameter, in name order."""
    norms = {n for n, m in module.named_modules()
             if isinstance(m, (GroupNorm, LayerNorm))}
    out = []
    for name, p in sorted(module.named_parameters()):
        owner, leaf = name.rpartition(".")[::2]
        if owner in norms:
            kind = "norm_" + leaf
        elif name.endswith("token_embedding.weight"):
            kind = "token_embedding"
        elif leaf == "position_embedding":
            kind = "position_embedding"
        else:
            kind = "kernel" if leaf == "weight" else "bias"
        out.append((name, tuple(p.shape), kind))
    return out


def _dtype(kind: str, served) -> torch.dtype:
    return (torch.float32 if kind.startswith("norm_")
            or kind == "position_embedding" else served)


def _scale(x: torch.Tensor, shape, kind: str) -> torch.Tensor:
    if kind == "kernel":
        return x * math.prod(shape[:-1]) ** -0.5
    if kind == "norm_weight":
        return 1.0 + 0.05 * x
    return x * {"bias": 0.05, "norm_bias": 0.05, "token_embedding": 0.02,
                "position_embedding": 0.01}[kind]


@torch.no_grad()
def make(models: Models, seed: int, device, served: torch.dtype
         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{module: state dict}`` for ``unet``, ``vae``, ``text_encoder``
    and (SDXL) ``text_encoder_2``, from generators seeded ``seed``."""
    out = {}
    for idx, top in enumerate(("unet", "vae", "text_encoder",
                               "text_encoder_2")):
        mod = getattr(models, top, None)
        if mod is None:
            continue
        sd = {}
        groups: Dict[torch.dtype, List[Spec]] = {}
        for s in specs(mod):
            groups.setdefault(_dtype(s[2], served), []).append(s)
        for j, (dt, group) in enumerate(sorted(groups.items(),
                                               key=lambda kv: str(kv[0]))):
            gen = torch.Generator(device=device).manual_seed(
                (seed * 8 + idx * 2 + j) % (1 << 63))
            total = sum(math.prod(shape) for _, shape, _ in group)
            buf = torch.randn(total, generator=gen, device=device, dtype=dt)
            off = 0
            for name, shape, kind in group:
                n = math.prod(shape)
                sd[name] = _scale(buf[off:off + n].view(shape), shape, kind)
                off += n
            del buf
        out[top] = sd
    return out
