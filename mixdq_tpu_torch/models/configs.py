"""UNet configurations of the families this port runs (the SDXL UNet
architecture at full width: ``sdxl-turbo`` at 512 px and ``sdxl`` at
1024 px; the ``tiny-sdxl`` cut used by the CPU tests, and ``small-sdxl``,
a cut whose cross-attention level is two heads of 64, so that the
whole-attention kernels run on it). Field names and values follow
``mixdq_tpu.models.configs``."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    down_block_types: Tuple[str, ...] = (
        "DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D")
    up_block_types: Tuple[str, ...] = (
        "CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D")
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 2, 10)
    num_attention_heads: Tuple[int, ...] = (5, 10, 20)
    attention_head_dim: int = 64
    cross_attention_dim: int = 2048
    use_linear_projection: bool = True
    addition_embed_type: Optional[str] = "text_time"  # SDXL micro-conds
    addition_time_embed_dim: int = 256
    # text_embeds dim + 6 * addition_time_embed_dim (SDXL: 1280 + 1536)
    projection_class_embeddings_input_dim: int = 2816
    norm_num_groups: int = 32

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


@dataclasses.dataclass(frozen=True)
class ModelFamilyConfig:
    name: str
    unet: UNetConfig
    #: width of the pooled text embedding (``text_embeds``)
    pooled_dim: int


SDXL_UNET = UNetConfig(sample_size=128)
SDXL_TURBO_UNET = UNetConfig(sample_size=64)

TINY_SDXL_UNET = UNetConfig(
    sample_size=16,
    block_out_channels=(32, 64),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
    layers_per_block=2,
    transformer_layers_per_block=(1, 2),
    num_attention_heads=(2, 2),
    attention_head_dim=16,
    cross_attention_dim=128,
    addition_time_embed_dim=32,
    projection_class_embeddings_input_dim=32 * 6 + 64,
    norm_num_groups=16,
)

#: the cross-attention level is C=128 as two heads of 64: the JAX package's
#: gates admit ``sec_attention_qkv`` and ``sec_attention_q_out`` there,
#: where ``tiny-sdxl``'s 2 heads of 16 route every attention site to the
#: einsum chain under ``attn_impl='auto'``
SMALL_SDXL_UNET = UNetConfig(
    sample_size=16,
    block_out_channels=(32, 128),
    down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
    up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
    layers_per_block=1,
    transformer_layers_per_block=(1, 1),
    num_attention_heads=(1, 2),
    attention_head_dim=64,
    cross_attention_dim=64,
    addition_time_embed_dim=16,
    projection_class_embeddings_input_dim=16 * 6 + 32,
    norm_num_groups=16,
)

FAMILIES = {
    "sdxl-turbo": ModelFamilyConfig("sdxl-turbo", SDXL_TURBO_UNET, 1280),
    "sdxl": ModelFamilyConfig("sdxl", SDXL_UNET, 1280),
    "tiny-sdxl": ModelFamilyConfig("tiny-sdxl", TINY_SDXL_UNET, 64),
    "small-sdxl": ModelFamilyConfig("small-sdxl", SMALL_SDXL_UNET, 32),
}


def get_family(name: str) -> ModelFamilyConfig:
    if name not in FAMILIES:
        raise KeyError(f"unknown model family {name!r}; have {sorted(FAMILIES)}")
    return FAMILIES[name]
