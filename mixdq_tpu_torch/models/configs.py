"""Configurations of the families this port runs: the SDXL UNet, its two
CLIP text towers and its VAE, at full width (``sdxl-turbo`` at 512 px and
``sdxl`` at 1024 px); SD1.5 (``sd15``, 512 px, the LCM 4-step family:
conv ``proj_in`` / ``proj_out``, one CLIP-L tower, heads of 40 / 80 /
160); the ``tiny-sdxl`` and ``tiny-sd15`` cuts used by the CPU tests;
``small-sdxl``, a cut whose cross-attention level is two heads of 64, so
that the whole-attention kernels run on it; and ``small-sd15``, a cut
whose 64x64 level is two heads of 40, so that ``attn_impl='auto'`` runs
flash attention at d = 40 on it. Field names and values follow
``mixdq_tpu.models.configs``; the ``small-*`` cuts are the port's own."""

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
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    intermediate_size: int = 3072
    projection_dim: Optional[int] = None  # set => pooled projection head
    hidden_act: str = "quick_gelu"


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP ViT image tower (HF ``vision_model.*``). Defaults: ViT-L/14
    (openai/clip-vit-large-patch14, the standard CLIP-score backbone)."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: Optional[int] = 768
    hidden_act: str = "quick_gelu"


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.13025  # SDXL
    sample_channels: int = 3


@dataclasses.dataclass(frozen=True)
class ModelFamilyConfig:
    name: str
    unet: UNetConfig
    vae: VAEConfig
    text_encoder: CLIPTextConfig
    text_encoder_2: Optional[CLIPTextConfig] = None  # SDXL dual-encoder
    is_sdxl: bool = True
    default_steps: int = 1
    guidance_scale: float = 0.0
    #: the int8 deploy compute a CLI takes when none is asked for (the JAX
    #: family's ``default_deploy_compute``)
    default_deploy_compute: str = "int8_sec"

    @property
    def pooled_dim(self) -> int:
        """Width of the pooled text embedding (``text_embeds``): the
        second tower's projection."""
        return self.text_encoder_2.projection_dim


SDXL_UNET = UNetConfig(sample_size=128)
SDXL_TURBO_UNET = UNetConfig(sample_size=64)

SD15_UNET = UNetConfig(
    sample_size=64,
    block_out_channels=(320, 640, 1280, 1280),
    down_block_types=(
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=(
        "UpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D", "CrossAttnUpBlock2D"),
    transformer_layers_per_block=(1, 1, 1, 1),
    num_attention_heads=(8, 8, 8, 8),
    attention_head_dim=0,  # derived: channels // heads
    cross_attention_dim=768,
    use_linear_projection=False,
    addition_embed_type=None,
)

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

TINY_SD15_UNET = UNetConfig(
    sample_size=16,
    block_out_channels=(32, 64),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1,
    transformer_layers_per_block=(1, 1),
    num_attention_heads=(2, 2),
    attention_head_dim=0,
    cross_attention_dim=64,
    use_linear_projection=False,
    addition_embed_type=None,
    norm_num_groups=16,
)

#: SD1.5's layout cut to two levels: the 64x64 level is C=80 as two heads
#: of 40, so its attn1 (T = 4096, Tq * Tk = 2^24) runs flash attention at
#: d = 40 under ``attn_impl='auto'``, as SD1.5 512's does; the 32x32
#: level's heads are 80
SMALL_SD15_UNET = UNetConfig(
    sample_size=64,
    block_out_channels=(80, 160),
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    layers_per_block=1,
    transformer_layers_per_block=(1, 1),
    num_attention_heads=(2, 2),
    attention_head_dim=0,
    cross_attention_dim=64,
    use_linear_projection=False,
    addition_embed_type=None,
    norm_num_groups=16,
)

CLIP_L = CLIPTextConfig()  # CLIP ViT-L/14 text tower
CLIP_BIGG = CLIPTextConfig(
    hidden_size=1280, num_layers=32, num_heads=20, intermediate_size=5120,
    projection_dim=1280, hidden_act="gelu")
SDXL_VAE = VAEConfig()
SD15_VAE = VAEConfig(scaling_factor=0.18215)

TINY_CLIP = CLIPTextConfig(
    vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
    intermediate_size=128, max_position_embeddings=77)
TINY_CLIP_2 = CLIPTextConfig(
    vocab_size=1000, hidden_size=64, num_layers=2, num_heads=2,
    intermediate_size=128, max_position_embeddings=77, projection_dim=64)
# 4 blocks => the standard 8x spatial factor between pixels and latents
TINY_VAE = VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                     norm_num_groups=8)
#: ``small-sdxl``'s towers: 32 + 32 = its cross-attention width, and a
#: pooled projection of 32 (its ``text_embeds``)
SMALL_CLIP = CLIPTextConfig(
    vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
    intermediate_size=64, max_position_embeddings=77)
SMALL_CLIP_2 = dataclasses.replace(SMALL_CLIP, projection_dim=32,
                                   hidden_act="gelu")

FAMILIES = {
    "sdxl-turbo": ModelFamilyConfig(
        "sdxl-turbo", SDXL_TURBO_UNET, SDXL_VAE, CLIP_L, CLIP_BIGG,
        is_sdxl=True, default_steps=1, guidance_scale=0.0),
    "sdxl": ModelFamilyConfig(
        "sdxl", SDXL_UNET, SDXL_VAE, CLIP_L, CLIP_BIGG, is_sdxl=True,
        default_steps=30, guidance_scale=7.5),
    "sd15": ModelFamilyConfig(
        "sd15", SD15_UNET, SD15_VAE, CLIP_L, is_sdxl=False,
        default_steps=4, guidance_scale=1.0),
    "tiny-sdxl": ModelFamilyConfig(
        "tiny-sdxl", TINY_SDXL_UNET, TINY_VAE, TINY_CLIP, TINY_CLIP_2,
        is_sdxl=True, default_steps=1, guidance_scale=0.0),
    "tiny-sd15": ModelFamilyConfig(
        "tiny-sd15", TINY_SD15_UNET, TINY_VAE, TINY_CLIP, is_sdxl=False,
        default_steps=4, guidance_scale=1.0),
    "small-sdxl": ModelFamilyConfig(
        "small-sdxl", SMALL_SDXL_UNET, TINY_VAE, SMALL_CLIP, SMALL_CLIP_2,
        is_sdxl=True, default_steps=1, guidance_scale=0.0),
    "small-sd15": ModelFamilyConfig(
        "small-sd15", SMALL_SD15_UNET, TINY_VAE, TINY_CLIP, is_sdxl=False,
        default_steps=4, guidance_scale=1.0),
}


def get_family(name: str) -> ModelFamilyConfig:
    if name not in FAMILIES:
        raise KeyError(f"unknown model family {name!r}; have {sorted(FAMILIES)}")
    return FAMILIES[name]
