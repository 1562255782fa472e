"""Text-to-image pipeline of the SDXL families (port of
``mixdq_tpu/pipelines/txt2img.py``): tokens -> both CLIP towers -> the
denoise loop over the port's UNet -> VAE decode.

Classifier-free guidance runs as a doubled batch (uncond first, diffusers
convention). The Euler loop casts each step's f32 result back to the
latent dtype; the LCM loop takes ``denoised`` at its last step. With
``capture`` the loop returns its trajectory (each step's UNet input and
output, stacked), the reference's calibration record.

The loop is plain device code: every schedule scalar is a device tensor
built before it runs, and nothing reads a value back to the host, so a
caller can capture the whole generation in one CUDA graph
(``pipelines/serving.py``). Noise comes from a ``torch.Generator`` that
the caller seeds.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.clip import CLIPTextModel
from ..models.configs import ModelFamilyConfig, get_family
from ..models.unet import UNet2DConditionModel, conv_shortcut_splits
from ..models.vae import AutoencoderKL
from ..pipeline import resolve_device
from ..quant.state import FP_CTX, QuantCtx
from ..utils import profiling
from ..utils.tokenizer import load_tokenizer
from . import samplers

Schedule = Union[samplers.EulerSchedule, samplers.LCMSchedule]


@dataclasses.dataclass
class PipelineOutput:
    images: Optional[np.ndarray]  # [B, H, W, 3] float in [0, 1]
    latents: Optional[torch.Tensor] = None
    # trajectory capture (calibration data), shapes [S, B, ...]:
    trajectory: Optional[torch.Tensor] = None  # scaled UNet input latents
    timesteps: Optional[torch.Tensor] = None  # [S]
    unet_outputs: Optional[torch.Tensor] = None
    text_emb: Optional[torch.Tensor] = None  # [B, 77, D]
    added_conds: Optional[Dict[str, torch.Tensor]] = None


def make_schedule(family: ModelFamilyConfig, steps: int) -> Schedule:
    """Euler discrete for the SDXL families, LCM for SD1.5 + LCM-LoRA."""
    return (samplers.make_euler_schedule(steps) if family.is_sdxl
            else samplers.make_lcm_schedule(steps))


class ScheduleTensors:
    """A schedule's tables as f32 device tensors, built once, before any
    loop that reads them (a loop inside a captured graph must not copy
    from the host)."""

    def __init__(self, schedule: Schedule, device):
        self.schedule = schedule
        self.timesteps = schedule.timesteps_array(device)
        if isinstance(schedule, samplers.EulerSchedule):
            self.sigmas = schedule.sigmas_array(device)
        else:
            self.acp = schedule.alphas_cumprod_array(device)
            self.acp_prev = schedule.alphas_cumprod_prev_array(device)


class Text2ImgPipeline:
    """The family's modules (UNet, VAE, the CLIP towers) on ``device``
    (CUDA unless ``'cpu'`` is asked for) and its tokenizer (CLIP BPE from
    ``tokenizer_path``, else ``HashTokenizer``). Weights are random until
    ``init_weights`` or a ``load_state_dict`` of each module."""

    def __init__(self, family, dtype=torch.float32, device=None,
                 tokenizer_path: Optional[str] = None):
        self.family: ModelFamilyConfig = (
            get_family(family) if isinstance(family, str) else family)
        f = self.family
        self.dtype = dtype
        self.device = resolve_device(device)
        kw = dict(dtype=dtype, device=self.device)
        self.unet = UNet2DConditionModel(f.unet, **kw).eval()
        self.vae = AutoencoderKL(f.vae, **kw).eval()
        self.text_encoder = CLIPTextModel(f.text_encoder, **kw).eval()
        self.text_encoder_2 = (CLIPTextModel(f.text_encoder_2, **kw).eval()
                               if f.text_encoder_2 is not None else None)
        self.tokenizer = load_tokenizer(tokenizer_path,
                                        f.text_encoder.vocab_size)
        #: channel splits of the up blocks' concat-shortcut convs
        #: (calibration and deploy take them: ``conv_split`` entries)
        self.splits = conv_shortcut_splits(f.unet)

    def init_weights(self, seed: int = 0) -> "Text2ImgPipeline":
        """Random weights: the UNet as ``pipeline.build_unet(seed)``, the
        VAE and the towers from generators seeded ``seed + 1`` .. ``+ 3``."""
        self.unet.init_weights(seed)

        def gen(i):
            return torch.Generator(device=self.device).manual_seed(seed + i)

        self.vae.init_weights(gen(1))
        self.text_encoder.init_weights(gen(2))
        if self.text_encoder_2 is not None:
            self.text_encoder_2.init_weights(gen(3))
        return self

    def tokens(self, prompts: Sequence[str]) -> torch.Tensor:
        """``[B, 77]`` token ids on the device."""
        return torch.from_numpy(self.tokenizer(list(prompts))).to(
            self.device)

    # ------------------------------------------------------------------
    # Prompt encoding
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def encode_prompt(self, token_ids: torch.Tensor,
                      token_ids_2: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(prompt embeds ``[B, 77, D]``, pooled ``[B, P]`` or None).
        SDXL: both towers' penultimate states concatenated, pooled from
        tower 2's projection; otherwise tower 1's final state."""
        if self.family.is_sdxl:
            _, pen1, _ = self.text_encoder(token_ids)
            _, pen2, pooled = self.text_encoder_2(
                token_ids if token_ids_2 is None else token_ids_2)
            return torch.cat([pen1, pen2], -1), pooled
        last, _, _ = self.text_encoder(token_ids)
        return last, None

    def default_time_ids(self, B: int, height: int, width: int
                         ) -> torch.Tensor:
        # [orig_h, orig_w, crop_top, crop_left, target_h, target_w]
        row = torch.tensor([height, width, 0, 0, height, width],
                           dtype=self.dtype)
        return row[None].repeat(B, 1).to(self.device)

    def added_conds(self, pooled, time_ids) -> Optional[Dict[str, Any]]:
        if self.family.unet.addition_embed_type != "text_time":
            return None
        return {"text_embeds": pooled, "time_ids": time_ids}

    def make_noise(self, B: int, height: int, width: int,
                   generator: torch.Generator) -> torch.Tensor:
        """Unit normal initial noise ``[B, h/8, w/8, C]`` in the model
        dtype from ``generator``."""
        return torch.randn(
            (B, height // 8, width // 8, self.family.unet.in_channels),
            generator=generator, device=self.device, dtype=self.dtype)

    # ------------------------------------------------------------------
    # Sampling core
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def sample_latents(
        self,
        prompt_embeds: torch.Tensor,
        added_conds: Optional[Dict[str, torch.Tensor]],
        latents: torch.Tensor,  # [B, h, w, 4] pre-scaled noise
        schedule: Union[Schedule, ScheduleTensors],
        guidance_scale: float = 0.0,
        neg_prompt_embeds: Optional[torch.Tensor] = None,
        neg_added_conds: Optional[Dict[str, torch.Tensor]] = None,
        ctx: QuantCtx = FP_CTX,
        capture: bool = False,
        lcm_noise: Optional[torch.Tensor] = None,
    ):
        """Run the denoise loop: (latents, trajectory dict or None). CFG
        doubles the batch when ``guidance_scale > 1`` and negative embeds
        are given. ``lcm_noise`` ``[S, B, h, w, 4]``: the LCM loop's noise
        (zeros if None). Each step's UNet call lies between the marks
        ``unet.begin`` and ``unet.end`` (``utils.profiling.mark``)."""
        st = (schedule if isinstance(schedule, ScheduleTensors)
              else ScheduleTensors(schedule, latents.device))
        sch = st.schedule
        do_cfg = guidance_scale > 1.0 and neg_prompt_embeds is not None
        if do_cfg:
            embeds = torch.cat([neg_prompt_embeds, prompt_embeds], 0)
            added = (None if added_conds is None else
                     {k: torch.cat([neg_added_conds[k], added_conds[k]], 0)
                      for k in added_conds})
        else:
            embeds, added = prompt_embeds, added_conds

        def eps_of(model_in, t):
            if do_cfg:
                model_in = torch.cat([model_in, model_in], 0)
            profiling.mark("unet.begin")
            eps = self.unet(model_in, t, embeds, added, ctx=ctx)
            profiling.mark("unet.end")
            if do_cfg:
                eps_u, eps_c = eps.chunk(2, 0)
                eps = eps_u + guidance_scale * (eps_c - eps_u)
            return eps

        ins, outs = [], []
        S = sch.num_steps
        euler = isinstance(sch, samplers.EulerSchedule)
        if not euler and lcm_noise is None:
            lcm_noise = torch.zeros((S,) + tuple(latents.shape),
                                    dtype=latents.dtype,
                                    device=latents.device)
        for i in range(S):
            t = st.timesteps[i]
            if euler:
                sigma, sigma_next = st.sigmas[i], st.sigmas[i + 1]
                lat_in = samplers.euler_scale_model_input(latents, sigma)
                eps = eps_of(lat_in, t)
                new = samplers.euler_step(latents, eps, sigma, sigma_next)
            else:
                lat_in = latents
                eps = eps_of(lat_in, t)
                nxt, denoised = samplers.lcm_step(
                    latents, eps, st.acp[i], st.acp_prev[i], t, lcm_noise[i],
                    timestep_scaling=sch.timestep_scaling,
                    sigma_data=sch.sigma_data)
                new = denoised if i == S - 1 else nxt
            if capture:
                ins.append(lat_in)
                outs.append(eps)
            latents = new.to(latents.dtype)
        traj = None
        if capture:
            traj = {"trajectory": torch.stack(ins),
                    "unet_outputs": torch.stack(outs),
                    "timesteps": st.timesteps}
        return latents, traj

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor, vae_ctx: QuantCtx = FP_CTX
               ) -> torch.Tensor:
        """Images in [0, 1]: ``clip(vae.decode(latents) / 2 + 0.5, 0, 1)``."""
        img = self.vae.decode(latents, vae_ctx)
        return (img / 2 + 0.5).clamp(0.0, 1.0)

    # ------------------------------------------------------------------
    # Full pipeline
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def __call__(
        self,
        prompts: Sequence[str],
        seed: int = 0,
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        ctx: QuantCtx = FP_CTX,
        capture_trajectory: bool = False,
        negative_prompts: Optional[Sequence[str]] = None,
        decode: bool = True,
        vae_ctx: QuantCtx = FP_CTX,
        noise: Optional[torch.Tensor] = None,
    ) -> PipelineOutput:
        """Generate for ``prompts``. The initial noise is ``noise`` (unit
        normal, unscaled) or drawn from a generator seeded ``seed``
        (``make_noise``), which then draws the LCM loop's noise."""
        f = self.family
        steps = num_inference_steps or f.default_steps
        g = f.guidance_scale if guidance_scale is None else guidance_scale
        B = len(prompts)
        height = height or f.unet.sample_size * 8
        width = width or f.unet.sample_size * 8

        embeds, pooled = self.encode_prompt(self.tokens(prompts))
        time_ids = self.default_time_ids(B, height, width)
        added = self.added_conds(pooled, time_ids)
        neg_embeds, neg_added = None, None
        if g > 1.0:
            neg = negative_prompts or [""] * B
            neg_embeds, neg_pooled = self.encode_prompt(self.tokens(neg))
            neg_added = self.added_conds(neg_pooled, time_ids)

        schedule = make_schedule(f, steps)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if noise is None:
            noise = self.make_noise(B, height, width, gen)
        latents, lcm_noise = noise.to(self.device, self.dtype), None
        if isinstance(schedule, samplers.EulerSchedule):
            latents = latents * schedule.init_noise_sigma
        else:
            lcm_noise = torch.randn((steps,) + tuple(latents.shape),
                                    generator=gen, device=self.device,
                                    dtype=self.dtype)
        latents, traj = self.sample_latents(
            embeds, added, latents, schedule, g, neg_embeds, neg_added, ctx,
            capture_trajectory, lcm_noise)
        images = None
        if decode:
            images = self.decode(latents, vae_ctx).float().cpu().numpy()
        return PipelineOutput(
            images=images, latents=latents,
            trajectory=None if traj is None else traj["trajectory"],
            timesteps=None if traj is None else traj["timesteps"],
            unet_outputs=None if traj is None else traj["unet_outputs"],
            text_emb=embeds, added_conds=added)
