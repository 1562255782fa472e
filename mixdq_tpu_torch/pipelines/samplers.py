"""Diffusion samplers as pure functions over static schedule tables (port
of ``mixdq_tpu/pipelines/samplers.py``).

Schedules are numpy tables computed on the host (copies of the JAX
package's arithmetic); each step is a pure function of device tensors, so
a denoise loop of them captures into one CUDA graph. Sigma and alpha
arithmetic runs in float32 whatever the latent dtype, as in the
reference, where the f32 schedule scalars promote the latents.

* ``EulerSchedule`` -- EulerDiscreteScheduler semantics (SDXL / SDXL-Turbo;
  'trailing' spacing gives the 1-step Turbo timestep 999).
* ``LCMSchedule`` -- LCMScheduler semantics for SD1.5 + LCM-LoRA.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


def _alphas_cumprod(num_train_timesteps: int = 1000,
                    beta_start: float = 0.00085,
                    beta_end: float = 0.012) -> np.ndarray:
    """scaled_linear beta schedule (SD family default)."""
    betas = np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def _f32(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Euler discrete
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EulerSchedule:
    timesteps: Tuple[float, ...]  # [S]
    sigmas: Tuple[float, ...]  # [S+1], last entry 0.0
    init_noise_sigma: float
    num_steps: int

    def timesteps_array(self, device=None) -> torch.Tensor:
        return _f32(self.timesteps, device)

    def sigmas_array(self, device=None) -> torch.Tensor:
        return _f32(self.sigmas, device)


def make_euler_schedule(
    num_steps: int,
    num_train_timesteps: int = 1000,
    timestep_spacing: str = "trailing",
) -> EulerSchedule:
    acp = _alphas_cumprod(num_train_timesteps)
    all_sigmas = np.sqrt((1.0 - acp) / acp)
    if timestep_spacing == "trailing":
        # SDXL-Turbo: arange(T, 0, -T/S) - 1 -> 1-step = [999]
        ts = np.arange(num_train_timesteps, 0,
                       -num_train_timesteps / num_steps).round()[::-1] - 1
        ts = ts[::-1].astype(np.float64)  # descending
    elif timestep_spacing == "linspace":
        ts = np.linspace(0, num_train_timesteps - 1, num_steps,
                         dtype=np.float64)[::-1]
    elif timestep_spacing == "leading":
        step = num_train_timesteps // num_steps
        ts = (np.arange(num_steps) * step).round()[::-1].astype(np.float64)
    else:
        raise ValueError(timestep_spacing)
    # interpolate sigma at (possibly fractional) timesteps
    sig = np.interp(ts, np.arange(num_train_timesteps), all_sigmas)
    sigmas = np.concatenate([sig, [0.0]])
    init_noise_sigma = float(np.sqrt(sig.max() ** 2 + 1.0))
    return EulerSchedule(tuple(ts.tolist()), tuple(sigmas.tolist()),
                         init_noise_sigma, num_steps)


def euler_scale_model_input(sample: torch.Tensor,
                            sigma: torch.Tensor) -> torch.Tensor:
    """The UNet input at ``sigma`` (f32)."""
    return sample.float() / torch.sqrt(sigma**2 + 1.0)


def euler_step(sample: torch.Tensor, model_output: torch.Tensor,
               sigma: torch.Tensor, sigma_next: torch.Tensor) -> torch.Tensor:
    """One Euler step, epsilon-prediction (f32)."""
    sample = sample.float()
    denoised = sample - sigma * model_output.float()
    derivative = (sample - denoised) / sigma
    return sample + derivative * (sigma_next - sigma)


# ---------------------------------------------------------------------------
# LCM
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LCMSchedule:
    timesteps: Tuple[int, ...]
    alphas_cumprod: Tuple[float, ...]  # acp at each timestep
    alphas_cumprod_prev: Tuple[float, ...]  # acp at the next (lower) timestep
    num_steps: int
    timestep_scaling: float = 10.0
    sigma_data: float = 0.5

    def timesteps_array(self, device=None) -> torch.Tensor:
        return _f32(self.timesteps, device)

    def alphas_cumprod_array(self, device=None) -> torch.Tensor:
        return _f32(self.alphas_cumprod, device)

    def alphas_cumprod_prev_array(self, device=None) -> torch.Tensor:
        return _f32(self.alphas_cumprod_prev, device)


def make_lcm_schedule(
    num_steps: int,
    original_inference_steps: int = 50,
    num_train_timesteps: int = 1000,
) -> LCMSchedule:
    acp = _alphas_cumprod(num_train_timesteps)
    k = num_train_timesteps // original_inference_steps
    lcm_origin = np.arange(1, original_inference_steps + 1) * k - 1  # ascending
    skip = original_inference_steps // num_steps
    ts = lcm_origin[::-skip][:num_steps]  # descending
    acp_t = acp[ts]
    prev_ts = np.concatenate([ts[1:], [-1]])
    acp_prev = np.where(prev_ts >= 0, acp[np.clip(prev_ts, 0, None)], 1.0)
    return LCMSchedule(tuple(int(t) for t in ts), tuple(acp_t.tolist()),
                       tuple(acp_prev.tolist()), num_steps)


def lcm_step(sample, model_output, acp_t, acp_prev, timestep, noise,
             timestep_scaling: float = 10.0, sigma_data: float = 0.5,
             is_last: bool = False):
    """One LCM consistency step (epsilon-parameterized model), f32:
    ``(next latents, denoised)``; the schedule scalars are f32 tensors."""
    sample = sample.float()
    sqrt_acp = torch.sqrt(acp_t)
    sqrt_1macp = torch.sqrt(1.0 - acp_t)
    x0_pred = (sample - sqrt_1macp * model_output.float()) / sqrt_acp
    s = timestep * timestep_scaling
    c_skip = sigma_data**2 / (s**2 + sigma_data**2)
    c_out = s / torch.sqrt(s**2 + sigma_data**2)
    denoised = c_out * x0_pred + c_skip * sample
    if is_last:
        return denoised, denoised
    nxt = torch.sqrt(acp_prev) * denoised + torch.sqrt(1.0 - acp_prev) * noise
    return nxt, denoised
