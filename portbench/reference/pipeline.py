"""The plain reference of one whole generation: prompts -> tokens -> the
text towers -> the sampler loop over the UNet -> the VAE decode -> images
in [0, 1], and the W8A8 calibration that sets the UNet's act ranges.

The tokenizer is the hash tokenizer the served configuration names
(``tokenizer`` in its file: no vocabulary ships with the weights made
from a seed): a word's id is Python's ``hash`` of it modulo ``vocab - 2``,
between BOS (``vocab - 2``) and EOS (``vocab - 1``), padded with EOS to 77.
Its ids depend on ``PYTHONHASHSEED``, so the reference tokenizes in the
process that served the prompts.

The noise of a request with seed ``s`` is what a CUDA (or CPU)
``torch.Generator`` seeded ``s`` draws first: unit normals ``[B, h, w, 4]``
in the served dtype, then, for LCM, ``[S, B, h, w, 4]`` for the loop.

Samplers: Euler discrete with 'trailing' spacing (SDXL-Turbo's
scheduler: one step is t = 999) and LCM (``LCMScheduler`` of the
LCM-LoRA card: 50 original steps, skip ``50 // S``, timestep scaling 10,
sigma_data 0.5), over the scaled-linear betas 0.00085 .. 0.012 of SD.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .model import FP, Models, Quant


def tokenize(prompts: Sequence[str], vocab: int, length: int = 77
             ) -> np.ndarray:
    bos, eos = vocab - 2, vocab - 1
    out = np.full((len(prompts), length), eos, dtype=np.int64)
    for i, p in enumerate(prompts):
        ids = [bos] + [hash(w) % (vocab - 2)
                       for w in p.split()[:length - 2]] + [eos]
        out[i, :len(ids)] = ids
    return out


def alphas_cumprod(n: int = 1000) -> np.ndarray:
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, n,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def euler_schedule(steps: int):
    """(timesteps, sigmas with a final 0, init sigma) of 'trailing'."""
    acp = alphas_cumprod()
    ts = (np.arange(1000, 0, -1000 / steps).round() - 1).astype(np.float64)
    sig = np.interp(ts, np.arange(1000), np.sqrt((1 - acp) / acp))
    return ts, np.concatenate([sig, [0.0]]), float(np.sqrt(sig.max() ** 2
                                                           + 1))


def lcm_schedule(steps: int):
    """(timesteps, acp at each, acp at the next)."""
    acp = alphas_cumprod()
    origin = np.arange(1, 51) * 20 - 1
    ts = origin[::-(50 // steps)][:steps]
    nxt = np.concatenate([ts[1:], [-1]])
    return ts, acp[ts], np.where(nxt >= 0, acp[np.clip(nxt, 0, None)], 1.0)


def draw_noise(seed: int, batch: int, cfg: dict, device, dtype):
    """(noise, LCM loop noise or None) of a request seeded ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h = cfg["unet"]["sample_size"]
    noise = torch.randn((batch, h, h, cfg["unet"]["in_channels"]),
                        generator=gen, device=device, dtype=dtype)
    lcm = None
    if cfg["scheduler"] == "lcm":
        lcm = torch.randn((cfg["steps"],) + tuple(noise.shape),
                          generator=gen, device=device, dtype=dtype)
    return noise, lcm


def time_ids(cfg: dict, batch: int, device, dtype):
    """SDXL micro-conditioning: (orig h, w, crop top, left, target h, w)."""
    px = cfg["unet"]["sample_size"] * 8
    row = torch.tensor([px, px, 0, 0, px, px], dtype=dtype, device=device)
    return row[None].repeat(batch, 1)


@torch.no_grad()
def denoise(m: Models, ids: torch.Tensor, noise: torch.Tensor,
            lcm_noise: Optional[torch.Tensor], q: Quant = FP,
            dtype=torch.float32, record: Optional[List] = None
            ) -> torch.Tensor:
    """The sampled latents in float32 (the loop carries ``dtype``);
    ``record`` collects each step's UNet input, timestep, text embedding
    and pooled embedding (the calibration batch)."""
    cfg = m.cfg
    B = ids.shape[0]
    ehs, pooled = m.encode(ids, dtype)
    tid = time_ids(cfg, B, ids.device, dtype) if m.sdxl else None
    S = cfg["steps"]
    lat = noise.to(dtype)
    if cfg["scheduler"] == "euler":
        ts, sig, init = euler_schedule(S)
        lat = lat * init
    else:
        ts, acp, acp_next = lcm_schedule(S)
    for i in range(S):
        t = torch.full((B,), float(ts[i]), device=ids.device)
        if cfg["scheduler"] == "euler":
            x_in = (lat.float() / float(np.sqrt(sig[i] ** 2 + 1))).to(dtype)
        else:
            x_in = lat
        if record is not None:
            record.append((x_in, t, ehs, pooled, tid))
        eps = m.unet(x_in, t, ehs, pooled, tid, q).float()
        if cfg["scheduler"] == "euler":
            new = lat.float() + eps * float(sig[i + 1] - sig[i])
        else:
            a, a_next = float(acp[i]), float(acp_next[i])
            x0 = (lat.float() - np.sqrt(1 - a) * eps) / np.sqrt(a)
            s = float(ts[i]) * 10.0
            c_skip = 0.25 / (s * s + 0.25)
            c_out = s / np.sqrt(s * s + 0.25)
            new = c_out * x0 + c_skip * lat.float()
            if i < S - 1:
                new = (np.sqrt(a_next) * new
                       + np.sqrt(1 - a_next) * lcm_noise[i].float())
        lat = new.to(dtype)
    return lat.float()


@torch.no_grad()
def decode(m: Models, latents: torch.Tensor, dtype=torch.float32
           ) -> torch.Tensor:
    img = m.vae.decode(latents.to(dtype)).float()
    return (img / 2 + 0.5).clamp(0.0, 1.0)


@torch.no_grad()
def calibrate(m: Models, ids: torch.Tensor, noise, lcm_noise,
              dtype) -> Dict:
    """The UNet's act ranges: one pass of the loop in ``dtype`` records
    every step's UNet input, then the UNet runs once on all steps stacked
    along the batch (each with its timestep), and every quantized layer
    records the min and max of its input."""
    rec: List = []
    denoise(m, ids, noise, lcm_noise, FP, dtype, rec)
    x, t, ehs, pooled, tid = (
        None if rec[0][k] is None else torch.cat([r[k] for r in rec])
        for k in range(5))
    q = Quant("calib")
    m.unet(x, t, ehs, pooled, tid, q)
    return q.ranges


@torch.no_grad()
def generate(m: Models, ids: torch.Tensor, noise, lcm_noise,
             q: Quant = FP, dtype=torch.float32) -> torch.Tensor:
    """Images ``[B, H, W, 3]`` float32 in [0, 1]."""
    return decode(m, denoise(m, ids, noise, lcm_noise, q, dtype), dtype)
