"""The check that decides ``correct``: the images that the timed
``generate`` calls returned, against the plain reference
(``portbench/reference/``) run on the same prompts and noise seeds.

The reference makes the weights again from the run's seed
(``weights.make``), tokenizes the prompts in this process, draws each
request's noise from its seed, calibrates its own UNet act ranges on the
calibration prompts and seed in the served dtype, and generates in
float32 (TF32 off) with the configuration's W / A bits fake-quantized.
It runs after the program's state is freed, one request at a time.

Each image's error is ``rms(program - reference) / std(reference)`` over
its pixels and channels; ``image_err`` is the largest over the sampled
images, ``nonfinite`` counts non-finite pixels (limit 0). With
``control``, the reference one precision below the configuration's is
put in the program's place on the same requests and judged by the same
verdict, once for each part the configuration gives a precision: the
UNet at int4 weights and acts for int8 (``unet_w4a4``), and the text
towers and the VAE at float8 for bfloat16 (``towers_vae_fp8``, the UNet
as served).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import weights
from .reference.model import Models, Quant, lower_rest
from .reference.pipeline import calibrate, draw_noise, generate, tokenize

Sample = Tuple[List[str], int, np.ndarray]  # (prompts, noise seed, images)

#: the control's bits for the precision a configuration states
LOWER = {8: 4}


def image_errors(prog, ref: torch.Tensor) -> List[float]:
    p = torch.as_tensor(prog, device=ref.device).float()
    if p.shape != ref.shape:
        return [math.inf] * ref.shape[0]
    d = (p - ref).flatten(1)
    scale = ref.flatten(1).std(1).clamp(min=1e-6)
    err = d.pow(2).mean(1).sqrt() / scale
    return [float(e) if math.isfinite(e) else math.inf for e in err.tolist()]


@torch.no_grad()
def reference(cfg: dict, seed: int, calibration: Tuple[List[str], int],
              device) -> Tuple[Models, Dict]:
    """The reference models with the run's weights, and their act ranges."""
    served = getattr(torch, cfg["dtype"])
    with torch.device(device):
        m = Models(cfg)
    made = weights.make(m, seed, device, served)
    for top, sd in made.items():
        getattr(m, top).load_state_dict(sd, strict=True)
    del made
    m.eval()
    prompts, cseed = calibration
    ids = torch.from_numpy(tokenize(prompts, cfg["text_encoder"]
                                    ["vocab_size"])).to(device)
    noise, lcm = draw_noise(cseed, len(prompts), cfg, device, served)
    return m, calibrate(m, ids, noise, lcm, served)


def verdict(errs: Sequence[float], bad: int, limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {check: {"value", "limit"}}) of the sampled images'
    errors and their count of non-finite pixels."""
    checks = {"image_err": {"value": max(errs), "limit":
                            limits["image_err"]},
              "nonfinite": {"value": float(bad), "limit": 0.0}}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def _nonfinite(images) -> int:
    a = np.asarray(images)
    return int(a.size - np.isfinite(a).sum())


@torch.no_grad()
def check(cfg: dict, seed: int, calibration, samples: Sequence[Sample],
          limits: Dict[str, float], device, control: bool = False
          ) -> Tuple[bool, Dict[str, dict], Optional[Dict[str, dict]]]:
    """(correct, {check: {"value", "limit"}}, None or, with ``control``,
    {control: {"correct", "checks"}})."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        m, ranges = reference(cfg, seed, calibration, device)
        qc = cfg["quant"]
        q = Quant("fq", qc["weight_bits"], qc["act_bits"], ranges)
        lows = {"unet_w4a4": (Quant("fq", LOWER[qc["weight_bits"]],
                                    LOWER[qc["act_bits"]], ranges), False),
                "towers_vae_fp8": (q, True)} if control else {}
        served = getattr(torch, cfg["dtype"])
        errs, bad = [], 0
        ctl = {k: ([], 0) for k in lows}
        for prompts, nseed, images in samples:
            ids = torch.from_numpy(tokenize(
                prompts, cfg["text_encoder"]["vocab_size"])).to(device)
            noise, lcm = draw_noise(nseed, len(prompts), cfg, device,
                                    served)
            ref = generate(m, ids, noise, lcm, q)
            errs += image_errors(images, ref)
            bad += _nonfinite(images)
            for k, (ql, rest) in lows.items():
                lower_rest(m, rest)
                img = generate(m, ids, noise, lcm, ql).cpu().numpy()
                lower_rest(m, False)
                ctl[k] = (ctl[k][0] + image_errors(img, ref),
                          ctl[k][1] + _nonfinite(img))
        del m
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    ok, checks = verdict(errs, bad, limits)
    readings = None
    if control:
        readings = {}
        for k, (e, b) in ctl.items():
            c_ok, c_checks = verdict(e, b, limits)
            readings[k] = {"correct": c_ok, "checks": c_checks}
    return ok, checks, readings
