"""The operation counts of ``portbench/counts.py``, from sizes alone,
against ``torch.utils.flop_counter.FlopCounterMode`` on the plain
reference at small sizes, and against the per-image work of the full
configurations."""

from __future__ import annotations

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import catalog, counts, weights
from portbench.reference.model import Models
from portbench.reference.pipeline import draw_noise, time_ids

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _small(name):
    return json.load(open(os.path.join(DATA, name)))


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("name", ["small_sdxl.json", "tiny_sd15.json"])
def test_counts_equal_flop_counter(name):
    cfg = _small(name)
    torch.manual_seed(0)
    m = Models(cfg)
    for top, sd in weights.make(m, 7, "cpu", torch.float32).items():
        getattr(m, top).load_state_dict(sd)
    B, T = 2, counts.TEXT_TOKENS
    ids = torch.randint(0, 990, (B, T))
    x, _ = draw_noise(1, B, cfg, "cpu", torch.float32)
    with torch.no_grad():
        ehs, pooled = m.encode(ids, torch.float32)
        tid = time_ids(cfg, B, "cpu", torch.float32) if m.sdxl else None
        t = torch.full((B,), 999.0)
        unet = _flops(lambda: m.unet(x, t, ehs, pooled, tid))
        towers = _flops(lambda: m.encode(ids, torch.float32))
        vae = _flops(lambda: m.vae.decode(x))
    ops = lambda layers, part: sum(o for p, _, o, _ in layers if p == part)
    assert unet == B * ops(counts.unet_layers(cfg), "unet")
    tl = counts.tower_layers(cfg["text_encoder"], False)
    if "text_encoder_2" in cfg:
        tl += counts.tower_layers(cfg["text_encoder_2"], True)
    assert towers == B * ops(tl, "towers")
    assert vae == B * ops(counts.vae_layers(cfg), "vae")


@pytest.mark.parametrize("config,unet_tflop,tower_tflop", [
    ("sdxl_turbo-w8a8", 1.589, 0.111), ("sd15_lcm-w8a8", 0.803, 0.013)])
def test_full_configurations(config, unet_tflop, tower_tflop):
    """Per 512 px image: the UNet step, the towers and the VAE decoder as
    torch's flop counter read them on the program's models at these
    sizes (1.589 / 0.803, 0.111 / 0.013, 2.515 TFLOP)."""
    cfg = catalog.config(catalog.benchmark(), config)
    gen = counts.generation_layers(cfg)
    tf = lambda part: sum(o for p, _, o, _ in gen if p == part) / 1e12
    assert tf("unet") / cfg["steps"] == pytest.approx(unet_tflop, rel=2e-3)
    assert tf("towers") == pytest.approx(tower_tflop, abs=5e-4)
    assert tf("vae") == pytest.approx(2.515, rel=2e-3)
    s = counts.summary(cfg)
    assert 0 < s["unet_least_roofline_s"] < s["generation_least_compute_s"] \
        * 2
