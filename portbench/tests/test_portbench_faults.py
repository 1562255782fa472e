"""``correct`` fails where it must: a run driven through the harness on
the CPU (the look for a chip skipped) with the timed path broken
underneath — a sampler step that returns its state unchanged, half of
the batch left out and the mean of the rest put in its place, one image
altered where the VAE produces it — and the controls, the reference
one precision down (a W4A4 UNet; float8 towers and VAE) judged in the
program's place by the same verdict, at a size a test holds. The control's chip readings at the cells' own sizes come
from ``portbench/control.py``; the card-only case runs it for one seed.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness

CELLS = ["small_sdxl.b2", "tiny_sd15.b2"]
SEED = 2 ** 32 + 17


def _run(checkout, cell, control=False):
    return harness.run_cell(cell, SEED, 0.4, False, torch.device("cpu"),
                            time.time(), checkout, control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_control_is_not(checkout, cell):
    out = _run(checkout, cell, control=True)
    assert out["correct"] is True
    lim = out["checks"]["image_err"]["limit"]
    assert lim > out["checks"]["image_err"]["value"]
    ctl = out["control"]
    assert set(ctl) == {"unet_w4a4", "towers_vae_fp8"}
    # each control through the same verdict; the W4A4 UNet fails it
    for c in ctl.values():
        assert set(c["checks"]) == set(out["checks"])
        assert c["correct"] is (c["checks"]["image_err"]["value"] <= lim)
    assert ctl["unet_w4a4"]["correct"] is False


def _step_unchanged(monkeypatch):
    from mixdq_tpu_torch.pipelines import samplers

    monkeypatch.setattr(samplers, "euler_step",
                        lambda sample, *a, **k: sample.float())
    monkeypatch.setattr(samplers, "lcm_step",
                        lambda sample, *a, **k: (sample.float(),
                                                 sample.float()))


def _half_batch(monkeypatch):
    from mixdq_tpu_torch.pipelines.serving import ServingEngine

    run = ServingEngine.run

    def half(self, *args):
        img = run(self, *args)
        h = img.shape[0] // 2
        return torch.cat([img[:h], img[:h].mean(0, keepdim=True).expand(
            img.shape[0] - h, *img.shape[1:])])

    monkeypatch.setattr(ServingEngine, "run", half)


def _answer_altered(monkeypatch):
    from mixdq_tpu_torch.pipelines.txt2img import Text2ImgPipeline

    decode = Text2ImgPipeline.decode

    def altered(self, latents, vae_ctx=None):
        img = decode(self, latents) if vae_ctx is None else \
            decode(self, latents, vae_ctx)
        return torch.cat([img[:-1], img[-1:].flip(1)])

    monkeypatch.setattr(Text2ImgPipeline, "decode", altered)


@pytest.mark.parametrize("fault", [_step_unchanged, _half_batch,
                                   _answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_run_incorrect(checkout, monkeypatch, cell, fault):
    fault(monkeypatch)
    out = _run(checkout, cell)
    assert out["correct"] is False
    c = out["checks"]["image_err"]
    assert c["value"] > c["limit"]


@pytest.mark.gpu
def test_control_readings_on_the_card(tmp_path):
    """One seed of ``control.py`` at the full size of the B = 1 cell: the
    program's reading under its limit; each control, through the same
    verdict, not correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's readings at a "
                    "cell's own size are taken on the card")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = tmp_path / "r.jsonl"
    subprocess.run([sys.executable, "portbench/control.py", "--workload",
                    "sdxl_turbo-w8a8.b1", "--seeds", "977", "--control-seeds",
                    "977", "--seconds", "2", "--out", str(out)], cwd=root,
                   check=True)
    import json
    d = json.loads(out.read_text().splitlines()[-1])
    assert d["correct"]
    assert all(not c["correct"] for c in d["control"].values())
