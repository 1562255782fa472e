"""The plain reference: it imports nothing of the program or of JAX (an
AST scan, top-level names compared whole), and unquantized it computes
what the program's float32 pipeline computes at small sizes (so its
architecture is the program's), while the W8A8 fake-quant recipe moves
it off that by what quantization costs."""

from __future__ import annotations

import ast
import json
import os

import numpy as np
import pytest
import torch

from portbench import serve
from portbench.reference.model import FP, Models, Quant
from portbench.reference.pipeline import (calibrate, draw_noise, generate,
                                          tokenize)

HERE = os.path.dirname(os.path.abspath(__file__))
PB = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "mixdq_tpu", "mixdq_tpu_torch"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(PB, "reference")
    files = [os.path.join(ref, f) for f in os.listdir(ref)
             if f.endswith(".py")]
    assert len(files) >= 3
    for f in files:
        assert not set(_imports(f)) & FORBIDDEN, f
    # whole names: the port's name begins with the JAX package's
    assert "mixdq_tpu_torch".split(".")[0] != "mixdq_tpu"


def test_harness_imports_no_jax():
    for dirpath, _, names in os.walk(PB):
        for f in names:
            if f.endswith(".py"):
                got = set(_imports(os.path.join(dirpath, f)))
                assert not got & {"jax", "jaxlib", "flax", "mixdq_tpu"}, f


def _cfg(name):
    return json.load(open(os.path.join(HERE, "data", name)))


@pytest.mark.parametrize("name", ["small_sdxl.json", "tiny_sd15.json"])
def test_reference_equals_program_unquantized(name):
    """Same weights, tokens and noise, float32 on the CPU: the images of
    the program's pipeline and of the reference agree to rounding."""
    from mixdq_tpu_torch.pipelines.txt2img import Text2ImgPipeline

    cfg = dict(_cfg(name), dtype="float32")
    pipe = Text2ImgPipeline(cfg["family"], torch.float32, "cpu")
    serve.check_family(cfg, pipe.family)
    serve.load_weights(pipe, cfg, 3)
    m = Models(cfg)
    from portbench import weights
    for top, sd in weights.make(m, 3, "cpu", torch.float32).items():
        getattr(m, top).load_state_dict(sd)
    prompts = ["a cat on a mat", "two dogs playing in a park"]
    got = pipe(prompts, seed=11).images
    ids = torch.from_numpy(tokenize(prompts, cfg["text_encoder"]
                                    ["vocab_size"]))
    noise, lcm = draw_noise(11, 2, cfg, "cpu", torch.float32)
    want = generate(m, ids, noise, lcm, FP).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 1e-4


def test_w8a8_reference_is_near_but_not_equal_to_float():
    cfg = _cfg("small_sdxl.json")
    m = Models(cfg)
    from portbench import weights
    for top, sd in weights.make(m, 5, "cpu", torch.bfloat16).items():
        getattr(m, top).load_state_dict(sd)
    ids = torch.from_numpy(tokenize(["a red bus"] * 2, 1000))
    noise, lcm = draw_noise(4, 2, cfg, "cpu", torch.bfloat16)
    ranges = calibrate(m, ids, noise, lcm, torch.bfloat16)
    fp = generate(m, ids, noise, lcm, FP)
    err = {b: ((generate(m, ids, noise, lcm, Quant("fq", b, b, ranges))
                - fp).pow(2).mean().sqrt() / fp.std()).item()
           for b in (8, 4)}
    assert 0 < err[8] < 0.1 and err[4] > 3 * err[8]
