"""The port's ComfyUI nodes (``mixdq_tpu_torch/comfyui/``) on the CPU, as
plain classes (ComfyUI is not installed):

* every node's ``INPUT_TYPES``, ``RETURN_TYPES``, ``RETURN_NAMES``,
  ``FUNCTION`` and ``CATEGORY``, and both mappings, equal the root
  ``comfyui/nodes.py``'s, and each MixDQ node of
  ``comfyui/workflow/mixdq_tpu_workflow.json`` has a widget value for
  each required input widget and none beyond the optional ones (the file
  leaves the last optional one, ``act_protect_yaml``, to its default);
* on tiny-sdxl: Load (seed 0, or a params file) -> Quantize (``int8``:
  ``deploy_unet_ctx``; ``fake``) -> Generate equals the port pipeline's
  generation under the same context and seed bit for bit; OriginGen its
  FP generation; Integral returns both (FP first) and their pixel MSE.
  IMAGE tensors are float32 ``[B, H, W, 3]`` in [0, 1].
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from comfyui import nodes as jnodes  # noqa: E402

from mixdq_tpu_torch import pipeline  # noqa: E402
from mixdq_tpu_torch.comfyui import nodes  # noqa: E402
from mixdq_tpu_torch.quant import checkpoint  # noqa: E402
from mixdq_tpu_torch.quant.calibrate import calibrate  # noqa: E402
from mixdq_tpu_torch.quant.deploy import deploy_unet_ctx  # noqa: E402
from mixdq_tpu_torch.quant.state import (QuantCtx,  # noqa: E402
                                         quantizable_layers, uniform_ctrl)

REPO = os.path.join(os.path.dirname(__file__), "..")
PROMPT = "a photo of an astronaut riding a horse"
ATTRS = ("RETURN_TYPES", "RETURN_NAMES", "FUNCTION", "CATEGORY")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this module runs: the tier-1 run's
    workers share the cores, and small eager ops contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_node_classes_match_the_root_package():
    assert list(nodes.NODE_CLASS_MAPPINGS) == list(jnodes.NODE_CLASS_MAPPINGS)
    assert nodes.NODE_DISPLAY_NAME_MAPPINGS == \
        jnodes.NODE_DISPLAY_NAME_MAPPINGS
    for key, cls in nodes.NODE_CLASS_MAPPINGS.items():
        ref = jnodes.NODE_CLASS_MAPPINGS[key]
        assert cls.INPUT_TYPES() == ref.INPUT_TYPES(), key
        for a in ATTRS:
            assert getattr(cls, a, None) == getattr(ref, a, None), (key, a)
        assert callable(getattr(cls(), cls.FUNCTION))


def test_workflow_widgets_fit_the_nodes():
    with open(os.path.join(REPO, "comfyui", "workflow",
                           "mixdq_tpu_workflow.json")) as f:
        wf = json.load(f)
    seen = set()
    for node in wf["nodes"]:
        cls = nodes.NODE_CLASS_MAPPINGS.get(node["type"])
        if cls is None:
            continue
        seen.add(node["type"])
        spec = cls.INPUT_TYPES()
        n = [sum(v[0] != "MIXDQ_PIPE" for v in spec.get(part, {}).values())
             for part in ("required", "optional")]
        assert n[0] <= len(node.get("widgets_values", [])) <= sum(n), \
            node["type"]
    assert {"MixdqTPULoadPipeline", "MixdqTPUQuantize",
            "MixdqTPUGenerate"} <= seen


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Load(tiny-sdxl, f32, CPU) and a qparams file calibrated on it."""
    tmp = tmp_path_factory.mktemp("comfy")
    (state,) = nodes.MixdqTPULoadPipeline().load("tiny-sdxl", "", "float32",
                                                 device="cpu")
    pipe = state["pipe"]
    calib = pipeline.example_inputs("tiny-sdxl", 1, 0, torch.float32, "cpu")
    qparams = calibrate(pipe.unet, [calib], pipeline.WQ, pipeline.AQ,
                        splits=pipe.splits)
    path = str(tmp / "qparams.msgpack")
    checkpoint.save_qparams(qparams, path)
    return state, path, tmp


def _image_ok(img, n=1):
    assert img.dtype == torch.float32 and img.shape == (n, 128, 128, 3)
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0


def test_load_reads_a_params_file(chain):
    state, _, tmp = chain
    path = str(tmp / "params.msgpack")
    checkpoint.save_params(state["pipe"], path)
    (loaded,) = nodes.MixdqTPULoadPipeline().load("tiny-sdxl", path,
                                                  "float32", device="cpu")
    for part in ("unet", "vae", "text_encoder", "text_encoder_2"):
        a = getattr(state["pipe"], part).state_dict()
        b = getattr(loaded["pipe"], part).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a), part


@pytest.mark.parametrize("backend", ["int8", "fake"])
def test_generate_equals_the_pipeline(chain, backend):
    state, path, _ = chain
    (q,) = nodes.MixdqTPUQuantize().quantize(state, path, backend, 8, 8)
    pipe = q["pipe"]
    qparams = checkpoint.load_qparams(path, device="cpu")
    ctrl = uniform_ctrl(list(quantizable_layers(pipe.unet)), w_bits=8,
                        a_bits=8)
    if backend == "int8":
        ctx = deploy_unet_ctx(pipe.unet, qparams, ctrl, pipeline.WQ,
                              splits=pipe.splits)
        assert q["ctx"].mode == "int8"
        assert q["ctx"].deploy_compute == "int8_sec"
    else:
        ctx = QuantCtx(qparams=qparams, ctrl=ctrl, mode="fake",
                       wq=pipeline.WQ, aq=pipeline.AQ, bos_aware=True)
    (img,) = nodes.MixdqTPUGenerate().generate(q, PROMPT, 1, 42)
    _image_ok(img)
    want = pipe([PROMPT], seed=42, num_inference_steps=1, ctx=ctx).images
    assert np.array_equal(img.numpy(), want)

    (fp,) = nodes.MixdqTPUOriginGen().generate(q, PROMPT, 1, 42)
    _image_ok(fp)
    assert np.array_equal(fp.numpy(), pipe([PROMPT], seed=42,
                                           num_inference_steps=1).images)
    both, report = nodes.MixdqTPUIntegral().generate(q, PROMPT, 1, 42)
    _image_ok(both, 2)
    assert torch.equal(both[:1], fp) and torch.equal(both[1:], img)
    mse = float(((img - fp) ** 2).mean())
    assert report == f"pixel MSE quant vs FP: {mse:.6f}" and mse > 0
