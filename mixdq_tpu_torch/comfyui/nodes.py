"""ComfyUI nodes for the PyTorch port (port of the repo's root
``comfyui/nodes.py``): quantized SDXL-Turbo generation inside a ComfyUI
graph, on the card.

The five nodes keep the root package's ``NODE_CLASS_MAPPINGS`` keys,
``INPUT_TYPES``, ``RETURN_TYPES`` and ``FUNCTION``, so
``comfyui/workflow/mixdq_tpu_workflow.json`` loads with either package:

* ``MixdqTPULoadPipeline``: a ``Text2ImgPipeline`` of the family with
  weights from seed 0 (the JAX node's ``PRNGKey(0)``) or a params file
  (``quant.checkpoint.load_params``: the JAX package's or the port's);
* ``MixdqTPUQuantize``: a quant context from a qparams file at uniform
  bits, with optional bit maps and an act-protect list
  (``quant.bitmaps``): ``fake`` simulation, or ``int8``, the deploy of
  ``deploy_unet_ctx`` (W8A8 ``int8_sec``: the int8 kernels). Unlike the
  JAX node it keeps the fp weights (a layer with a deploy entry never
  reads its own), so the FP nodes still run on its output;
* ``MixdqTPUGenerate``: the quantized generation -> IMAGE;
* ``MixdqTPUOriginGen``: the FP generation -> IMAGE;
* ``MixdqTPUIntegral``: both, side by side (FP first), and their pixel
  MSE.

IMAGE tensors are float ``[B, H, W, C]`` in [0, 1] on the CPU. A seed
seeds the pipeline's ``torch.Generator``. The nodes run on the card; the
Python-only ``device`` argument of ``load`` (not an input of the graph)
puts a pipeline on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

FAMILIES = ["sdxl-turbo", "sdxl", "sd15", "tiny-sdxl"]


class MixdqTPULoadPipeline:
    CATEGORY = "MixDQ-TPU"
    RETURN_TYPES = ("MIXDQ_PIPE",)
    FUNCTION = "load"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "family": (list(FAMILIES),),
            "params_path": ("STRING", {"default": ""}),
            "dtype": (["bfloat16", "float32"],),
        }}

    def load(self, family, params_path, dtype, device="cuda"):
        from mixdq_tpu_torch.pipelines.txt2img import Text2ImgPipeline

        dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        pipe = Text2ImgPipeline(family, dtype=dt, device=device)
        if params_path:
            from mixdq_tpu_torch.quant.checkpoint import load_params

            load_params(pipe, params_path)
        else:
            pipe.init_weights(0)
        return ({"pipe": pipe},)


class MixdqTPUQuantize:
    CATEGORY = "MixDQ-TPU"
    RETURN_TYPES = ("MIXDQ_PIPE",)
    FUNCTION = "quantize"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "pipe": ("MIXDQ_PIPE",),
            "qparams_path": ("STRING", {"default": ""}),
            "backend": (["fake", "int8"],),
            "w_bits": ([8, 4, 2],),
            "a_bits": ([8],),
        }, "optional": {
            "weight_mp_yaml": ("STRING", {"default": ""}),
            "act_mp_yaml": ("STRING", {"default": ""}),
            "act_protect_yaml": ("STRING", {"default": ""}),
        }}

    def quantize(self, pipe, qparams_path, backend, w_bits, a_bits,
                 weight_mp_yaml="", act_mp_yaml="", act_protect_yaml=""):
        from mixdq_tpu_torch.pipeline import AQ, WQ
        from mixdq_tpu_torch.quant.bitmaps import (load_bit_map,
                                                   load_layer_list)
        from mixdq_tpu_torch.quant.checkpoint import load_qparams
        from mixdq_tpu_torch.quant.deploy import deploy_unet_ctx
        from mixdq_tpu_torch.quant.state import (
            QuantCtx, apply_bitwidth_config, protect_layers,
            quantizable_layers, uniform_ctrl)

        p = pipe["pipe"]
        qparams = load_qparams(qparams_path, device=p.device)
        names = list(quantizable_layers(p.unet))
        ctrl = uniform_ctrl(names, w_bits=int(w_bits), a_bits=int(a_bits))
        if weight_mp_yaml:
            ctrl = apply_bitwidth_config(ctrl, load_bit_map(weight_mp_yaml),
                                         "weight")
        if act_protect_yaml:
            ctrl = protect_layers(ctrl, load_layer_list(act_protect_yaml),
                                  "act")
        if act_mp_yaml:
            ctrl = apply_bitwidth_config(ctrl, load_bit_map(act_mp_yaml),
                                         "act")
        if backend == "int8":
            ctx = deploy_unet_ctx(p.unet, qparams, ctrl, WQ, splits=p.splits)
        else:
            ctx = QuantCtx(qparams=qparams, ctrl=ctrl, mode="fake", wq=WQ,
                           aq=AQ, bos_aware=True)
        return ({**pipe, "ctx": ctx},)


def _generate(pipe_state, prompt, steps, seed, use_ctx) -> torch.Tensor:
    """One image of ``prompt`` as a ComfyUI IMAGE ``[1, H, W, 3]``."""
    from mixdq_tpu_torch.quant.state import FP_CTX

    ctx = pipe_state.get("ctx", FP_CTX) if use_ctx else FP_CTX
    out = pipe_state["pipe"]([prompt], seed=int(seed),
                             num_inference_steps=int(steps), ctx=ctx)
    return torch.from_numpy(np.array(out.images, dtype=np.float32, copy=True))


class MixdqTPUGenerate:
    CATEGORY = "MixDQ-TPU"
    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "generate"

    @classmethod
    def INPUT_TYPES(cls):
        return {"required": {
            "pipe": ("MIXDQ_PIPE",),
            "prompt": ("STRING", {"multiline": True, "default": "a photo"}),
            "steps": ("INT", {"default": 1, "min": 1, "max": 50}),
            "seed": ("INT", {"default": 0}),
        }}

    def generate(self, pipe, prompt, steps, seed):
        return (_generate(pipe, prompt, steps, seed, use_ctx=True),)


class MixdqTPUOriginGen(MixdqTPUGenerate):
    FUNCTION = "generate"

    def generate(self, pipe, prompt, steps, seed):
        return (_generate(pipe, prompt, steps, seed, use_ctx=False),)


class MixdqTPUIntegral(MixdqTPUGenerate):
    """The same prompt and seed through the quantized and the FP path:
    both images (FP first) and the pixel MSE between them."""

    RETURN_TYPES = ("IMAGE", "STRING")
    RETURN_NAMES = ("images", "report")
    FUNCTION = "generate"

    def generate(self, pipe, prompt, steps, seed):
        q = _generate(pipe, prompt, steps, seed, use_ctx=True)
        fp = _generate(pipe, prompt, steps, seed, use_ctx=False)
        mse = float(((q - fp) ** 2).mean())
        report = f"pixel MSE quant vs FP: {mse:.6f}"
        return (torch.cat([fp, q], dim=0), report)


NODE_CLASS_MAPPINGS = {
    "MixdqTPULoadPipeline": MixdqTPULoadPipeline,
    "MixdqTPUQuantize": MixdqTPUQuantize,
    "MixdqTPUGenerate": MixdqTPUGenerate,
    "MixdqTPUOriginGen": MixdqTPUOriginGen,
    "MixdqTPUIntegral": MixdqTPUIntegral,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    "MixdqTPULoadPipeline": "MixDQ-TPU Load Pipeline",
    "MixdqTPUQuantize": "MixDQ-TPU Quantize",
    "MixdqTPUGenerate": "MixDQ-TPU Generate (quantized)",
    "MixdqTPUOriginGen": "MixDQ-TPU Generate (FP)",
    "MixdqTPUIntegral": "MixDQ-TPU Integral (quant vs FP compare)",
}
