"""Quantized text-to-image generation from a PTQ experiment (port of
``scripts/quant_txt2img.py``).

    python -m mixdq_tpu_torch.scripts.quant_txt2img --base_path logs/x \\
        [--config_weight_mp w.yaml] [--act_protect protect.yaml|.pt] \\
        [--config_act_mp a.yaml] [--prompt "a cat"] [--n_images 4] \\
        [--batch_size 2] [--backend fake|int8] [--fuse_qkv] [--device cuda]

Reads ``BASE/config.yaml`` and ``BASE/qparams.msgpack`` (``ptq``), sets
the per-layer controls in the JAX script's order (every layer at the
config's bits, then the weight bit map, then the act-protect list, then
the act bit map; every qparams key gets one, the attention's bare
q/k/v/softmax act quantizers included), then either runs the fake-quant
simulation (``--backend fake``, the default, as in the JAX script: the
UNet keeps its fp weights and fake-quantizes each layer under its
control; the q/k/v/softmax quantizers are on when the config enables
``quant.softmax``) or deploys the UNet int8 (``--backend int8``:
``int8_sec``, every JAX family's ``default_deploy_compute``;
``conv_split`` entries for the concat-shortcut convs; BoS-aware as
``inference.bos_aware``, the BoS rows of every cross-attention k/v entry
then computed once on the unquantized weights from the empty prompt's
first text token, as the JAX script does: ``precompute_bos_outputs``;
fused QKV/KV with ``--fuse_qkv``), drops the fp weights the deploy
replaces and writes the images as PNGs to
``--outdir`` (default
``BASE/generated_images``). Batch ``k`` draws its noise from a generator
seeded ``seed + k``. Attention runs the JAX script's path (the context's
default ``attn_impl='einsum'``). Runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from ..pipelines.loader import build_pipeline, specs_from_config
from ..quant.bitmaps import load_bit_map, load_layer_list
from ..quant.checkpoint import load_qparams
from ..quant.deploy import (deploy_unet_ctx, precompute_bos_outputs,
                            prune_deployed_weights)
from ..quant.state import (QuantCtx, apply_bitwidth_config,
                           protect_layers, quantizable_layers, uniform_ctrl)
from ..utils.config import load_config
from ..utils.images import save_images
from ..utils.logging_utils import setup_experiment
from ..utils.prompts import load_prompts


def build_ctrl(cfg, pipe, qparams, args):
    """Per-layer controls: uniform bits from the config, then the weight
    bit map, then the act-protect list, then the act bit map
    (``quant_txt2img.py:207-245`` of the reference)."""
    wq, _, _ = specs_from_config(cfg)
    cb = wq.candidate_bits
    names = set(quantizable_layers(pipe.unet)) | set(qparams)
    ctrl = uniform_ctrl(sorted(names), w_bits=cfg.quant.weight.n_bits,
                        a_bits=cfg.quant.activation.n_bits,
                        candidate_bits=cb)
    if args.config_weight_mp:
        ctrl = apply_bitwidth_config(
            ctrl, load_bit_map(args.config_weight_mp), "weight", cb)
    if args.act_protect:
        ctrl = protect_layers(ctrl, load_layer_list(args.act_protect))
    if args.config_act_mp:
        ctrl = apply_bitwidth_config(
            ctrl, load_bit_map(args.config_act_mp), "act", cb)
    return ctrl


def build_quant_ctx(cfg, pipe, qparams, args) -> QuantCtx:
    """The fake-quant simulation of the controls (``build_ctrl``) under
    the config's specs, ``qkv_quant`` when the config has a softmax spec
    (``scripts/quant_txt2img.py:48-77`` of the JAX package)."""
    wq, aq, softmax_aq = specs_from_config(cfg)
    return QuantCtx(
        qparams=qparams, ctrl=build_ctrl(cfg, pipe, qparams, args),
        mode="fake", wq=wq, aq=aq, softmax_aq=softmax_aq,
        bos_aware=cfg.inference.get("bos_aware", True),
        qkv_quant=softmax_aq is not None)


def _sync(pipe):
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)


def main(argv=None):
    """Returns ``{'pipe', 'ctx', 'paths', 'seconds'}``: the pipeline (its
    UNet pruned under ``int8``), the context, the PNG paths and the seconds
    of the build, the qparams load, the context (``'deploy'``: the deploy
    under ``int8``) and the generation."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--base_path", required=True,
                    help="experiment dir with config.yaml + qparams.msgpack")
    ap.add_argument("--config_weight_mp", default=None)
    ap.add_argument("--config_act_mp", default=None)
    ap.add_argument("--act_protect", default=None,
                    help="layers whose acts stay FP: a layer list or the "
                         "reference's torch-saved .pt list")
    ap.add_argument("--prompt", default=None)
    ap.add_argument("--n_images", type=int, default=4)
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--backend", choices=["fake", "int8"], default="fake")
    ap.add_argument("--fuse_qkv", action="store_true",
                    help="int8: fuse attention q/k/v (self) and k/v (cross) "
                         "projections into one GEMM on shared act codes")
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(os.path.join(args.base_path, "config.yaml"))
    outdir = args.outdir or os.path.join(args.base_path, "generated_images")
    setup_experiment(outdir)
    seconds = {}
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, device=args.device)
    _sync(pipe)
    seconds["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams = load_qparams(os.path.join(args.base_path, "qparams.msgpack"),
                           device=pipe.device)
    seconds["load_qparams"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if args.backend == "fake":
        ctx = build_quant_ctx(cfg, pipe, qparams, args)
    else:
        bos_aware = cfg.inference.get("bos_aware", True)
        ctx = deploy_unet_ctx(
            pipe.unet, qparams, build_ctrl(cfg, pipe, qparams, args),
            specs_from_config(cfg)[0], bos_aware=bos_aware,
            fuse_qkv=args.fuse_qkv, splits=pipe.splits)
        if bos_aware:
            # the BoS token's text embedding is the same for every prompt
            # (causal attention): its k/v rows once, on the fp weights,
            # before the prune (scripts/quant_txt2img.py:117-125)
            embeds, _ = pipe.encode_prompt(pipe.tokens([""]))
            ctx = dataclasses.replace(ctx, deploy=precompute_bos_outputs(
                ctx.deploy, pipe.unet, embeds[0, 0]))
        prune_deployed_weights(pipe.unet, ctx.deploy)
    _sync(pipe)
    seconds["deploy"] = time.perf_counter() - t0

    prompts = ([args.prompt] * args.n_images if args.prompt
               else load_prompts(None, args.n_images))
    inf = cfg.inference
    paths = []
    t0 = time.perf_counter()
    for k, i in enumerate(range(0, len(prompts), args.batch_size)):
        out = pipe(prompts[i:i + args.batch_size], seed=args.seed + k,
                   num_inference_steps=inf.get("num_steps"),
                   guidance_scale=inf.get("guidance_scale"),
                   height=inf.get("height"), width=inf.get("width"),
                   ctx=ctx)
        paths += save_images(out.images, outdir, prefix=f"quant_{i:04d}")
    seconds["generate"] = time.perf_counter() - t0
    print(f"wrote {len(paths)} images to {outdir}")
    return {"pipe": pipe, "ctx": ctx, "paths": paths, "seconds": seconds}


if __name__ == "__main__":
    main()
