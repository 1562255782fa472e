"""Quality evaluation: quantized against FP over a prompt set (port of
``scripts/evaluate.py``).

    python -m mixdq_tpu_torch.scripts.evaluate --base_path logs/x \\
        [--backend fake|int8] [--deploy_compute C] [--fuse_qkv] \\
        [--matrix w8_int8,w8_sec,w4_sec,mp_sec] [--n_prompts 4] \\
        [--batch_size 2] [--seed 42] [--config_weight_mp w.yaml] \\
        [--config_act_mp a.yaml] [--act_protect p.yaml] [--out F] \\
        [--clip_vision_ckpt F] [--inception_ckpt F] [--device cuda]

Reads ``BASE/config.yaml`` and ``BASE/qparams.msgpack`` (``ptq``), runs
ONE FP pass over the prompts (batch ``k`` from a generator seeded ``seed
+ k``) and then each evaluated deploy on the same prompts and noise; its
report: SSIM and pixel MSE of the images and the SQNR of the latents
against FP, and with feature weights the FID of the FP and quantized
image sets (``inception_fid``: pool3 features; ``clip_fid``: CLIP image
embeddings) and the mean cosine of the paired CLIP embeddings.

Without ``--matrix``: ``--backend fake`` (the fake-quant simulation,
``quant_txt2img``'s) or ``int8`` (the deploy under ``--deploy_compute``,
default ``int8`` with the einsum attention; ``int8_sec`` runs the
whole-attention kernels, ``attn_impl='auto'``). ``--matrix`` evaluates
each entry against the one FP pass: ``w8_int8`` (W8A8, ``int8``),
``w8_sec`` (W8A8, ``int8_sec``, fused QKV/KV, ``'auto'``), ``w4_sec``
(W4A8, packed then unpacked, ``int8_sec``) and ``mp_sec`` (the bit maps of
``--config_weight_mp`` / ``--config_act_mp`` and ``--act_protect``, the
same way), each written to ``BASE/eval_<entry>.yaml``. Entries are built,
run and freed one after another (one deploy resident at a time); the fp
weights stay resident beside it (the FP pass and the next entry's deploy
read them), as the JAX script keeps its fp params beside each pruned
copy.

``--clip_vision_ckpt``: an HF CLIP vision state dict (``torch.save``) or
the JAX package's flax params (``.msgpack``), its config inferred from
the weights (heads of 64); ``--inception_ckpt``: a torchvision
``Inception3`` state dict, BatchNorm folded. Both towers run in float32.
Reports are written with ``utils.config.dumps``. Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import os
import time
from typing import Callable, Dict

import numpy as np
import torch

from .. import ops
from ..convert import params_to_state_dict
from ..models.clip import CLIPVisionModel, preprocess_images
from ..models.configs import CLIPVisionConfig
from ..models.inception import InceptionV3Features
from ..pipelines.loader import build_pipeline, specs_from_config
from ..quant.bitmaps import load_bit_map, load_layer_list
from ..quant.checkpoint import load_qparams
from ..quant.deploy import deploy_unet_ctx, unpack_packed_entries
from ..quant.state import (FP_CTX, apply_bitwidth_config, protect_layers,
                           quantizable_layers, uniform_ctrl)
from ..utils import msgpack
from ..utils.config import dumps, load_config
from ..utils.fid import fid_from_features
from ..utils.metrics import pixel_mse, sqnr, ssim
from ..utils.prompts import load_prompts
from ..utils.torch_convert import (load_clip_vision_state_dict,
                                   load_inception_state_dict)
from .quant_txt2img import build_quant_ctx

MATRIX = ("w8_int8", "w8_sec", "w4_sec", "mp_sec")


def clip_vision_config(sd: Dict[str, torch.Tensor]) -> CLIPVisionConfig:
    """The tower's config from its weights (port names), heads of 64."""
    hidden = sd["class_embedding"].shape[-1]
    n_pos = sd["position_embedding"].shape[0]
    patch = sd["patch_embedding.weight"].shape[0]
    proj = (sd["visual_projection.weight"].shape[-1]
            if "visual_projection.weight" in sd else None)
    layers = {k.split(".")[1] for k in sd if k.startswith("layers.")}
    return CLIPVisionConfig(
        image_size=int(round((n_pos - 1) ** 0.5)) * patch, patch_size=patch,
        hidden_size=hidden, num_layers=len(layers), num_heads=hidden // 64,
        intermediate_size=sd["layers.0.fc1.weight"].shape[-1],
        projection_dim=proj)


def load_clip_vision(path: str, device) -> Callable:
    """images ``[B, H, W, 3]`` in [0, 1] -> pooled CLIP image embeddings,
    from a torch state dict or a ``.msgpack`` of flax params."""
    if path.endswith(".msgpack"):
        with open(path, "rb") as f:
            sd = params_to_state_dict(msgpack.unpack(f.read()))
    else:
        sd = load_clip_vision_state_dict(
            torch.load(path, map_location="cpu", weights_only=True))
    cfg = clip_vision_config(sd)
    model = CLIPVisionModel(cfg, device=device).eval()
    model.load_state_dict(sd, strict=True)

    @torch.inference_mode()
    def embed(images: torch.Tensor) -> torch.Tensor:
        px = preprocess_images(images.to(device, torch.float32),
                               cfg.image_size)
        return model(px)[1]
    return embed


def load_inception(path: str, device) -> Callable:
    """images ``[B, H, W, 3]`` in [0, 1] -> pool3 features ``[B, 2048]``
    from a torchvision ``Inception3`` state dict."""
    model = InceptionV3Features(device=device).eval()
    model.load_state_dict(load_inception_state_dict(
        torch.load(path, map_location="cpu", weights_only=True)),
        strict=True)

    @torch.inference_mode()
    def feats(images: torch.Tensor) -> torch.Tensor:
        return model(images.to(device, torch.float32))
    return feats


def matrix_ctx(entry: str, cfg, pipe, qparams, args):
    """(report fields, context) of one ``--matrix`` entry
    (``scripts/evaluate.py:117-155`` of the JAX package)."""
    if entry not in MATRIX:
        raise ValueError(f"matrix entry {entry!r}: one of {MATRIX}")
    wq, _, _ = specs_from_config(cfg)
    cb = wq.candidate_bits
    w_bits = 4 if entry.startswith("w4") else 8
    ctrl = uniform_ctrl(list(quantizable_layers(pipe.unet)), w_bits=w_bits,
                        a_bits=8, candidate_bits=cb)
    mp = entry.startswith("mp")
    if mp:
        if not (args.config_weight_mp and args.config_act_mp):
            raise ValueError("the mp_sec matrix entry needs "
                             "--config_weight_mp and --config_act_mp")
        ctrl = apply_bitwidth_config(
            ctrl, load_bit_map(args.config_weight_mp), "weight", cb)
        if args.act_protect:
            ctrl = protect_layers(ctrl, load_layer_list(args.act_protect))
        ctrl = apply_bitwidth_config(
            ctrl, load_bit_map(args.config_act_mp), "act", cb)
    sec = entry.endswith("_sec")
    pack = w_bits == 4 or mp
    compute = "int8_sec" if sec else "int8"
    ctx = deploy_unet_ctx(pipe.unet, qparams, ctrl, wq, fuse_qkv=sec,
                          pack_w4=pack, splits=pipe.splits,
                          deploy_compute=compute)
    if pack:
        ctx = dataclasses.replace(ctx, deploy=unpack_packed_entries(
            ctx.deploy))
    ctx = dataclasses.replace(ctx, attn_impl="auto" if sec else "einsum")
    fields = {"backend": "int8", "deploy_compute": compute, "fuse_qkv": sec,
              "w_bits": w_bits}
    if mp:
        fields.update(config_weight_mp=args.config_weight_mp,
                      config_act_mp=args.config_act_mp,
                      act_protect=args.act_protect)
    return fields, ctx


def backend_ctx(cfg, pipe, qparams, args):
    """(report fields, context) without ``--matrix``: the fake-quant
    simulation, or the deploy under ``--deploy_compute`` (default
    ``int8``)."""
    ctx = build_quant_ctx(cfg, pipe, qparams, args)
    fields = {"backend": args.backend}
    if args.backend == "int8":
        dc = args.deploy_compute or "int8"
        ctx = deploy_unet_ctx(pipe.unet, qparams, ctx.ctrl,
                              specs_from_config(cfg)[0],
                              splits=pipe.splits, fuse_qkv=args.fuse_qkv,
                              deploy_compute=dc)
        ctx = dataclasses.replace(
            ctx, attn_impl="auto" if dc == "int8_sec" else "einsum")
        fields.update(deploy_compute=dc, fuse_qkv=args.fuse_qkv)
    return fields, ctx


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base_path", required=True)
    ap.add_argument("--backend", choices=["fake", "int8"], default="fake")
    ap.add_argument("--deploy_compute", default=None,
                    help="int8 backend compute; default 'int8' (the einsum "
                         "deploy); int8_sec runs the whole-attention "
                         "kernels")
    ap.add_argument("--matrix", default=None,
                    help="comma list of deploys evaluated against ONE "
                         f"shared FP run, from {{{', '.join(MATRIX)}}}; "
                         "mp_sec takes --config_weight_mp / --config_act_mp"
                         " / --act_protect; writes eval_<entry>.yaml each; "
                         "overrides --backend")
    ap.add_argument("--fuse_qkv", action="store_true",
                    help="int8 backend: fused QKV/KV projections")
    ap.add_argument("--n_prompts", type=int, default=4)
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--config_weight_mp", default=None)
    ap.add_argument("--config_act_mp", default=None)
    ap.add_argument("--act_protect", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--clip_vision_ckpt", default=None,
                    help="CLIP vision state dict (or .msgpack flax params):"
                         " CLIP-FID and the embeddings' cosine")
    ap.add_argument("--inception_ckpt", default=None,
                    help="torchvision Inception3 state dict: FID on pool3 "
                         "features")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Returns ``{'reports': {entry: report}, 'fp': {'images', 'latents',
    'features'}, 'entries': {entry: {'images', 'latents', 'features',
    'launches', 'seconds'}}, 'seconds', 'paths'}``: images ``[N, H, W,
    3]`` numpy, latents a list of the batches' tensors, features ``{kind:
    [N, D] numpy}``, ``launches`` the kernel launches of the entry's
    generation (the feature pass launches none), seconds of the pipeline
    build, the FP generation and feature pass, and each entry's deploy,
    generation and feature pass."""
    args = parse_args(argv)
    cfg = load_config(os.path.join(args.base_path, "config.yaml"))
    seconds = {}
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, device=args.device)
    qparams = load_qparams(os.path.join(args.base_path, "qparams.msgpack"),
                           device=pipe.device)
    dev = pipe.device
    _sync(dev)
    seconds["build"] = time.perf_counter() - t0

    entries = ([e.strip() for e in args.matrix.split(",") if e.strip()]
               if args.matrix else [args.backend])
    feat_fns = {}
    if args.clip_vision_ckpt:
        feat_fns["clip"] = load_clip_vision(args.clip_vision_ckpt, dev)
    if args.inception_ckpt:
        feat_fns["inception"] = load_inception(args.inception_ckpt, dev)

    prompts = load_prompts(None, args.n_prompts)
    inf = cfg.inference
    run_kw = dict(num_inference_steps=inf.get("num_steps"),
                  guidance_scale=inf.get("guidance_scale"),
                  height=inf.get("height"), width=inf.get("width"))
    batches = [(prompts[i:i + args.batch_size], args.seed + k)
               for k, i in enumerate(range(0, len(prompts),
                                           args.batch_size))]

    def run(ctx, sec: Dict[str, float]):
        """Images, latents and features of every batch under ``ctx``; the
        seconds of the generation and of the feature pass into ``sec``."""
        t = time.perf_counter()
        imgs, lats = [], []
        for batch, seed in batches:
            out = pipe(batch, seed=seed, ctx=ctx, **run_kw)
            imgs.append(torch.from_numpy(out.images))
            lats.append(out.latents)
        images = torch.cat(imgs)
        _sync(dev)
        sec["run"] = time.perf_counter() - t
        t = time.perf_counter()
        feats = {kind: fn(images).float().cpu().numpy()
                 for kind, fn in feat_fns.items()}
        sec["features"] = time.perf_counter() - t
        return images, lats, feats

    fp_sec: Dict[str, float] = {}
    fp_images, fp_latents, fp_feats = run(FP_CTX, fp_sec)
    seconds.update(fp_run=fp_sec["run"], fp_features=fp_sec["features"])
    print(f"FP reference: {len(prompts)} images")

    reports, results, paths = {}, {}, []
    for name in entries:
        t0 = time.perf_counter()
        fields, ctx = (matrix_ctx(name, cfg, pipe, qparams, args)
                       if args.matrix else
                       backend_ctx(cfg, pipe, qparams, args))
        _sync(dev)
        sec = {"deploy": time.perf_counter() - t0}
        before = ops.launch_counts()
        images, latents, feats = run(ctx, sec)
        after = ops.launch_counts()
        H = images.shape[1]
        win = min(255, H - 1)
        win -= (win + 1) % 2
        ssims = [float(ssim(fp_images[i], images[i], win_size=win))
                 for i in range(len(images))]
        mses, sqnrs, off = [], [], 0
        for (batch, _), fl, ql in zip(batches, fp_latents, latents):
            n = len(batch)
            mses.append(float(pixel_mse(fp_images[off:off + n],
                                        images[off:off + n])))
            sqnrs.append(float(sqnr(fl, ql)))
            off += n
        report = {**fields, "n_prompts": len(prompts),
                  "ssim_mean": float(np.mean(ssims)),
                  "pixel_mse_mean": float(np.mean(mses)),
                  "latent_sqnr_db_mean": float(np.mean(sqnrs))}
        for kind in feat_fns:
            fa, qa = fp_feats[kind], feats[kind]
            report[f"{kind}_fid"] = fid_from_features(fa, qa)
            if kind == "clip":
                cos = np.sum(fa / np.linalg.norm(fa, axis=-1, keepdims=True)
                             * qa / np.linalg.norm(qa, axis=-1,
                                                   keepdims=True), axis=-1)
                report["clip_cosine_mean"] = float(np.mean(cos))
        text = dumps(report)
        print(f"== {name} ==\n{text.strip()}")
        out = (args.out if (args.out and not args.matrix)
               else os.path.join(args.base_path, f"eval_{name}.yaml"))
        with open(out, "w") as f:
            f.write(text)
        print(f"wrote {out}", flush=True)
        reports[name] = report
        paths.append(out)
        results[name] = {
            "images": images.numpy(), "latents": latents, "features": feats,
            "launches": {k: after[k] - before[k] for k in after},
            "seconds": sec}
        # the next entry's deploy builds only once this one is freed
        del fields, ctx
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return {"reports": reports,
            "fp": {"images": fp_images.numpy(), "latents": fp_latents,
                   "features": fp_feats},
            "entries": results, "seconds": seconds, "paths": paths}


if __name__ == "__main__":
    main()
