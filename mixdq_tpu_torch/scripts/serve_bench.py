"""Pipeline-level serving benchmark: FP against int8, paired (port of
``scripts/serve_bench.py``).

    python -m mixdq_tpu_torch.scripts.serve_bench --base_path logs/x \\
        [--steps 30] [--batch_size 4] [--deploy_compute int8_sec] \\
        [--rounds 3] [--quantize_vae] [--vae_compute int8_sec] \\
        [--device cuda]

Two ``ServingEngine``s on one pipeline, each the whole generation
captured once as a CUDA graph: FP, and the W8A8 deploy of
``BASE/qparams.msgpack`` under ``--deploy_compute`` (fused QKV/KV;
attention on the einsum chain, the context's default, as in the JAX
script). The deploy keeps the fp weights it replaces: the FP engine runs
on them. ``--quantize_vae``: the int8 engine decodes with the int8 VAE
decoder (``quant.vae_quant.quantize_vae_decoder`` under
``--vae_compute``), calibrated on the latents of one FP run of the same
prompts. The first generation of each engine on seed 0 gives
``ssim_vs_fp``; then ``--rounds`` rounds time an FP generation and an
int8 one back to back (host wall clock around ``generate``). Prints one
JSON line: ``family``, ``steps``, ``batch_size``, ``deploy_compute``,
``quantize_vae``, ``fp_imgs_per_sec``, ``int8_imgs_per_sec`` (from the
median round times), ``speedup`` (the median of the rounds' ratios),
``ssim_vs_fp``, ``fp_batch_ms`` and ``host_fingerprint_ms``
(``utils.profiling.host_fingerprint``; null on the CPU). Everything else
goes to stderr. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import sys
import time

import torch

from ..pipelines.loader import build_pipeline, specs_from_config
from ..pipelines.serving import ServingEngine
from ..quant.checkpoint import load_qparams
from ..quant.deploy import deploy_unet_ctx
from ..quant.state import FP_CTX, quantizable_layers, uniform_ctrl
from ..quant.vae_quant import quantize_vae_decoder
from ..utils.config import load_config
from ..utils.metrics import ssim
from ..utils.profiling import host_fingerprint
from ..utils.prompts import load_prompts


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    """Returns ``{'result': the JSON line's dict, 'engines': {'fp',
    'int8'}, 'ctx', 'vae_ctx', 'rounds': [(fp_ms, int8_ms)]}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base_path", required=True)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--deploy_compute", default="int8_sec")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--fuse_qkv", action="store_true", default=True)
    ap.add_argument("--quantize_vae", action="store_true",
                    help="int8 VAE decoder in the quantized engine")
    ap.add_argument("--vae_compute", default="int8_sec")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(os.path.join(args.base_path, "config.yaml"))
    pipe = build_pipeline(cfg, device=args.device)
    qparams = load_qparams(os.path.join(args.base_path, "qparams.msgpack"),
                           device=pipe.device)
    wq, aq, _ = specs_from_config(cfg)
    ctrl = uniform_ctrl(list(quantizable_layers(pipe.unet)), w_bits=8,
                        a_bits=8)
    ctx = deploy_unet_ctx(pipe.unet, qparams, ctrl, wq, splits=pipe.splits,
                          fuse_qkv=args.fuse_qkv,
                          deploy_compute=args.deploy_compute)
    h, w = cfg.inference.get("height"), cfg.inference.get("width")
    prompts = load_prompts(None, args.batch_size)

    pipe_q, vae_ctx = pipe, FP_CTX
    if args.quantize_vae:
        # calibrated on one FP run's sampler outputs (roughly unit std:
        # random-normal proxies scaled down clip the act ranges)
        fp_out = pipe(prompts, seed=7, num_inference_steps=args.steps,
                      height=h, width=w, decode=False)
        log(f"VAE calib latents: std={fp_out.latents.float().std():.3f}")
        vae_q, vae_ctx = quantize_vae_decoder(
            pipe.vae, [fp_out.latents], wq, aq,
            deploy_compute=args.vae_compute)
        pipe_q = copy.copy(pipe)
        pipe_q.vae = vae_q
        log(f"int8 VAE decoder: {len(vae_ctx.deploy)} layers deployed")

    kw = dict(batch_size=args.batch_size, steps=args.steps, height=h,
              width=w)
    t0 = time.perf_counter()
    eng_fp = ServingEngine(pipe, FP_CTX, **kw).compile()
    log(f"fp engine compiled in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    eng_q = ServingEngine(pipe_q, ctx, vae_ctx=vae_ctx, **kw).compile()
    log(f"int8 engine compiled in {time.perf_counter() - t0:.1f}s")

    # the paired first images (same seed, same noise) are the quality
    # signal
    fp_imgs = torch.from_numpy(eng_fp.generate(prompts, seed=0))
    q_imgs = torch.from_numpy(eng_q.generate(prompts, seed=0))
    win = min(255, fp_imgs.shape[1] - 1)
    ssim_vs_fp = sum(float(ssim(fp_imgs[i], q_imgs[i], win_size=win))
                     for i in range(len(prompts))) / len(prompts)
    log(f"quality: mean SSIM(int8, fp) = {ssim_vs_fp:.4f}")

    rounds = []
    for r in range(args.rounds):
        t0 = time.perf_counter()
        eng_fp.generate(prompts, seed=r)
        fp_dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        eng_q.generate(prompts, seed=r)
        q_dt = time.perf_counter() - t0
        rounds.append((fp_dt * 1000, q_dt * 1000))
        log(f"round {r}: fp={fp_dt * 1000:.0f}ms int8={q_dt * 1000:.0f}ms "
            f"ratio={fp_dt / q_dt:.3f}")

    fp_dt = statistics.median(f for f, _ in rounds) / 1000
    q_dt = statistics.median(q for _, q in rounds) / 1000
    out = {
        "family": cfg.model.family,
        "steps": args.steps,
        "batch_size": args.batch_size,
        "deploy_compute": args.deploy_compute,
        "quantize_vae": bool(args.quantize_vae),
        "fp_imgs_per_sec": round(args.batch_size / fp_dt, 3),
        "int8_imgs_per_sec": round(args.batch_size / q_dt, 3),
        "speedup": round(statistics.median(f / q for f, q in rounds), 3),
        "ssim_vs_fp": round(ssim_vs_fp, 4),
        "fp_batch_ms": round(fp_dt * 1000, 1),
        "host_fingerprint_ms": (host_fingerprint()
                                if pipe.device.type == "cuda" else None),
    }
    print(json.dumps(out), flush=True)
    return {"result": out, "engines": {"fp": eng_fp, "int8": eng_q},
            "ctx": ctx, "vae_ctx": vae_ctx,
            "rounds": rounds}


if __name__ == "__main__":
    main()
