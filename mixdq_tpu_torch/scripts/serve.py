"""Batch serving CLI (port of ``scripts/serve.py``): one
``ServingEngine`` (the whole generation captured once as a CUDA graph),
then ``--n_batches`` batches of prompts from ``--prompts`` or the built-in
list.

    python -m mixdq_tpu_torch.scripts.serve --base_path logs/x \\
        [--backend fp|fake|int8] [--fuse_qkv] [--deploy_compute C] \\
        [--batch_size 4] [--steps N] [--prompts file.txt] [--n_batches 2] \\
        [--outdir serve_out] [--device cuda]

``--config`` serves FP without an experiment directory. The quant
backends read ``BASE/config.yaml`` and ``BASE/qparams.msgpack``: ``fake``
the fake-quant simulation at the config's bits (``quant_txt2img``'s,
without bit maps), ``int8`` the deploy of the same controls under
``--deploy_compute`` (default: the family's ``default_deploy_compute``),
its fp weights pruned. Attention runs the context's default einsum
chain, as in the JAX script. Batch ``k`` draws its noise from seed ``k``.
Prints each batch's ms and images/s; writes ``serve_{n:05d}.png``.
``--dp N`` serves over a data-parallel mesh of N ranks
(``make_mesh(N, tp=1)``; gloo on the CPU, NCCL on the card, one card a
rank, so N above the card count raises): started here, one process a
rank (``parallel.launch``), unless a world of N runs already. Each rank
generates its share of every batch; rank 0 writes the images and its
result is returned (without the engine). Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch.distributed as dist

from ..parallel.launch import spawn_main
from ..parallel.mesh import make_mesh
from ..pipelines.loader import build_pipeline, specs_from_config
from ..pipelines.serving import ServingEngine
from ..quant.checkpoint import load_qparams
from ..quant.deploy import deploy_unet_ctx, prune_deployed_weights
from ..quant.state import FP_CTX
from ..utils.config import load_config
from ..utils.images import write_png
from ..utils.prompts import load_prompts
from .quant_txt2img import build_quant_ctx


def main(argv=None):
    """Returns ``{'engine', 'paths', 'batch_ms', 'compile_s'}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base_path", default=None,
                    help="experiment dir (enables the quant backends)")
    ap.add_argument("--config", default=None,
                    help="config yaml (FP serving without experiment dir)")
    ap.add_argument("--backend", choices=["fp", "fake", "int8"], default="fp")
    ap.add_argument("--fuse_qkv", action="store_true",
                    help="int8: fused QKV/KV projections")
    ap.add_argument("--deploy_compute", default=None,
                    help="int8 backend compute (int8 | int8_sec | dequant);"
                         " default: the family's default_deploy_compute")
    ap.add_argument("--batch_size", type=int, default=4)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks (one device each)")
    ap.add_argument("--prompts", default=None)
    ap.add_argument("--n_batches", type=int, default=2)
    ap.add_argument("--outdir", default="serve_out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.dp > 1 and not dist.is_initialized():
        return {"engine": None, **spawn_main(
            __name__, sys.argv[1:] if argv is None else argv, args.dp,
            args.device)}
    mesh = make_mesh(args.dp, tp=1) if args.dp > 1 else None
    writer = mesh is None or dist.get_rank() == 0

    cfg_path = (os.path.join(args.base_path, "config.yaml")
                if args.base_path else args.config)
    if not cfg_path:
        raise ValueError("need --base_path or --config")
    cfg = load_config(cfg_path)
    pipe = build_pipeline(cfg, device=args.device)

    ctx = FP_CTX
    if args.backend != "fp":
        if not args.base_path:
            raise ValueError("the quant backends need --base_path")
        qparams = load_qparams(os.path.join(args.base_path,
                                            "qparams.msgpack"),
                               device=pipe.device)
        no_maps = SimpleNamespace(config_weight_mp=None, config_act_mp=None,
                                  act_protect=None)
        ctx = build_quant_ctx(cfg, pipe, qparams, no_maps)
        if args.backend == "int8":
            ctx = deploy_unet_ctx(
                pipe.unet, qparams, ctx.ctrl, specs_from_config(cfg)[0],
                splits=pipe.splits, fuse_qkv=args.fuse_qkv,
                deploy_compute=(args.deploy_compute
                                or pipe.family.default_deploy_compute))
            ctx = dataclasses.replace(ctx, attn_impl="einsum")
            prune_deployed_weights(pipe.unet, ctx.deploy)

    t0 = time.perf_counter()
    eng = ServingEngine(pipe, ctx, batch_size=args.batch_size,
                        steps=args.steps, height=cfg.inference.get("height"),
                        width=cfg.inference.get("width"),
                        mesh=mesh).compile()
    compile_s = time.perf_counter() - t0
    print(f"compiled in {compile_s:.1f}s")

    prompts = load_prompts(args.prompts, args.batch_size * args.n_batches)
    if writer:
        os.makedirs(args.outdir, exist_ok=True)
    paths, batch_ms = [], []
    for bi in range(args.n_batches):
        batch = prompts[bi * args.batch_size:(bi + 1) * args.batch_size]
        t0 = time.perf_counter()
        imgs = eng.generate(batch, seed=bi)
        dt = time.perf_counter() - t0
        batch_ms.append(dt * 1000)
        print(f"batch {bi}: {dt * 1000:.1f} ms "
              f"({args.batch_size / dt:.2f} imgs/sec)")
        for img in imgs if writer else ():
            paths.append(os.path.join(args.outdir,
                                      f"serve_{len(paths):05d}.png"))
            write_png(paths[-1], (img * 255).astype(np.uint8))
    print(f"wrote {len(paths)} images to {args.outdir}")
    return {"engine": eng, "paths": paths, "batch_ms": batch_ms,
            "compile_s": compile_s}


if __name__ == "__main__":
    main()
