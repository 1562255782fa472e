"""Batch-size sweep: bf16 against the quantized UNet, paired at every B
in one process, round-robin across rounds (port of
``scripts/batch_sweep.py``).

    python -m mixdq_tpu_torch.scripts.batch_sweep [--batches 1,2,4,8] \\
        [--rounds 3] [--iters 8] [--inner 8] [--family sdxl-turbo] \\
        [--compute int8_sec] [--device cuda]

The family's UNet (bf16, random weights from seed 0) is calibrated on
the B = 1 request and deployed W8A8 once (fused QKV/KV, BoS-aware, under
``--compute``, ``attn_impl='auto'``); bf16 runs under ``'auto'`` too.
Requests: unit normal latents and text embeddings from seed 0, zero
micro-conditioning, t = 999. Each (B, path) is one CUDA graph of
``--inner`` chained steps (``scripts.bench.chained_graph``), all captured
before the first round; each round times, at every B in turn, the bf16
graph then the quantized one over ``--iters`` replays by CUDA events
(the host clock on the CPU, where the steps run eagerly). Prints one JSON
line per B: ``B``, ``bf16_ms``, ``int8_ms`` (median ms a step),
``speedup`` (median of the rounds' ratios), ``ms_per_img`` and
``host_fingerprint_ms`` (null on the CPU); the rounds go to stderr. Runs
on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import pipeline
from ..models.configs import get_family
from ..quant.calibrate import calibrate
from ..quant.deploy import deploy_unet_ctx
from ..quant.state import FP_CTX, quantizable_layers, uniform_ctrl
from ..utils.profiling import host_fingerprint, timeit
from .bench import chained_graph


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_batch(family: str, B: int, device) -> pipeline.Inputs:
    """Unit normal latent and text embedding from seed 0, zero
    micro-conditioning, t = 999."""
    f = get_family(family)
    u = f.unet
    rng = np.random.default_rng(0)
    bf16 = torch.bfloat16

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device, bf16)
    sample = normal(B, u.sample_size, u.sample_size, u.in_channels)
    ehs = normal(B, pipeline.TEXT_TOKENS, u.cross_attention_dim)
    added = None
    if u.addition_embed_type == "text_time":
        added = {"text_embeds": torch.zeros(B, f.pooled_dim, dtype=bf16,
                                            device=device),
                 "time_ids": torch.zeros(B, 6, dtype=bf16, device=device)}
    return sample, torch.tensor(999.0, device=device), ehs, added


def step_ms(graph, iters: int, inner: int) -> float:
    """Mean ms a step of ``graph`` (``inner`` chained steps a call):
    CUDA events over ``iters`` replays, or the host clock over ``iters``
    eager calls on the CPU."""
    if graph.graph is not None:
        return timeit(graph.replay, iters=iters, warmup=1) / inner
    t0 = time.perf_counter()
    for _ in range(iters):
        graph(*graph.inputs)
    return (time.perf_counter() - t0) * 1000 / (iters * inner)


def main(argv=None):
    """Returns ``{'rows': the JSON lines' dicts, 'rounds': {B: {'fp',
    'q'}}, 'graphs': {B: {'bf16', 'int8'}}, 'ctx'}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default="1,2,4,8")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--inner", type=int, default=8)
    ap.add_argument("--family", default="sdxl-turbo")
    ap.add_argument("--compute", default="int8_sec")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    batches = [int(b) for b in args.batches.split(",")]

    dev = pipeline.resolve_device(args.device)
    t0 = time.perf_counter()
    unet = pipeline.build_unet(args.family, seed=0, dtype=torch.bfloat16,
                               device=dev)
    log(f"init: {time.perf_counter() - t0:.1f}s on {dev}")
    b0 = make_batch(args.family, 1, dev)
    qparams = calibrate(unet, [b0], pipeline.WQ, pipeline.AQ)
    ctrl = uniform_ctrl(list(quantizable_layers(unet)), w_bits=8, a_bits=8)
    ctx = deploy_unet_ctx(unet, qparams, ctrl, pipeline.WQ, fuse_qkv=True,
                          deploy_compute=args.compute)
    ctx = dataclasses.replace(ctx, attn_impl="auto")
    fp_ctx = dataclasses.replace(FP_CTX, attn_impl="auto")

    # every graph captured up front, so rounds compare like with like
    graphs = {}
    for B in batches:
        data = make_batch(args.family, B, dev)
        graphs[B] = {"bf16": chained_graph(unet, data, fp_ctx, args.inner),
                     "int8": chained_graph(unet, data, ctx, args.inner)}
        log(f"B={B}: captured")

    results = {B: {"fp": [], "q": []} for B in batches}
    for r in range(args.rounds):
        for B in batches:  # round-robin: every B in every round
            fp = step_ms(graphs[B]["bf16"], args.iters, args.inner)
            qm = step_ms(graphs[B]["int8"], args.iters, args.inner)
            results[B]["fp"].append(fp)
            results[B]["q"].append(qm)
            log(f"round {r} B={B}: bf16={fp:.2f}ms {args.compute}={qm:.2f}ms"
                f" ratio={fp / qm:.3f}")

    fprint = host_fingerprint() if dev.type == "cuda" else None
    rows = []
    for B in batches:
        fp = statistics.median(results[B]["fp"])
        qm = statistics.median(results[B]["q"])
        ratios = [a / b for a, b in zip(results[B]["fp"], results[B]["q"])]
        rows.append({
            "B": B, "bf16_ms": round(fp, 2), "int8_ms": round(qm, 2),
            "speedup": round(statistics.median(ratios), 3),
            "ms_per_img": round(qm / B, 2), "host_fingerprint_ms": fprint})
        print(json.dumps(rows[-1]), flush=True)
    return {"rows": rows, "rounds": results, "graphs": graphs, "ctx": ctx}


if __name__ == "__main__":
    main()
