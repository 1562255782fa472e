"""Benchmark: UNet step latency, quantized against bf16, on CUDA graphs
(port of the root ``bench.py``).

    python -m mixdq_tpu_torch.scripts.bench --family sdxl-turbo \\
        [--batch 1] [--iters 10] [--inner 8] [--rounds 3] \\
        [--backend int8_fq_sec|dequant] [--w-bits 8] \\
        [--mp-w W.yaml] [--mp-a A.yaml] [--mp-protect P.yaml] [--attn auto]
        [--small_m N]

Prints ONE JSON line on stdout, ``{"metric", "value", "unit",
"vs_baseline", "bf16_ms", "host_fingerprint_ms"}``: ``value`` the
quantized UNet's ms a step, ``vs_baseline`` bf16 ms / quantized ms (the
median of the per-round ratios), ``host_fingerprint_ms`` the ms of one
8192^3 bf16 matmul on the card (``utils.profiling.host_fingerprint``).
Everything else goes to stderr.

Each variant (the bf16 UNet, the quantized deploy) is one CUDA graph of
``--inner`` chained steps: each step's output, bounded as ``out / (1 +
|out|)`` and cast to the sample dtype, is the next step's sample, and the
graph writes its last result back into its input buffer, so replays chain
too. In each of ``--rounds`` rounds the bf16 graph is timed immediately
before the quantized one, each over ``--iters`` replays by CUDA events,
divided by ``iters * inner``. The quantized deploy: calibrated on the
bench's one request, every layer W``--w-bits``A8, then the bit maps and
the act-protect list where given (``pipeline.quantize_mixed``):
``int8_fq_sec`` runs ``int8_sec`` with fused QKV/KV projections,
``dequant`` the weight-only compute; ``--small_m N`` sets the small-M
hybrid (``QuantCtx.dequant_small_m``) of an ``int8_fq_sec`` deploy, as
the root ``bench.py``'s ``MIXDQ_BENCH_SMALLM`` does. Each variant's memory (static and
the peak of one eager step, ``utils.profiling.measure_memory``) and the
device's after capture go to stderr. It needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import torch

COMPUTE = {"int8_fq_sec": "int8_sec", "dequant": "dequant"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def chained_graph(unet, inputs, ctx, inner: int):
    """A ``GraphedCall`` of ``inner`` chained steps under ``ctx`` that
    writes its result into its sample buffer (``replay()`` chains)."""
    from mixdq_tpu_torch.pipelines.graphed import GraphedCall

    sample, t, ehs, added = inputs

    def chain(s):
        x = s
        for _ in range(inner):
            out = unet(x, t, ehs, added, ctx=ctx)
            x = (out / (1.0 + out.abs())).to(s.dtype)
        return s.copy_(x)

    return GraphedCall(chain, (sample,))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--family", default="sdxl-turbo")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--inner", type=int, default=8)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--backend", default="int8_fq_sec", choices=sorted(COMPUTE))
    p.add_argument("--w-bits", type=int, default=8, choices=(2, 4, 8))
    p.add_argument("--mp-w", help="per-layer weight bit map (flat YAML)")
    p.add_argument("--mp-a", help="per-layer act bit map (flat YAML)")
    p.add_argument("--mp-protect", help="act-protect layer list (flat YAML)")
    p.add_argument("--attn", default="auto", choices=("auto", "einsum"))
    p.add_argument("--small_m", type=int, default=0, metavar="N",
                   help="int8_fq_sec: dense layers and 1x1 convs of at most "
                        "N GEMM rows run weight-only (0: off)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from mixdq_tpu_torch import pipeline
    from mixdq_tpu_torch.quant import bitmaps
    from mixdq_tpu_torch.quant.state import FP_CTX
    from mixdq_tpu_torch.utils.profiling import (device_memory_stats,
                                                 host_fingerprint,
                                                 measure_memory, timeit)

    dev = pipeline.resolve_device()
    bf16 = torch.bfloat16
    t0 = time.time()
    unet = pipeline.build_unet(args.family, seed=0, dtype=bf16, device=dev)
    inputs = pipeline.example_inputs(args.family, args.batch, 0, bf16, dev)
    log(f"bench: {args.family} B={args.batch} on "
        f"{torch.cuda.get_device_name(dev)}; build {time.time() - t0:.1f}s")

    wmap = bitmaps.load_bit_map(args.mp_w) if args.mp_w else {}
    amap = bitmaps.load_bit_map(args.mp_a) if args.mp_a else {}
    protect = (bitmaps.load_layer_list(args.mp_protect)
               if args.mp_protect else [])
    ctx = pipeline.quantize_mixed(unet, inputs, wmap, amap, protect,
                                  deploy_compute=COMPUTE[args.backend],
                                  w_bits=args.w_bits)
    ctx = dataclasses.replace(
        ctx, attn_impl=args.attn, dequant_small_m=(
            args.small_m if ctx.deploy_compute == "int8_sec" else 0))
    fp_ctx = dataclasses.replace(FP_CTX, attn_impl=args.attn)
    log(f"deploy: {len(ctx.deploy)} entries, {time.time() - t0:.1f}s")

    for tag, c in (("bf16", fp_ctx), (args.backend, ctx)):
        mem = measure_memory(lambda c=c: pipeline.unet_step(unet, inputs, c))
        log(f"{tag} memory (one eager step): static "
            f"{mem['static_mb']:.0f} MB, dynamic {mem['dynamic_mb']:.0f} MB,"
            f" peak {mem['peak_mb']:.0f} MB")
    graphs = {"bf16": chained_graph(unet, inputs, fp_ctx, args.inner),
              args.backend: chained_graph(unet, inputs, ctx, args.inner)}
    log(f"device memory after capture: {device_memory_stats()}")
    log(f"captured: {time.time() - t0:.1f}s; {args.backend} graph launches "
        f"{ {k: v for k, v in graphs[args.backend].launches.items() if v} }")
    ratios, q_times, fp_times = [], [], []
    for r in range(args.rounds):
        # ms a step: ``iters`` replays back to back, two untimed first
        fp, qm = (timeit(graphs[k].replay, iters=args.iters, warmup=1)
                  / args.inner for k in ("bf16", args.backend))
        ratios.append(fp / qm)
        q_times.append(qm)
        fp_times.append(fp)
        log(f"round {r}: bf16={fp:.3f}ms {args.backend}={qm:.3f}ms "
            f"ratio={fp / qm:.3f}")
    ratio = statistics.median(ratios)
    q_ms = statistics.median(q_times)
    fp_ms = q_ms * ratio
    log(f"bf16 UNet: {statistics.median(fp_times):.3f} ms/step (median); "
        f"{args.backend}: {q_ms:.3f} ms/step (median speedup {ratio:.3f}x)")

    if args.mp_w or args.mp_a:
        tag = " ".join(
            ("W" if kind == "w" else "A")
            + os.path.basename(path).rsplit(".", 1)[0]
            for kind, path in (("w", args.mp_w), ("a", args.mp_a)) if path)
    else:
        tag = f"W{args.w_bits}A8"
    print(json.dumps({
        "metric": f"{args.family} UNet {tag}({args.backend}) ms/step "
                  f"(B={args.batch})",
        "value": round(q_ms, 3),
        "unit": "ms",
        "vs_baseline": round(ratio, 3),
        "bf16_ms": round(fp_ms, 3),
        "host_fingerprint_ms": host_fingerprint(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
