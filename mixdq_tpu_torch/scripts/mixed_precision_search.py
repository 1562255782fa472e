"""Metric-decoupled mixed-precision search, phases 2-4 (port of
``scripts/mixed_precision_search.py``):

* phase 2, per-layer sensitivity sweeps in fake-quant mode: the SQNR of
  the UNet's output on the calibration data's first batch (at most 8
  samples) for the quality layers at bits (4, 8), the SSIM of generated
  images for the content layers (ff / attn2) at the candidate bits;
* phase 3, the ILP over the k grid: candidate bit maps;
* phase 4, the election by pixel MSE against the FP images of the same
  noise.

    python -m mixdq_tpu_torch.scripts.mixed_precision_search \\
        --base_path logs/x --target_bits 5.0 [--which weight|act] \\
        [--n_prompts 2] [--seed 42] [--quick] [--batched CHUNK] \\
        [--protect_frac F] [--artifacts_dir DIR] [--dp_mesh N] \\
        [--device cuda]

Reads ``BASE/config.yaml``, ``BASE/qparams.msgpack`` (``ptq``) and the
config's calibration data; writes ``BASE/{which}_mp_config.yaml`` (the
elected map, the format of ``configs/mp/*/final_config``, which
``quant.bitmaps.load_bit_map`` reads), ``BASE/sensitivity_{which}.yaml``
(``meta`` / ``content`` / ``quality``), with ``--which act
--protect_frac F`` ``BASE/act_protect.yaml`` (the most sensitive acts
kept FP), and with ``--artifacts_dir`` their mirror under
``DIR/final_config/{which}/<achieved bits>.yaml`` and
``DIR/sensitivity_log/``. Each file reads under ``yaml.safe_load`` as the
JAX script's does. The weight budget weighs each layer by its weight's
element count (from the layer shapes, ``pipeline._layer_shapes``), the
act budget by its input's in one captured forward. ``--quick``: 8 layers
of each group. The sweeps' and the election's generations share the seed
``--seed`` (the same noise). ``--dp_mesh N`` shares the batched sweeps'
points out over a data-parallel mesh of N ranks (``make_mesh(N,
tp=1)``: gloo on the CPU, NCCL on the card, one card a rank), started
here, one process a rank (``parallel.launch``), unless a world of N runs
already (with ``--batched 0`` it is an error); each point's value
equals the single-rank sweep's. Rank 0 runs
the ILP and the election, writes the files and returns the result. Runs
on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..mixed_precision import election, ilp, sensitivity
from ..parallel.launch import spawn_main
from ..parallel.mesh import make_mesh
from ..pipeline import _layer_shapes
from ..pipelines.loader import build_pipeline, specs_from_config
from ..quant.checkpoint import load_qparams
from ..quant.state import capture_acts, quantizable_layers
from ..utils.config import dumps, load_config
from ..utils.logging_utils import setup_experiment
from ..utils.prompts import load_prompts

#: the quality group's bits (the reference's SQNR sweep)
BITS_QUALITY = (4, 8)


def calib_batch(data, n: int, device):
    """(sample, t, ehs, added) of the calibration data's first step and
    first ``n`` samples, and their FP outputs."""
    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    added = ({"text_embeds": t(data["text_embeds"][:n]),
              "time_ids": t(data["time_ids"][:n])}
             if "text_embeds" in data else None)
    return ((t(data["xs"][0, :n]), t(data["ts"][0]),
             t(data["text_embs"][:n]), added), t(data["outputs"][0, :n]))


def layer_sizes(pipe, which: str, data, names) -> dict:
    """Each layer's budget weight: its weight's elements (``weight``) or
    its input's in one captured FP forward of one sample (``act``; 1 for
    a layer the forward does not reach)."""
    if which == "weight":
        return {n: int(np.prod(s)) for n, s in _layer_shapes(
            pipe.unet.config) if n in names}
    batch, _ = calib_batch(data, 1, pipe.device)
    cap = capture_acts(pipe.unet, batch, names=names)
    return {n: int(np.prod(cap[n].shape)) if n in cap else 1 for n in names}


def write_list(names, path: str) -> None:
    """A layer list, one ``- name`` a line (``yaml.safe_dump``'s form of
    a list of names)."""
    with open(path, "w") as f:
        f.write("".join(f"- {n}\n" for n in names) if names else "[]\n")


def main(argv=None):
    """Returns ``{'sens_content', 'sens_quality', 'sizes', 'candidates',
    'winner', 'index', 'mses', 'achieved', 'protected', 'paths',
    'seconds', 'points'}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--base_path", required=True)
    ap.add_argument("--which", choices=["weight", "act"], default="weight")
    ap.add_argument("--target_bits", type=float, default=5.0)
    ap.add_argument("--n_prompts", type=int, default=2)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--quick", action="store_true",
                    help="limit the sweeps to 8 layers a group")
    ap.add_argument("--batched", type=int, default=8, metavar="CHUNK",
                    help="the batched sweeps (0: the sequential ones)")
    ap.add_argument("--protect_frac", type=float, default=0.0,
                    help="--which act: the fraction of most sensitive "
                         "layers of each group kept FP (act_protect.yaml)")
    ap.add_argument("--artifacts_dir", default=None,
                    help="also mirror the outputs under DIR/final_config/"
                         "{which}/<achieved>.yaml and DIR/sensitivity_log/")
    ap.add_argument("--dp_mesh", type=int, default=0, metavar="N",
                    help="share the batched sweeps' points out over N "
                         "ranks (0: one)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.dp_mesh > 1 and not args.batched:
        # the sequential sweeps take no mesh: every rank would run them all
        ap.error("--dp_mesh shares the batched sweeps' points; it needs "
                 "--batched CHUNK > 0")
    if args.dp_mesh > 1 and not dist.is_initialized():
        return spawn_main(__name__, sys.argv[1:] if argv is None else argv,
                          args.dp_mesh, args.device)
    mesh = make_mesh(args.dp_mesh, tp=1) if args.dp_mesh > 1 else None
    lead = mesh is None or dist.get_rank() == 0

    seconds = {}
    t0 = time.perf_counter()
    cfg = load_config(os.path.join(args.base_path, "config.yaml"))
    if lead:
        setup_experiment(args.base_path)
    pipe = build_pipeline(cfg, device=args.device)
    wq, aq, _ = specs_from_config(cfg)
    qparams = load_qparams(os.path.join(args.base_path, "qparams.msgpack"),
                           device=pipe.device)
    names = sorted(quantizable_layers(pipe.unet))
    content, quality = sensitivity.split_metric_groups(names)
    if args.quick:
        content, quality = content[:8], quality[:8]
    data = dict(np.load(cfg.calib_data.path))
    sizes = layer_sizes(pipe, args.which, data, names)
    size_frac = ilp.tensor_size_fractions(sizes)
    seconds["setup"] = time.perf_counter() - t0

    # phase 2a: SQNR of the UNet's output, quality layers
    t0 = time.perf_counter()
    batch, fp_out = calib_batch(data, min(8, data["xs"].shape[1]),
                                pipe.device)
    sweep_q = (sensitivity.sweep_sqnr_batched if args.batched
               else sensitivity.sweep_sqnr)
    kw = {"chunk": args.batched, "mesh": mesh} if args.batched else {}
    sens_q = sweep_q(pipe.unet, qparams, quality, names, batch, fp_out, wq,
                     aq, which=args.which, bits=BITS_QUALITY, **kw)
    seconds["sqnr_sweep"] = time.perf_counter() - t0

    # phase 2b: SSIM of generated images, content layers
    t0 = time.perf_counter()
    prompts = load_prompts(None, args.n_prompts)
    bits_c = tuple(wq.candidate_bits)
    steps = cfg.inference.get("num_steps")
    sweep_c = (sensitivity.sweep_ssim_batched if args.batched
               else sensitivity.sweep_ssim)
    kw = ({"chunk": min(args.batched, 4), "mesh": mesh} if args.batched
          else {})
    sens_c = sweep_c(pipe, qparams, content, names, prompts, args.seed, wq,
                     aq, which=args.which, bits=bits_c, num_steps=steps,
                     **kw)
    seconds["ssim_sweep"] = time.perf_counter() - t0
    if not lead:
        return None

    # the act-protect list: the worst score at the largest bits, per group
    protected = []
    paths = {}
    if args.protect_frac > 0 and args.which == "act":
        k_c = math.ceil(args.protect_frac * len(sens_c))
        k_q = math.ceil(args.protect_frac * len(sens_q))
        protected = sorted(sorted(sens_c, key=lambda n: sens_c[n][-1])[:k_c]
                           + sorted(sens_q, key=lambda n: sens_q[n][-1])[:k_q])
        sens_c = {n: v for n, v in sens_c.items() if n not in protected}
        sens_q = {n: v for n, v in sens_q.items() if n not in protected}
        paths["act_protect"] = os.path.join(args.base_path,
                                            "act_protect.yaml")
        write_list(protected, paths["act_protect"])
        print(f"protecting {len(protected)} act layers (FP): "
              f"{paths['act_protect']}")

    # phase 3: ILP candidates over the k grid
    t0 = time.perf_counter()
    candidates = ilp.metric_decoupled_allocation(
        sens_c, sens_q, size_frac, args.target_bits, bits_content=bits_c,
        bits_quality=BITS_QUALITY)
    seconds["ilp"] = time.perf_counter() - t0
    print(f"{len(candidates)} ILP candidates")
    result = {"sens_content": sens_c, "sens_quality": sens_q,
              "sizes": sizes, "candidates": candidates, "winner": None,
              "index": None, "mses": [], "achieved": None,
              "protected": protected, "paths": paths, "seconds": seconds,
              "points": len(quality) * len(BITS_QUALITY)
              + len(content) * len(bits_c)}
    if not candidates:
        print("no feasible allocation; relax target_bits")
        return result

    # phase 4: election by pixel MSE
    t0 = time.perf_counter()
    winner, idx, mses = election.elect(
        pipe, qparams, names, candidates, args.which, prompts, args.seed, wq,
        aq, num_steps=steps)
    seconds["elect"] = time.perf_counter() - t0
    achieved = ilp.achieved_avg_bits(winner, size_frac)
    print(f"elected candidate {idx} (mse={mses[idx]:.6f}); achieved avg "
          f"bits {achieved:.3f} (target {args.target_bits})")

    paths["config"] = os.path.join(args.base_path,
                                   f"{args.which}_mp_config.yaml")
    with open(paths["config"], "w") as f:
        f.write(f"# target_avg_bits: {args.target_bits}  "
                f"achieved_avg_bits: {achieved:.3f}\n")
        f.write(dumps({k: int(winner[k]) for k in sorted(winner)}))
    paths["sensitivity"] = os.path.join(args.base_path,
                                        f"sensitivity_{args.which}.yaml")
    with open(paths["sensitivity"], "w") as f:
        f.write(dumps({
            "content": {k: [float(x) for x in sens_c[k]]
                        for k in sorted(sens_c)},
            "meta": {"achieved_avg_bits": achieved,
                     "elected_mse": float(mses[idx]),
                     "target_avg_bits": float(args.target_bits)},
            "quality": {k: [float(x) for x in sens_q[k]]
                        for k in sorted(sens_q)}}))
    print(f"wrote {paths['config']} and {paths['sensitivity']}")

    if args.artifacts_dir:
        fc = os.path.join(args.artifacts_dir, "final_config", args.which)
        sl = os.path.join(args.artifacts_dir, "sensitivity_log")
        os.makedirs(fc, exist_ok=True)
        os.makedirs(sl, exist_ok=True)
        shutil.copy(paths["config"], os.path.join(fc, f"{achieved:.2f}.yaml"))
        shutil.copy(paths["sensitivity"],
                    os.path.join(sl, f"sensitivity_{args.which}.yaml"))
        if protected:
            shutil.copy(paths["act_protect"],
                        os.path.join(args.artifacts_dir, "act_protect.yaml"))
        print(f"mirrored artifacts under {args.artifacts_dir}")
    result.update(winner=winner, index=idx, mses=mses, achieved=achieved)
    return result


if __name__ == "__main__":
    main()
