"""Post-training quantization: fit the multi-bit weight and act qparams
from calibration data and save the quant checkpoint (port of
``scripts/ptq.py``).

    python -m mixdq_tpu_torch.scripts.ptq --config configs/sdxl_turbo.yaml \\
        --outdir logs/x [--device cuda]

Reads ``calib_data.path`` (``gen_calib_data``), calibrates the UNet with
the up blocks' channel splits (twin qparams for each concat-shortcut
conv) over every (timestep, chunk) batch in the JAX script's order, and
writes ``OUTDIR/qparams.msgpack`` (flax's msgpack format: either package
reads it; with ``quant.softmax.enabled`` it also holds the attention's
``act_quantizer_q`` / ``_k`` / ``_v`` / ``_softmax`` params) beside
``config.yaml``, ``run.log`` and ``GIT_REVISION``.

``--recon layer|block|model`` then reconstructs the weight scales over
the same batches (``quant/recon.py``, ``--recon_iters`` Adam steps); with
``--adaround`` it also learns each weight element's rounding and writes
the offsets to ``OUTDIR/alphas.msgpack`` (``{layer: alpha}``, flax's
msgpack: ``flax.serialization.msgpack_restore`` reads it), for
``QuantCtx(alphas=...)`` or ``build_deploy_params(alphas=...)``. Runs on
the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..pipelines.loader import build_pipeline, specs_from_config
from ..quant.calibrate import calibrate
from ..quant.checkpoint import save_qparams
from ..quant.recon import reconstruct
from ..quant.state import quantizable_layers
from ..utils.config import load_config
from ..utils.logging_utils import setup_experiment
from ..utils.msgpack import pack


def calib_batches_from_npz(data, batch_size, rng=None, device=None):
    """Yield (sample, t, ehs, added) tuples on ``device``: every
    (timestep, chunk) pair, timestep-major, the samples shuffled once by
    ``rng`` (``np.random.RandomState(0)`` in ``main``: the JAX script's
    order, so the running-stat EMA sees the same batches in turn)."""
    S, N = data["xs"].shape[:2]
    has_added = "text_embeds" in data
    order = np.arange(N)
    if rng is not None:
        rng.shuffle(order)

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    for s in range(S):
        for i in range(0, N, batch_size):
            idx = order[i:i + batch_size]
            added = None
            if has_added:
                added = {"text_embeds": t(data["text_embeds"][idx]),
                         "time_ids": t(data["time_ids"][idx])}
            yield (t(data["xs"][s, idx]), t(data["ts"][s]),
                   t(data["text_embs"][idx]), added)


def save_alphas(alphas, path: str) -> None:
    """``{layer: alpha}`` as ``flax.serialization.msgpack_serialize``
    writes it (keys sorted, f32 arrays)."""
    with open(path, "wb") as f:
        pack({k: alphas[k].detach().float().cpu() for k in sorted(alphas)},
             f.write)


def main(argv=None):
    """Returns ``{'qparams', 'alphas', 'losses', 'path', 'seconds'}``
    (``alphas``: ``{layer: alpha}`` with ``--adaround``, else None;
    ``losses``: each reconstruction step's loss with ``--recon``, else
    None; seconds of the pipeline build, the calibration, the
    reconstruction and the save)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--recon", choices=["layer", "block", "model"],
                    default=None,
                    help="reconstruct the weight scales after calibration")
    ap.add_argument("--recon_iters", type=int, default=200)
    ap.add_argument("--adaround", action="store_true",
                    help="learn per-element AdaRound rounding offsets "
                         "during --recon; saved to alphas.msgpack and "
                         "foldable into deployed int codes")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    setup_experiment(args.outdir, args.config)
    seconds = {}
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, device=args.device)
    wq, aq, softmax_aq = specs_from_config(cfg)
    seconds["build"] = time.perf_counter() - t0

    data = dict(np.load(cfg.calib_data.path))
    names = quantizable_layers(pipe.unet)
    splits = {k: v for k, v in pipe.splits.items() if k in names}
    batches = list(calib_batches_from_npz(
        data, cfg.calib_data.batch_size, np.random.RandomState(0),
        pipe.device))
    print(f"calibrating over {len(batches)} batches, {len(names)} layers, "
          f"{len(splits)} channel-split")
    t0 = time.perf_counter()
    qparams = calibrate(pipe.unet, batches, wq, aq, softmax_aq=softmax_aq,
                        splits=splits)
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
    seconds["calibrate"] = time.perf_counter() - t0

    alphas, losses = None, None
    if args.recon:
        t0 = time.perf_counter()
        losses = []
        out = reconstruct(pipe.unet, qparams, batches, wq, aq,
                          mode=args.recon, iters=args.recon_iters,
                          outdir=args.outdir, adaround=args.adaround,
                          return_alphas=args.adaround, losses=losses)
        losses = [float(v) for v in losses]
        if args.adaround:
            qparams, alphas = out
            save_alphas(alphas, os.path.join(args.outdir, "alphas.msgpack"))
        else:
            qparams = out
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)
        seconds["recon"] = time.perf_counter() - t0
        print(f"reconstructed ({args.recon}, {args.recon_iters} iters"
              f"{', AdaRound' if args.adaround else ''}) in "
              f"{seconds['recon']:.1f}s")

    ckpt = os.path.join(args.outdir, "qparams.msgpack")
    t0 = time.perf_counter()
    save_qparams(qparams, ckpt)
    seconds["save"] = time.perf_counter() - t0
    print(f"saved quant checkpoint to {ckpt} (calibration "
          f"{seconds['calibrate']:.1f}s, save {seconds['save']:.2f}s)")
    return {"qparams": qparams, "alphas": alphas, "losses": losses,
            "path": ckpt, "seconds": seconds}


if __name__ == "__main__":
    main()
