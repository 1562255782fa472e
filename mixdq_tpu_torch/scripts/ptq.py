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
``act_quantizer_q`` / ``_k`` / ``_v`` / ``_softmax`` params) beside ``config.yaml``, ``run.log`` and ``GIT_REVISION``. The
AdaRound-style reconstruction (``--recon`` / ``--adaround``) is not
ported yet (ROADMAP Queue A 6) and raises. Runs on the card unless
``--device cpu``.
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
from ..quant.state import quantizable_layers
from ..utils.config import load_config
from ..utils.logging_utils import setup_experiment


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


def main(argv=None):
    """Returns ``{'qparams', 'path', 'seconds'}`` (seconds of the
    pipeline build, the calibration and the save)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--recon", choices=["layer", "block", "model"],
                    default=None, help="not ported yet (ROADMAP Queue A 6)")
    ap.add_argument("--adaround", action="store_true",
                    help="not ported yet (ROADMAP Queue A 6)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.recon or args.adaround:
        raise NotImplementedError(
            "--recon / --adaround: the reconstruction (quant/recon.py) is "
            "not ported yet (ROADMAP Queue A 6)")

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

    ckpt = os.path.join(args.outdir, "qparams.msgpack")
    t0 = time.perf_counter()
    save_qparams(qparams, ckpt)
    seconds["save"] = time.perf_counter() - t0
    print(f"saved quant checkpoint to {ckpt} (calibration "
          f"{seconds['calibrate']:.1f}s, save {seconds['save']:.2f}s)")
    return {"qparams": qparams, "path": ckpt, "seconds": seconds}


if __name__ == "__main__":
    main()
