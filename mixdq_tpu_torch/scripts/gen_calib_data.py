"""Calibration data: the FP pipeline over the calibration prompts,
recording each step's UNet input and output and the conditioning (port of
``scripts/gen_calib_data.py``).

    python -m mixdq_tpu_torch.scripts.gen_calib_data \\
        --config configs/sdxl_turbo.yaml [--seed 42] [--device cuda]

Writes ``calib_data.path`` (npz) with the JAX script's keys and shapes:
``xs [S, N, h, w, 4]`` (the scaled UNet inputs), ``ts [S]``, ``outputs
[S, N, h, w, 4]``, ``text_embs [N, 77, D]`` and, for SDXL, ``text_embeds
[N, P]`` and ``time_ids [N, 6]``, all f32. Batch ``k`` of
``calib_data.batch_size`` prompts draws its noise from a
``torch.Generator`` seeded ``seed + k`` (``Text2ImgPipeline``'s
``capture_trajectory=True, decode=False``), so the data equals the JAX
script's in layout, not in values. Runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..pipelines.loader import build_pipeline
from ..utils.config import load_config
from ..utils.logging_utils import setup_experiment
from ..utils.prompts import load_prompts


def _np(t) -> np.ndarray:
    return t.float().cpu().numpy()


def main(argv=None):
    """Returns ``{'path', 'data', 'seconds'}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    cd = cfg.calib_data
    out_path = cd.path
    setup_experiment(os.path.dirname(out_path) or ".", args.config)

    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, device=args.device)
    prompts = load_prompts(cd.get("prompts_file"), cd.n_samples)
    bs = cd.batch_size
    inf = cfg.inference
    xs, outputs, text_embs, text_embeds, time_ids = [], [], [], [], []
    ts = None
    for k, i in enumerate(range(0, len(prompts), bs)):
        out = pipe(prompts[i:i + bs], seed=args.seed + k,
                   num_inference_steps=cd.n_steps, capture_trajectory=True,
                   decode=False, height=inf.get("height"),
                   width=inf.get("width"))
        xs.append(_np(out.trajectory))
        outputs.append(_np(out.unet_outputs))
        text_embs.append(_np(out.text_emb))
        ts = _np(out.timesteps)
        if out.added_conds is not None:
            text_embeds.append(_np(out.added_conds["text_embeds"]))
            time_ids.append(_np(out.added_conds["time_ids"]))
        print(f"collected {min(i + bs, len(prompts))}/{len(prompts)}")

    data = {
        "xs": np.concatenate(xs, axis=1),  # [S, N, h, w, 4]
        "ts": ts,
        "outputs": np.concatenate(outputs, axis=1),
        "text_embs": np.concatenate(text_embs, axis=0),
    }
    if text_embeds:
        data["text_embeds"] = np.concatenate(text_embeds, axis=0)
        data["time_ids"] = np.concatenate(time_ids, axis=0)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez(out_path, **data)
    seconds = time.perf_counter() - t0
    print(f"saved calib data to {out_path}: "
          + ", ".join(f"{k}{v.shape}" for k, v in data.items())
          + f" in {seconds:.1f}s")
    return {"path": out_path, "data": data, "seconds": seconds}


if __name__ == "__main__":
    main()
