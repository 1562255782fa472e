"""FP baseline text-to-image generation (port of ``scripts/txt2img.py``).

    python -m mixdq_tpu_torch.scripts.txt2img \\
        --config configs/sdxl_turbo.yaml --outdir logs/fp [--prompt "..."] \\
        [--n_images 4] [--batch_size 2] [--seed 42] [--device cuda]

The config's pipeline (``model.params_path`` or random weights from a
seed) generates ``--n_images`` images, ``--prompt`` repeated or the
built-in prompts, ``--batch_size`` at a time; batch ``k`` draws its noise
from a generator seeded ``seed + k`` (as ``quant_txt2img``). The PNGs go
to ``--outdir`` as ``fp_{i:04d}_{j:04d}.png`` with the config's copy.
Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

from ..pipelines.loader import build_pipeline
from ..utils.config import load_config
from ..utils.images import save_images
from ..utils.logging_utils import setup_experiment
from ..utils.prompts import load_prompts


def main(argv=None):
    """Returns ``{'pipe', 'paths', 'images'}`` (images ``[N, H, W, 3]``
    float in [0, 1], one array a batch)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--prompt", default=None)
    ap.add_argument("--n_images", type=int, default=4)
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    setup_experiment(args.outdir, args.config)
    pipe = build_pipeline(cfg, device=args.device)
    prompts = ([args.prompt] * args.n_images if args.prompt
               else load_prompts(None, args.n_images))
    inf = cfg.inference
    paths, images = [], []
    for k, i in enumerate(range(0, len(prompts), args.batch_size)):
        out = pipe(prompts[i:i + args.batch_size], seed=args.seed + k,
                   num_inference_steps=inf.get("num_steps"),
                   guidance_scale=inf.get("guidance_scale"),
                   height=inf.get("height"), width=inf.get("width"))
        paths += save_images(out.images, args.outdir, prefix=f"fp_{i:04d}")
        images.append(out.images)
    print(f"wrote images to {args.outdir}")
    return {"pipe": pipe, "paths": paths, "images": images}


if __name__ == "__main__":
    main()
