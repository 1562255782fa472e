"""Quantization-error analysis CLI (port of ``scripts/quant_error.py``).

    python -m mixdq_tpu_torch.scripts.quant_error --base_path logs/x \\
        --target unet_output|weight|act|arch [--which weight|act] \\
        [--layers l1 l2 | --limit 16] [--out out.yaml] [--device cuda]

Targets: ``unet_output`` (the UNet's output with one target quantized
alone, on the calibration data's first batch of at most 8), ``weight``
(each layer's weight fake-quantized), ``act`` (each layer's captured
calibration input fake-quantized), each at bits 2 / 4 / 8, written as
``{layer: {sqnr: [...], mse: [...]}}`` to ``--out`` (default
``BASE/quant_error_{target}.yaml``); ``arch``: the quantizable layers'
names and weight shapes (``analysis.model_arch.dump_structure``, from a
UNet on the meta device: no weights) to ``--out`` (default
``BASE/model_structure.txt``). Reads ``BASE/config.yaml`` and, but for
``arch``, ``BASE/qparams.msgpack``. Runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..analysis import model_arch, quant_error
from ..models.configs import get_family
from ..models.unet import UNet2DConditionModel
from ..pipelines.loader import build_pipeline, specs_from_config
from ..quant.checkpoint import load_qparams
from ..quant.state import quantizable_layers
from ..utils.config import dumps, load_config
from .mixed_precision_search import calib_batch


def main(argv=None):
    """Returns ``{'path', 'result'}`` (the dump's text for ``arch``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--base_path", required=True)
    ap.add_argument("--target", required=True,
                    choices=["unet_output", "weight", "act", "arch"])
    ap.add_argument("--which", default="weight", choices=["weight", "act"])
    ap.add_argument("--layers", nargs="*", default=None)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = load_config(os.path.join(args.base_path, "config.yaml"))
    if args.target == "arch":
        unet = UNet2DConditionModel(get_family(cfg.model.family).unet,
                                    device="meta")
        text = model_arch.dump_structure(unet)
        out = args.out or os.path.join(args.base_path, "model_structure.txt")
        with open(out, "w") as f:
            f.write(text)
        print(f"wrote {out} ({len(text.splitlines())} layers)")
        return {"path": out, "result": text}

    pipe = build_pipeline(cfg, device=args.device)
    wq, aq, _ = specs_from_config(cfg)
    qparams = load_qparams(os.path.join(args.base_path, "qparams.msgpack"),
                           device=pipe.device)
    names = sorted(quantizable_layers(pipe.unet))
    targets = args.layers or names
    if args.limit:
        targets = targets[:args.limit]
    if args.target == "weight":
        res = quant_error.weight_error(pipe.unet, qparams, targets, wq)
    else:
        data = dict(np.load(cfg.calib_data.path))
        batch, fp_out = calib_batch(data, min(8, data["xs"].shape[1]),
                                    pipe.device)
        if args.target == "act":
            res = quant_error.act_error(pipe.unet, qparams, targets, batch,
                                        aq)
        else:
            res = quant_error.unet_output_error(
                pipe.unet, qparams, targets, names, batch, fp_out, wq, aq,
                which=args.which)
    out = args.out or os.path.join(args.base_path,
                                   f"quant_error_{args.target}.yaml")
    with open(out, "w") as f:
        f.write(dumps({k: res[k] for k in sorted(res)}) if res else "{}\n")
    print(f"wrote {out} ({len(res)} entries)")
    return {"path": out, "result": res}


if __name__ == "__main__":
    main()
