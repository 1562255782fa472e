"""Checkpoint conversion: reference and HF artifacts into the formats the
port and the JAX package read (port of ``scripts/convert_checkpoints.py``).

    python -m mixdq_tpu_torch.scripts.convert_checkpoints --mode qparams \\
        --input ckpt.pth --output logs/x/qparams.msgpack
    python -m mixdq_tpu_torch.scripts.convert_checkpoints --mode unet \\
        --input unet/diffusion_pytorch_model.safetensors --output unet.msgpack

Modes:

* ``qparams``: the reference's PTQ ``ckpt.pth`` -> ``qparams.msgpack``
  (``quant.checkpoint.save_qparams``);
* ``unet`` / ``clip`` / ``vae``: an HF state dict (``.bin`` / ``.pt``
  through ``torch.load``, ``.safetensors`` through the port's reader) ->
  a flax msgpack params fragment of that module, in the JAX package's
  tree and key order (the bytes its CLI writes), for
  ``quant.checkpoint.load_module_params``. A ``torch.load`` input is
  converted in float32, a ``.safetensors`` one in its stored dtype, as the
  JAX CLI does.

Runs on the host alone: no device is used.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

import torch

from ..quant.checkpoint import save_params_tree, save_qparams
from ..utils import torch_convert

PARAMS = {"unet": torch_convert.unet_params,
          "clip": torch_convert.clip_params,
          "vae": torch_convert.vae_params}


def load_torch_file(path: str):
    """A ``.safetensors`` file's tensors, or what ``torch.load`` gives."""
    if path.endswith(".safetensors"):
        return torch_convert.load_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=False)


def to_float_state_dict(obj) -> Dict[str, Any]:
    """A module's (or a dict's) tensors as float32; other values as
    they are."""
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: (v.float() if isinstance(v, torch.Tensor) else v)
            for k, v in obj.items()}


def _count(tree) -> int:
    return sum(_count(v) if isinstance(v, dict) else 1
               for v in tree.values())


def main(argv=None):
    """Returns ``{'mode', 'output', 'n'}`` and the result: ``qparams``
    (``{layer: LayerQParams}``) or ``params`` (the params tree)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", required=True,
                    choices=["qparams", "unet", "clip", "vae"])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    args = ap.parse_args(argv)

    obj = load_torch_file(args.input)
    out = {"mode": args.mode, "output": args.output}
    if args.mode == "qparams":
        ckpt = {name: [to_float_state_dict(dict(
            entry[0] if isinstance(entry, (list, tuple)) else entry)), {}]
            for name, entry in obj.items()}
        qparams = torch_convert.convert_reference_qparams(ckpt)
        save_qparams(qparams, args.output)
        print(f"converted {len(qparams)} layers -> {args.output}")
        return {**out, "qparams": qparams, "n": len(qparams)}

    if not args.input.endswith(".safetensors"):
        obj = to_float_state_dict(obj)
    params = PARAMS[args.mode](obj)
    save_params_tree(params, args.output)
    n = _count(params)
    print(f"converted {n} tensors -> {args.output}")
    return {**out, "params": params, "n": n}


if __name__ == "__main__":
    main()
